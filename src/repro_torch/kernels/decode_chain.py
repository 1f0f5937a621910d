"""The decode chain: a whole transformer layer of one decode step in two
or three CUDA launches (dense) or four (MoE) (``csrc/decode_chain.cu``).

    rmsnorm(x; g1) -> x@wq, x@wk, x@wv           fused_qkv_norm
    attention core                                approx_attention
    x1 = x + attn@wo (+bo); h = rmsnorm(x1; g2)
    out = x1 + (silu(h@wg) * (h@wu))@wd (+bd)     fused_out_mlp
    the attention core, then fused_out_mlp        fused_attn_out_mlp

    MoE: x1 = x + attn@wo (+bo); h = rmsnorm(x1; g2)    fused_wo_norm
         routing on h (models/moe.py), then per expert e of the stacked
         banks (silu(h_e@wg_e) * (h_e@wu_e))@wd_e       fused_moe_ffn

They replace the TPU kernels ``repro/kernels/decode_chain.py``
``_qkv_kernel``, ``_out_mlp_kernel``, ``_attn_out_mlp_kernel``,
``_wo_norm_kernel`` and ``_moe_ffn_kernel``.  x is the (rows, d) residual
stream of a decode step (rows = batch), so every weight is streamed from
device memory once per launch and each element meets ``rows`` LUT lookups:
the weight stream bounds a decode step.  The expert banks meet the C rows
of each expert's capacity buffer instead.

Every kernel folds with the card's ``fold_cols``: work items of a row
group and a narrow column tile, so that every SM is busy, with the
weights staged ahead by ``cp.async``.  ``fused_qkv_norm`` walks q, k and
v as one item space (``qkv_grid``); ``fused_wo_norm`` runs the back
half's wo phase, then the norm (``wo_norm_grid``).  ``fused_moe_ffn``
computes only the live capacity rows (``live_rows``), those with an
element whose exponent field is not 0: AMSim returns a bare signed zero
when an operand's exponent field is 0, whatever the other operand is, so
every product of a dead row is +-0, each of its sums from +0.0 is +0.0,
and the kernel writes +0.0 over it without a lookup or a weight read
(``moe_ffn_grid``).  The plain version skips the same rows; computing
them would give the same bits.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version (``*_plain``), which the kernel agrees
with bit for bit: every product goes through AMSim and every output folds
its products in contraction order from +0.0 (``ref_amsim_gemm``'s
order), the rmsnorm sum of squares runs in the warp order of
``common.lane_sum``, and the elementwise steps are the same float32
operations in the same order:

    rmsnorm(x; g) = (x * rsqrt(lane_sum(x * x) / d + eps)) * g
    silu(g) * u   = (g / (1 + exp(-g))) * u

So a chained launch is bit for bit the composition of its plain parts.

``<wrapper>.launches`` counts each kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from .approx_attention import (DECODE_TILE, AttnPlan, AttnShape, _tile_plan,
                               approx_attention_plain, attention_layout, attention_scratch,
                               check_attention_operands)
from .approx_gemm import TABLES, _sms
from .common import (call_kernel, check_contiguous, check_float32, check_lut, device_float,
                     lane_sum, live_elements, lut_bytes, lut_in_smem, operand_device)
from .ref import ref_amsim_gemm


def rmsnorm_lanes(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """rmsnorm over the last dim in the chain kernels' arithmetic."""
    var = lane_sum(x * x) / device_float(float(x.shape[-1]), x.device)
    return (x * torch.rsqrt(var + eps)[..., None]) * g


def silu(g: torch.Tensor) -> torch.Tensor:
    """silu(g) = g / (1 + exp(-g)): the port's one expression of it."""
    return g / (1 + torch.exp(-g))


# ------------------------------------------------------------ plain versions
def fused_qkv_norm_plain(x, g1, wq, wk, wv, lut, M: int, *, eps: float):
    h = rmsnorm_lanes(x, g1, eps)
    return tuple(ref_amsim_gemm(h, w, lut, M) for w in (wq, wk, wv))


def fused_wo_norm_plain(x, attn, g2, wo, lut, M: int, *, eps: float, bo=None):
    y = ref_amsim_gemm(attn, wo, lut, M)
    if bo is not None:
        y = y + bo
    x1 = x + y
    return x1, rmsnorm_lanes(x1, g2, eps)


def _swiglu_plain(h, wg, wu, wd, lut, M: int):
    a = silu(ref_amsim_gemm(h, wg, lut, M)) * ref_amsim_gemm(h, wu, lut, M)
    return ref_amsim_gemm(a, wd, lut, M)


# The plain expert banks take this many live experts at a time: their
# slices of the banks are gathered (8 x 3 x 168 MB at llama4's widths).
PLAIN_EXPERTS = 8


def fused_moe_ffn_plain(h, wg, wu, wd, lut, M: int):
    """The swiglu FFN of every expert's capacity buffer h (E, C, d) with
    the stacked banks.  As the kernel, only the experts with a live row
    (``live_rows``) are computed, PLAIN_EXPERTS at a time (by their counts
    of live rows) on their first rows up to the most live rows of any of
    them (each expert's live rows first, in order); every other row is
    +0.0: the bits of computing them all."""
    h, wg, wu, wd = (t.detach() for t in (h, wg, wu, wd))
    live = live_elements(h).any(dim=-1)
    out = torch.zeros((*h.shape[:-1], wd.shape[-1]), dtype=torch.float32, device=h.device)
    counts = live.sum(dim=-1)
    experts = torch.nonzero(counts)[:, 0]
    experts = experts[torch.argsort(counts[experts], stable=True)]   # groups of like rows
    for first in range(0, len(experts), PLAIN_EXPERTS):
        group = experts[first:first + PLAIN_EXPERTS]
        rows = torch.argsort((~live[group]).to(torch.int8), dim=1, stable=True)
        rows = rows[:, :int(live[group].sum(dim=1).max())]
        hg = torch.gather(h[group], 1, rows[..., None].expand(-1, -1, h.shape[-1]))
        out[group[:, None], rows] = _swiglu_plain(hg, wg[group], wu[group], wd[group], lut, M)
    return out


def fused_out_mlp_plain(x, attn, g2, wo, wg, wu, wd, lut, M: int, *, eps: float,
                        bo=None, bd=None):
    x1, h = fused_wo_norm_plain(x, attn, g2, wo, lut, M, eps=eps, bo=bo)
    y2 = _swiglu_plain(h, wg, wu, wd, lut, M)
    if bd is not None:
        y2 = y2 + bd
    return x1 + y2


def fused_attn_out_mlp_plain(x, q, k, v, q_pos, k_pos, g2, wo, wg, wu, wd, lut, M: int, *,
                             eps: float, causal: bool, window: int, bo=None, bd=None):
    B, S, H, dh = q.shape
    attn = approx_attention_plain(q, k, v, q_pos, k_pos, lut, M, causal=causal,
                                  window=window).reshape(B * S, H * dh)
    return fused_out_mlp_plain(x, attn, g2, wo, wg, wu, wd, lut, M, eps=eps, bo=bo, bd=bd)


# ------------------------------------------------------------------ checks
def _check_rows(x, *vectors):
    if x.ndim != 2:
        raise ValueError(f"the decode chain takes x (rows, d), got {tuple(x.shape)}")
    for vec in vectors:
        if vec is not None and vec.shape != (x.shape[1],):
            raise ValueError(f"norm scales and biases must be ({x.shape[1]},), got "
                             f"{tuple(vec.shape)}")


def _check_back_half(x, attn_cols, wo, wg, wu, wd):
    d = x.shape[1]
    F = wg.shape[1]
    want = {"wo": (attn_cols, d), "wg": (d, F), "wu": (d, F), "wd": (F, d)}
    got = {"wo": wo.shape, "wg": wg.shape, "wu": wu.shape, "wd": wd.shape}
    if any(tuple(got[n]) != want[n] for n in want):
        raise ValueError(f"back-half weights must be {want}, got "
                         f"{ {n: tuple(s) for n, s in got.items()} }")


def _present(*tensors):
    return [t for t in tensors if t is not None]


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------- wrappers
def fused_qkv_norm(x, g1, wq, wk, wv, lut, M: int, *, eps: float):
    """rmsnorm(x; g1) then x@wq, x@wk, x@wv in one launch; x (rows, d),
    w* (d, n*) -> (q, k, v) float32."""
    _check_rows(x, g1)
    for w in (wq, wk, wv):
        if w.ndim != 2 or w.shape[0] != x.shape[1]:
            raise ValueError(f"projection weights must be ({x.shape[1]}, n), got "
                             f"{tuple(w.shape)}")
    check_float32(x, g1, wq, wk, wv)
    check_lut(lut, M)
    device = operand_device(x, g1, wq, wk, wv, lut)
    if device.type == "cpu":
        return fused_qkv_norm_plain(x, g1, wq, wk, wv, lut, M, eps=eps)
    check_contiguous(x, g1, wq, wk, wv, lut)
    rows, d = x.shape
    outs = tuple(torch.empty((rows, w.shape[1]), dtype=torch.float32, device=device)
                 for w in (wq, wk, wv))
    call_kernel("decode_chain", "fused_qkv_norm_f32", device,
                x.data_ptr(), g1.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
                lut.data_ptr(), *(o.data_ptr() for o in outs),
                rows, d, wq.shape[1], wk.shape[1], wv.shape[1], float(eps), M,
                int(lut.dtype == torch.int16), int(lut_in_smem(lut)), lut_bytes(lut))
    fused_qkv_norm.launches += 1
    return outs


fused_qkv_norm.launches = 0


def _launch_back_half(fn, device, x, attn_args, g2, wo, wg, wu, wd, bo, bd, lut, M, eps,
                      extra):
    rows, d = x.shape
    F = wg.shape[1]
    out = torch.empty((rows, d), dtype=torch.float32, device=device)
    x1 = torch.empty((rows, d), dtype=torch.float32, device=device)
    act = torch.empty((rows, F), dtype=torch.float32, device=device)
    call_kernel("decode_chain", fn, device,
                x.data_ptr(), *attn_args, g2.data_ptr(), wo.data_ptr(), wg.data_ptr(),
                wu.data_ptr(), wd.data_ptr(), _ptr(bo), _ptr(bd), lut.data_ptr(),
                out.data_ptr(), x1.data_ptr(), act.data_ptr(), *extra,
                rows, d, wo.shape[0], F, float(eps), M,
                int(lut.dtype == torch.int16), int(lut_in_smem(lut)), lut_bytes(lut))
    return out


def fused_out_mlp(x, attn, g2, wo, wg, wu, wd, lut, M: int, *, eps: float, bo=None,
                  bd=None):
    """x1 = x + attn@wo (+bo); h = rmsnorm(x1; g2); out = x1 +
    (silu(h@wg) * (h@wu))@wd (+bd), in one launch: x (rows, d), attn
    (rows, K), wo (K, d), wg/wu (d, F), wd (F, d) -> (rows, d)."""
    _check_rows(x, g2, bo, bd)
    if attn.ndim != 2 or attn.shape[0] != x.shape[0]:
        raise ValueError(f"attn must be ({x.shape[0]}, K), got {tuple(attn.shape)}")
    _check_back_half(x, attn.shape[1], wo, wg, wu, wd)
    tensors = _present(x, attn, g2, wo, wg, wu, wd, bo, bd)
    check_float32(*tensors)
    check_lut(lut, M)
    device = operand_device(*tensors, lut)
    if device.type == "cpu":
        return fused_out_mlp_plain(x, attn, g2, wo, wg, wu, wd, lut, M, eps=eps, bo=bo,
                                   bd=bd)
    check_contiguous(*tensors, lut)
    out = _launch_back_half("fused_out_mlp_f32", device, x, [attn.data_ptr()], g2, wo, wg,
                            wu, wd, bo, bd, lut, M, eps, [])
    fused_out_mlp.launches += 1
    return out


fused_out_mlp.launches = 0


def fused_attn_out_mlp(x, q, k, v, q_pos, k_pos, g2, wo, wg, wu, wd, lut, M: int, *,
                       eps: float, causal: bool = True, window: int = 0, bo=None, bd=None):
    """The attention core of one decode step, then ``fused_out_mlp``, in
    one launch: x (B, d) residual stream, q (B, 1, H, dh) roped queries,
    k/v (B, T, KV, dh) the cache after this step's write, q_pos (1,) and
    k_pos (T,), or per batch row q_pos (B, 1) and k_pos (B, T) (the paged
    cache: row b's attention reads row b's positions) -> (B, d)."""
    _check_rows(x, g2, bo, bd)
    check_attention_operands(q, k, v, q_pos, k_pos)
    B, S, H, dh = q.shape
    if S != 1 or B != x.shape[0]:
        raise ValueError(f"fused_attn_out_mlp takes one decode step: q (B, 1, H, dh) with "
                         f"B = rows, got q {tuple(q.shape)} and x {tuple(x.shape)}")
    _check_back_half(x, H * dh, wo, wg, wu, wd)
    tensors = _present(x, q, k, v, g2, wo, wg, wu, wd, bo, bd)
    check_float32(*tensors)
    check_lut(lut, M)
    device = operand_device(*tensors, q_pos, k_pos, lut)
    if device.type == "cpu":
        return fused_attn_out_mlp_plain(x, q, k, v, q_pos, k_pos, g2, wo, wg, wu, wd, lut, M,
                                        eps=eps, causal=causal, window=window, bo=bo, bd=bd)
    q_pos = q_pos.to(torch.int32)
    k_pos = k_pos.to(torch.int32)
    check_contiguous(*tensors, q_pos, k_pos, lut)
    T, KV = k.shape[1], k.shape[2]
    attn = torch.empty((B, H * dh), dtype=torch.float32, device=device)
    sms = _sms(device.index)
    plan = attention_phase_plan(B, H, KV, T, dh, lut)
    scratch, scratch_blocks = attention_scratch(plan, T, sms, device)
    out = _launch_back_half(
        "fused_attn_out_mlp_f32", device, x,
        [q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr()],
        g2, wo, wg, wu, wd, bo, bd, lut, M, eps,
        [attn.data_ptr(), scratch.data_ptr(), H, KV, T, dh, int(causal), int(window),
         int(q_pos.ndim == 2), plan.dim_chunk, plan.value_slab, int(plan.scores == "shared"),
         scratch_blocks])
    fused_attn_out_mlp.launches += 1
    return out


fused_attn_out_mlp.launches = 0


def fused_wo_norm(x, attn, g2, wo, lut, M: int, *, eps: float, bo=None):
    """x1 = x + attn@wo (+bo); h = rmsnorm(x1; g2), in one launch: x (rows,
    d), attn (rows, K), wo (K, d) -> (x1, h), both (rows, d)."""
    _check_rows(x, g2, bo)
    if attn.ndim != 2 or attn.shape[0] != x.shape[0]:
        raise ValueError(f"attn must be ({x.shape[0]}, K), got {tuple(attn.shape)}")
    if tuple(wo.shape) != (attn.shape[1], x.shape[1]):
        raise ValueError(f"wo must be ({attn.shape[1]}, {x.shape[1]}), got {tuple(wo.shape)}")
    tensors = _present(x, attn, g2, wo, bo)
    check_float32(*tensors)
    check_lut(lut, M)
    device = operand_device(*tensors, lut)
    if device.type == "cpu":
        return fused_wo_norm_plain(x, attn, g2, wo, lut, M, eps=eps, bo=bo)
    check_contiguous(*tensors, lut)
    rows, d = x.shape
    x1 = torch.empty((rows, d), dtype=torch.float32, device=device)
    h = torch.empty((rows, d), dtype=torch.float32, device=device)
    call_kernel("decode_chain", "fused_wo_norm_f32", device,
                x.data_ptr(), attn.data_ptr(), g2.data_ptr(), wo.data_ptr(), _ptr(bo),
                lut.data_ptr(), x1.data_ptr(), h.data_ptr(), rows, d, attn.shape[1], float(eps),
                M, int(lut.dtype == torch.int16), int(lut_in_smem(lut)), lut_bytes(lut))
    fused_wo_norm.launches += 1
    return x1, h


fused_wo_norm.launches = 0


def fused_moe_ffn(h, wg, wu, wd, lut, M: int):
    """The swiglu FFN of every expert over its capacity rows, in one
    launch: h (E, C, d), wg/wu (E, d, F), wd (E, F, d) -> (E, C, d)."""
    if h.ndim != 3:
        raise ValueError(f"fused_moe_ffn takes h (E, C, d), got {tuple(h.shape)}")
    E, C, d = h.shape
    F = wg.shape[-1]
    want = {"wg": (E, d, F), "wu": (E, d, F), "wd": (E, F, d)}
    got = {"wg": tuple(wg.shape), "wu": tuple(wu.shape), "wd": tuple(wd.shape)}
    if got != want:
        raise ValueError(f"expert banks must be {want}, got {got}")
    check_float32(h, wg, wu, wd)
    check_lut(lut, M)
    device = operand_device(h, wg, wu, wd, lut)
    if device.type == "cpu":
        return fused_moe_ffn_plain(h, wg, wu, wd, lut, M)
    check_contiguous(h, wg, wu, wd, lut)
    out = torch.empty((E, C, d), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    act = torch.empty((E, C, F), dtype=torch.float32, device=device)
    live = torch.empty((E * C + E,), dtype=torch.int32, device=device)
    call_kernel("decode_chain", "fused_moe_ffn_f32", device,
                h.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), lut.data_ptr(),
                out.data_ptr(), act.data_ptr(), live.data_ptr(), E, C, d, F, M,
                int(lut.dtype == torch.int16), int(lut_in_smem(lut)), lut_bytes(lut))
    fused_moe_ffn.launches += 1
    return out


fused_moe_ffn.launches = 0


# csrc/decode_chain.cu fold_bytes: the shared bytes of fold_item's buffers
# (a ring of FOLD_STAGES weight chunks of FOLD_CHUNK floats, two activation
# chunks of as many, two product buffers of FOLD_CHUNK + 64 floats a row of
# a row group of up to FOLD_ROWS), which the attention phase of
# fused_attn_out_mlp borrows.
FOLD_STAGES, FOLD_CHUNK, FOLD_ROWS = 3, 1024, 8


def fold_bytes(rows: int) -> int:
    return 4 * (FOLD_STAGES * FOLD_CHUNK + 2 * FOLD_CHUNK
                + 2 * min(rows, FOLD_ROWS) * (FOLD_CHUNK + 64))


def attention_phase_plan(rows: int, H: int, KV: int, T: int, dh: int, lut) -> AttnPlan:
    """The plan of ``fused_attn_out_mlp``'s attention phase at ``rows``
    decode rows: the decode tile of ``approx_attention`` (the heads of a
    group, 4 a tile), laid out (``attention_layout``) in the fold buffers of
    ``rows`` rows, the table read where the fold staged it, as stored."""
    table = TABLES[(0 if lut_in_smem(lut) else 2) + int(lut.dtype == torch.int16)]
    layout = attention_layout(DECODE_TILE, dh, T, fold_bytes(rows))
    return _tile_plan(AttnShape(rows, 1, H, KV, T, dh), DECODE_TILE, table, layout, "decode")


def back_half_grid(rows: int, d: int, F: int, lut, *, heads: int = 0,
                   kv_heads: int = 0) -> dict:
    """The grid that ``fused_out_mlp`` (``heads`` = 0) or
    ``fused_attn_out_mlp`` takes at these shapes on the current card,
    without launching: the cooperative blocks and each phase's work items
    (``wo``, ``gate_up``, ``down``; ``attention``: the tiles of its
    attention phase, ``attention_phase_plan``).  ``lut`` is the CUDA table
    the launch would read."""
    if heads and not kv_heads:
        raise ValueError("back_half_grid with an attention phase needs kv_heads")
    out = (ctypes.c_longlong * 5)()
    call_kernel("decode_chain", "back_half_grid", lut.device, rows, d, F, heads, kv_heads,
                int(lut.dtype == torch.int16), int(lut_in_smem(lut)), lut_bytes(lut), out)
    return dict(zip(("blocks", "wo", "gate_up", "down", "attention"), out))


def qkv_grid(rows: int, nq: int, nk: int, nv: int, lut) -> dict:
    """The grid that ``fused_qkv_norm`` takes at these shapes on the current
    card, without launching: its blocks and its work items (row group,
    column tile of wq, wk or wv).  ``lut`` is the CUDA table the launch
    would read."""
    out = (ctypes.c_longlong * 2)()
    call_kernel("decode_chain", "qkv_grid", lut.device, rows, nq, nk, nv,
                int(lut.dtype == torch.int16), int(lut_in_smem(lut)), lut_bytes(lut), out)
    return dict(zip(("blocks", "items"), out))


def wo_norm_grid(rows: int, d: int, lut) -> dict:
    """The grid that ``fused_wo_norm`` takes at these shapes on the current
    card, without launching: its cooperative blocks and the work items of
    its wo phase (row group, column tile of 8).  The contraction K does not
    enter it.  ``lut`` is the CUDA table the launch would read."""
    out = (ctypes.c_longlong * 2)()
    call_kernel("decode_chain", "wo_norm_grid", lut.device, rows, d,
                int(lut.dtype == torch.int16), int(lut_in_smem(lut)), lut_bytes(lut), out)
    return dict(zip(("blocks", "items"), out))


def live_rows(h: torch.Tensor) -> torch.Tensor:
    """(E,) the capacity rows of each expert of h (E, C, d) that
    ``fused_moe_ffn`` computes: those with an element whose exponent field
    is not 0.  Every product of another row is +-0, so its output is +0.0
    and the kernel writes that without a lookup."""
    return live_elements(h).any(dim=-1).sum(dim=-1)


def moe_ffn_grid(E: int, C: int, d: int, F: int, lut, *, live=None) -> dict:
    """The grid that ``fused_moe_ffn`` takes at these shapes on the current
    card, without launching: its cooperative blocks (sized for a full
    buffer) and the work items of its gate/up and down phases (expert, live
    row group, column tile) when each expert e has ``live[e]`` live rows
    (``live_rows``), or every row when ``live`` is None."""
    out = (ctypes.c_longlong * 3)()
    counts = None if live is None else (ctypes.c_int * E)(*(int(n) for n in live))
    call_kernel("decode_chain", "moe_ffn_grid", lut.device, E, C, d, F, counts,
                int(lut.dtype == torch.int16), int(lut_in_smem(lut)), lut_bytes(lut), out)
    return dict(zip(("blocks", "gate_up", "down"), out))


def device_exp_rsqrt(x: torch.Tensor):
    """(expf(x), rsqrtf(x)) as the attention and chain kernels evaluate
    them, for a float32 CUDA tensor: the probe that holds the kernels'
    transcendentals against ``torch.exp`` and ``torch.rsqrt``."""
    check_float32(x)
    if x.device.type != "cuda":
        raise ValueError("device_exp_rsqrt probes the CUDA kernels' math; x must be on the card")
    check_contiguous(x)
    e, r = torch.empty_like(x), torch.empty_like(x)
    call_kernel("decode_chain", "libm_probe_f32", x.device, x.data_ptr(), e.data_ptr(),
                r.data_ptr(), x.numel())
    return e, r
