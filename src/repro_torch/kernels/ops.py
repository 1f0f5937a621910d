"""Policy-routed matmul, einsum, conv2d, attention and the decode chain:
the port's AMDENSE/AMCONV2D ops (§VI) and the LM serving path.

Every GEMM, conv and attention contraction of a model goes through these
ops with a ``NumericsPolicy`` and a site label; the policy resolves the
leaf ``(mode, multiplier)`` for the site and pass, and the leaf picks the
lowering:

  native       ``torch.matmul`` / ``torch.einsum`` / ``F.conv2d``, exact
               float32 (TF32 off)
  amsim        the CUDA kernels ``approx_gemm`` / ``approx_gemm_batched`` /
               ``approx_conv2d_fused`` / ``approx_conv2d_dw`` /
               ``approx_attention`` and the decode chain's five
  amsim_torch  their plain PyTorch versions (im2col for the conv)
  direct       im2col + the sequential-k GEMM over ``Multiplier.torch_mul``

Both ops are ``torch.autograd.Function``s whose backward runs the two
gradient products under the leaves ``policy.resolve(site, pass_="dx")``
and ``pass_="dw"`` (paper: approximate multipliers in the forward pass
and in backpropagation), the twins of the JAX package's ``custom_vjp``s
(``repro/kernels/ops.py`` ``_mm_fwd``/``_mm_bwd``, ``_conv_fwd``/
``_conv_bwd``).  A gradient whose input needs none is not computed, as
JAX's ``jit`` drops it as dead code.  Batched products, attention and the
decode chain run forward only: their gradients come with LM training.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.lutgen import get_lut, get_packed_lut
from repro_torch.core.multipliers import Multiplier, get_multiplier
from repro_torch.core.policy import PASSES, NumericsPolicy
from .approx_attention import approx_attention, softmax_scores
from .approx_conv import (approx_conv2d_dw, approx_conv2d_fused, conv_out_shape, conv_pads,
                          dilate)
from .approx_gemm import approx_gemm, approx_gemm_batched
from .common import attention_mask, lut_tensor
from .decode_chain import (fused_attn_out_mlp, fused_attn_out_mlp_plain, fused_moe_ffn,
                           fused_moe_ffn_plain, fused_out_mlp, fused_out_mlp_plain,
                           fused_qkv_norm, fused_qkv_norm_plain, fused_wo_norm,
                           fused_wo_norm_plain)
from .ref import ref_amsim_gemm, ref_direct_gemm, ref_im2col

_LUTS: dict[tuple, torch.Tensor] = {}


def _lut_on(mult: Multiplier, device: torch.device, packed: bool) -> torch.Tensor:
    key = (mult.name, mult.mantissa_bits, packed, str(device))
    if key not in _LUTS:
        table = get_packed_lut(mult) if packed else get_lut(mult)
        _LUTS[key] = lut_tensor(table, device)
    return _LUTS[key]


def _amsim_lut(mult: Multiplier, device: torch.device) -> torch.Tensor:
    """Kernel LUT for ``mult`` on ``device``: packed (int16 storage) when
    the table packs, which halves its shared-memory footprint; canonical
    (int32 storage) otherwise.  Cached per (multiplier, packed, device)."""
    return _lut_on(mult, device, get_packed_lut(mult) is not None)


def _oracle_lut(mult: Multiplier, device: torch.device) -> torch.Tensor:
    """Canonical LUT for the ``amsim_torch`` reference mode."""
    return _lut_on(mult, device, False)


def _exact_fp32():
    """The native baseline is exact float32: cuBLAS and cuDNN may not
    round operands to TF32 (cuDNN convolutions would by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# =====================================================================
# GEMM dispatch
# =====================================================================

_GEMM_MODES = {
    "amsim": lambda a, b, mult: approx_gemm(
        a, b, _amsim_lut(mult, a.device), mult.mantissa_bits),
    "amsim_torch": lambda a, b, mult: ref_amsim_gemm(
        a, b, _oracle_lut(mult, a.device), mult.mantissa_bits),
    "direct": lambda a, b, mult: ref_direct_gemm(a, b, mult),
}


def _gemm2d(a, b, leaf: NumericsPolicy):
    """(m, k) @ (k, n) -> (m, n) under a leaf policy's numerics."""
    if leaf.is_native:
        _exact_fp32()
        return torch.matmul(a, b)
    return _GEMM_MODES[leaf.mode](a.contiguous(), b.contiguous(),
                                  get_multiplier(leaf.multiplier))


def _matmul_nograd(a, b, leaf: NumericsPolicy):
    """(..., m, k) @ (k, n) or (..., m, k) @ (..., k, n) under ``leaf``.

    A 2-D weight folds a's batch into m, one GEMM.  Equal batch dims (the
    MoE expert banks, the attention einsums) flatten into one batch dim:
    one launch of the batched kernel under ``amsim``; ``native``,
    ``amsim_torch`` and ``direct`` fold the whole batch at once.  Other
    batch dims broadcast first.
    """
    if b.ndim == 2:
        if a.ndim == 2:
            return _gemm2d(a, b, leaf)
        k = a.shape[-1]
        out = _gemm2d(a.reshape(-1, k), b, leaf)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    if a.shape[:-2] != b.shape[:-2]:
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        return _matmul_nograd(a.expand(*batch, *a.shape[-2:]),
                              b.expand(*batch, *b.shape[-2:]), leaf)
    if leaf.is_native:
        _exact_fp32()
        return torch.matmul(a, b)
    if leaf.mode == "amsim":
        mult = get_multiplier(leaf.multiplier)
        batch, (m, k), n = a.shape[:-2], a.shape[-2:], b.shape[-1]
        out = approx_gemm_batched(a.reshape(-1, m, k).contiguous(),
                                  b.reshape(-1, k, n).contiguous(),
                                  _amsim_lut(mult, a.device), mult.mantissa_bits)
        return out.reshape(*batch, m, n)
    return _GEMM_MODES[leaf.mode](a, b, get_multiplier(leaf.multiplier))


class _PolicyMatmul(torch.autograd.Function):
    """(..., m, k) @ (k, n) with the fwd, dx and dw leaves of one site."""

    @staticmethod
    def forward(ctx, a, b, policy: NumericsPolicy, site):
        ctx.save_for_backward(a, b)
        ctx.policy, ctx.site = policy, site
        return _matmul_nograd(a, b, policy.resolve(site))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        if b.ndim != 2:
            raise NotImplementedError(
                "the gradient of a batched product comes with LM training (slice 5)")
        da = db = None
        if ctx.needs_input_grad[0]:
            # dA = g @ B^T under the dx leaf.
            da = _matmul_nograd(g, b.T, ctx.policy.resolve(ctx.site, pass_="dx"))
        if ctx.needs_input_grad[1]:
            # dB = A_flat^T @ g_flat: every batch row folds into one GEMM
            # (paper Fig. 8b), under the dw leaf.
            db = _gemm2d(a.reshape(-1, a.shape[-1]).T, g.reshape(-1, g.shape[-1]),
                         ctx.policy.resolve(ctx.site, pass_="dw"))
        return da, db, None, None


def policy_matmul(a, b, policy: NumericsPolicy, site: str | None = None):
    """Differentiable matmul (..., m, k) @ (k, n) under the numerics
    ``policy`` resolves at ``site``: forward under the ``fwd`` leaf, the
    backward GEMMs under the ``dx``/``dw`` leaves.  (..., m, k) @
    (..., k, n) runs forward only (its gradient comes with LM training).
    """
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError(f"policy_matmul takes (..., m, k) @ (..., k, n), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    return _PolicyMatmul.apply(a.to(torch.float32), b.to(torch.float32), policy, site)


# =====================================================================
# Einsum -> batched-matmul rewrite
# =====================================================================

def _parse_einsum(spec: str, a_shape, b_shape):
    """Classify the labels of a 2-operand einsum into (batch, contract,
    afree, bfree); no repeated labels within an operand and none summed
    alone (the JAX package's ``_parse_einsum``)."""
    lhs, out = spec.replace(" ", "").split("->")
    sa, sb = lhs.split(",")
    if len(set(sa)) != len(sa) or len(set(sb)) != len(sb):
        raise ValueError(f"repeated labels unsupported: {spec}")
    batch = [c for c in sa if c in sb and c in out]
    contract = [c for c in sa if c in sb and c not in out]
    afree = [c for c in sa if c not in sb]
    bfree = [c for c in sb if c not in sa]
    if not all(c in out for c in afree + bfree):
        raise ValueError(f"lone-summed labels unsupported: {spec}")
    dims = dict(zip(sa, a_shape))
    for c, d in zip(sb, b_shape):
        if c in dims and dims[c] != d and 1 not in (dims[c], d):
            raise ValueError(f"dim mismatch for {c!r} in {spec}")
        dims[c] = max(dims.get(c, d), d)
    return sa, sb, out, batch, contract, afree, bfree, dims


def _all_passes_native(policy: NumericsPolicy, site: str | None) -> bool:
    return all(policy.resolve(site, pass_=p).is_native for p in PASSES)


def policy_einsum(spec: str, a, b, policy: NumericsPolicy, site: str | None = None):
    """2-operand einsum under policy numerics: ``torch.einsum`` when every
    pass resolves native, else a (batch, m, k) @ (batch, k, n)
    ``policy_matmul`` between two permutations."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if _all_passes_native(policy, site):
        _exact_fp32()
        return torch.einsum(spec, a, b)
    sa, sb, out, batch, contract, afree, bfree, dims = _parse_einsum(spec, a.shape, b.shape)
    at = a.permute(*[sa.index(c) for c in batch + afree + contract])
    bt = b.permute(*[sb.index(c) for c in batch + contract + bfree])
    bshape = [dims[c] for c in batch]
    at = at.expand(*bshape, *at.shape[len(batch):])
    bt = bt.expand(*bshape, *bt.shape[len(batch):])
    m = math.prod(dims[c] for c in afree)
    k = math.prod(dims[c] for c in contract)
    n = math.prod(dims[c] for c in bfree)
    o = policy_matmul(at.reshape(*bshape, m, k), bt.reshape(*bshape, k, n), policy, site)
    o = o.reshape(*bshape, *[dims[c] for c in afree], *[dims[c] for c in bfree])
    cur = batch + afree + bfree
    return o.permute(*[cur.index(c) for c in out])


# =====================================================================
# Conv2D (AMCONV2D: forward and both gradients)
# =====================================================================

def conv2d_im2col(x, w, stride, pads, leaf: NumericsPolicy):
    """x (N,H,W,C), w (KH,KW,C,O) -> (N,OH,OW,O) via materialised im2col +
    GEMM under ``leaf`` (the reference lowering of the fused conv)."""
    n, h, wid, _ = x.shape
    kh, kw, _, o = w.shape
    cols = ref_im2col(x, kh, kw, stride, pads)      # (N*OH*OW, KH*KW*C)
    oh, ow = conv_out_shape(h, wid, kh, kw, stride, pads)
    return _gemm2d(cols, w.reshape(-1, o), leaf).reshape(n, oh, ow, o)


def _nchw_padded(x, pads):
    pt, pb, pl, pr = pads
    return F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))


def _conv_nograd(x, w, stride: int, pads, leaf: NumericsPolicy):
    """NHWC conv with explicit (top, bottom, left, right) pads under ``leaf``."""
    if leaf.is_native:
        _exact_fp32()
        y = F.conv2d(_nchw_padded(x, pads), w.permute(3, 2, 0, 1), stride=stride)
        return y.permute(0, 2, 3, 1).contiguous()
    if leaf.mode == "amsim":
        mult = get_multiplier(leaf.multiplier)
        return approx_conv2d_fused(x.contiguous(), w.contiguous(), _amsim_lut(mult, x.device),
                                   mult.mantissa_bits, stride=stride, padding=pads)
    return conv2d_im2col(x, w, stride, pads, leaf)


def _conv_dw(x, w_shape, g, stride: int, pads, leaf: NumericsPolicy):
    """Weight gradient (paper Fig. 8b) under ``leaf``."""
    kh, kw, c, o = w_shape
    if leaf.is_native:
        _exact_fp32()
        dw = torch.nn.grad.conv2d_weight(_nchw_padded(x, pads), (o, c, kh, kw),
                                         g.permute(0, 3, 1, 2), stride=stride)
        return dw.permute(2, 3, 1, 0).contiguous()
    if leaf.mode == "amsim":
        mult = get_multiplier(leaf.multiplier)
        return approx_conv2d_dw(x.contiguous(), g, _amsim_lut(mult, x.device),
                                mult.mantissa_bits, kh=kh, kw=kw, stride=stride, padding=pads)
    cols = ref_im2col(x, kh, kw, stride, pads)      # (N*OH*OW, KH*KW*C)
    return _gemm2d(cols.T, g.reshape(-1, o), leaf).reshape(kh, kw, c, o)


def conv_dx_weights(w, g_hw: tuple[int, int], x_hw: tuple[int, int], stride: int, pads):
    """The data gradient's weights and pads as a stride-1 conv (paper Fig.
    8c) of the error g (spatial size ``g_hw``) dilated by ``stride``: the
    weights reversed in (ki, kj) with C and O swapped, and the explicit pads
    under which that conv returns ``x_hw``.  Returns (w_rt, pads)."""
    kh, kw = w.shape[:2]
    h, wid = x_hw
    gh, gw = ((n - 1) * stride + 1 for n in g_hw)
    pt = kh - 1 - pads[0]
    pl = kw - 1 - pads[2]
    pb = h - (gh + pt - kh + 1)
    pr = wid - (gw + pl - kw + 1)
    w_rt = w.flip(0, 1).permute(0, 1, 3, 2).contiguous()
    return w_rt, (pt, pb, pl, pr)


def conv_dx_operands(g, w, x_hw: tuple[int, int], stride: int, pads):
    """The data gradient as a stride-1 conv (paper Fig. 8c) with the
    dilation materialised: the error g dilated by ``stride`` (zeros between
    its rows and columns), and ``conv_dx_weights``.  Returns (gd, w_rt,
    pads)."""
    w_rt, dpads = conv_dx_weights(w, g.shape[1:3], x_hw, stride, pads)
    return dilate(g, stride).contiguous(), w_rt, dpads


def _conv_dx(x_shape, w, g, stride: int, pads, leaf: NumericsPolicy):
    """Data gradient under ``leaf``: the native backward; under ``amsim``
    the conv kernel on the undilated error, ``input_dilation=stride``; else
    the forward lowering on the operands of ``conv_dx_operands``."""
    n, h, wid, c = x_shape
    if leaf.is_native:
        _exact_fp32()
        pt, pb, pl, pr = pads
        dxp = torch.nn.grad.conv2d_input((n, c, h + pt + pb, wid + pl + pr),
                                         w.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2),
                                         stride=stride)
        return dxp[:, :, pt:pt + h, pl:pl + wid].permute(0, 2, 3, 1).contiguous()
    if leaf.mode == "amsim":
        w_rt, dpads = conv_dx_weights(w, g.shape[1:3], (h, wid), stride, pads)
        mult = get_multiplier(leaf.multiplier)
        return approx_conv2d_fused(g.contiguous(), w_rt, _amsim_lut(mult, g.device),
                                   mult.mantissa_bits, stride=1, padding=dpads,
                                   input_dilation=stride)
    gd, w_rt, dpads = conv_dx_operands(g, w, (h, wid), stride, pads)
    return _conv_nograd(gd, w_rt, 1, dpads, leaf)


class _ApproxConv2d(torch.autograd.Function):
    """NHWC conv2d with the fwd, dx and dw leaves of site "conv"."""

    @staticmethod
    def forward(ctx, x, w, stride: int, pads, policy: NumericsPolicy):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.pads, ctx.policy = stride, pads, policy
        return _conv_nograd(x, w, stride, pads, policy.resolve("conv"))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _conv_dx(x.shape, w, g, ctx.stride, ctx.pads,
                          ctx.policy.resolve("conv", pass_="dx"))
        if ctx.needs_input_grad[1]:
            dw = _conv_dw(x, w.shape, g, ctx.stride, ctx.pads,
                          ctx.policy.resolve("conv", pass_="dw"))
        return dx, dw, None, None, None


def approx_conv2d(x, w, stride: int, padding, policy: NumericsPolicy):
    """Differentiable NHWC conv2d, x (N,H,W,C), w (KH,KW,C,O), with the
    numerics ``policy`` resolves at site "conv" for each pass.  ``amsim``
    runs the forward and dx through the fused conv kernel and dw through
    the dw kernel, at every shape."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    pads = conv_pads(x.shape[1], x.shape[2], w.shape[0], w.shape[1], stride, padding)
    return _ApproxConv2d.apply(x, w, stride, pads, policy)


# =====================================================================
# Attention: the fused kernel and the einsum lowering
#
# ``policy_attention`` runs the one-launch kernel (approx_attention.py)
# for an ``amsim`` leaf at every shape; every other mode runs
# ``attend_einsum``.  Both contractions of the einsum lowering resolve
# under their own sites ("attn_score" / "attn_value"); the kernel bakes
# one LUT, so it needs the two to resolve alike.  The softmax of both is
# ``softmax_scores``, so ``attend_einsum`` under ``amsim_torch`` is the
# kernel's plain version, bit for bit.
# =====================================================================

def attend_einsum(q, k, v, q_pos, k_pos, policy: NumericsPolicy, *, causal: bool,
                  window: int):
    """Grouped-query einsum attention under ``policy`` numerics: q
    (B,S,H,dh), k/v (B,T,KV,dh), q_pos (S,), k_pos (T,) absolute
    positions (negative = unwritten ring slot, masked) -> (B,S,H,dh).  The
    KV-head axis stays a batch axis, so K/V are never repeated G times."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, dh)
    scores = policy_einsum("bqkgd,btkd->bkgqt", qg, k, policy, "attn_score")
    mask = attention_mask(q_pos, k_pos, causal=causal, window=window)
    probs = softmax_scores(scores, mask, dh)
    out = policy_einsum("bkgqt,btkd->bqkgd", probs, v, policy, "attn_value")
    return out.reshape(B, S, H, dh)


def attention_fused_leaf(policy: NumericsPolicy) -> NumericsPolicy | None:
    """The one leaf both attention contractions resolve to, or None when
    the score and value sites resolve differently."""
    ls = policy.resolve("attn_score")
    lv = policy.resolve("attn_value")
    if (ls.mode, ls.multiplier) != (lv.mode, lv.multiplier):
        return None
    return ls


def fused_attention_enabled(policy: NumericsPolicy) -> bool:
    """The attention dispatch: the fused kernel for an ``amsim`` leaf,
    at every shape (the kernel has no size guard)."""
    leaf = attention_fused_leaf(policy)
    return leaf is not None and leaf.mode == "amsim" and not leaf.is_native


def _forward_only(what: str, *tensors):
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} is forward only here: its backward (by recompute through the per-op "
            f"path) comes with LM training (slice 5)")


def policy_attention(q, k, v, q_pos, k_pos, policy: NumericsPolicy, causal: bool,
                     window: int):
    """One-launch fused attention under the policy's ``amsim`` leaf
    (forward only).  Callers check :func:`fused_attention_enabled`."""
    _forward_only("policy_attention", q, k, v)
    mult = get_multiplier(attention_fused_leaf(policy).multiplier)
    return approx_attention(q.to(torch.float32).contiguous(), k.to(torch.float32).contiguous(),
                            v.to(torch.float32).contiguous(), q_pos, k_pos,
                            _amsim_lut(mult, q.device), mult.mantissa_bits,
                            causal=causal, window=int(window))


# =====================================================================
# Decode chain (kernels/decode_chain.py)
#
# A single-token dense block runs as norm+qkv, attention, and the back
# half (wo, residual, norm, FFN, residual) in two or three launches when
# every chain site and both attention sites resolve to one ``amsim`` leaf
# (the CUDA kernels) or one ``amsim_torch`` leaf (their plain versions, the
# same structure, so ``amsim`` and ``amsim_torch`` decode bit for bit
# alike).  The attention core folds into the back-half launch when the
# ring holds at most ``FUSE_ATTN_MAX_T`` slots (the regime where the JAX
# package folds it), else it runs in the attention kernel.  An MoE block
# runs norm+qkv, attention, then wo+residual+norm (``decode_wo_norm``),
# the routing in plain PyTorch and the stacked expert banks
# (``decode_moe_ffn``).  The expert-bank launch also serves any MoE FFN
# (prefill too) whose capacity C is at most ``MOE_FFN_MAX_C`` (the regime
# where the JAX package runs it); larger buffers run three batched GEMMs.
# There is no other guard: the kernels take every shape.
# =====================================================================

_CHAIN_SITES = ("qkv", "wo", "wg", "wu", "wd", "attn_score", "attn_value")
_MOE_FFN_SITES = ("wg", "wu", "wd")
_CHAIN_MODES = ("amsim", "amsim_torch")
FUSE_ATTN_MAX_T = 128
# The JAX package runs the stacked expert-bank kernel when its VMEM budget
# model admits the launch (repro/kernels/vmem.py:moe_ffn_fits).  At
# granite-moe-3b-a800m's widths (40 experts, d 1536, expert d_ff 512, an
# M=7 table) that holds for C = 8 ... 256 and fails at C = 512 (11.27 MB
# against 10 MiB), so capacities up to 256 take the one launch and larger
# ones the three batched GEMMs, as there.
MOE_FFN_MAX_C = 256


def _one_leaf(policy: NumericsPolicy, sites) -> NumericsPolicy | None:
    leaves = [policy.resolve(s) for s in sites]
    first = leaves[0]
    if any((lf.mode, lf.multiplier) != (first.mode, first.multiplier) for lf in leaves[1:]):
        return None
    return first


def _chain_leaf_ok(leaf: NumericsPolicy | None) -> bool:
    return leaf is not None and leaf.mode in _CHAIN_MODES and not leaf.is_native


def decode_chain_leaf(policy: NumericsPolicy) -> NumericsPolicy | None:
    """The one forward leaf every chain and attention site resolves to, or
    None when any two differ."""
    return _one_leaf(policy, _CHAIN_SITES)


def decode_chain_enabled(policy: NumericsPolicy) -> bool:
    return _chain_leaf_ok(decode_chain_leaf(policy))


def moe_ffn_leaf(policy: NumericsPolicy) -> NumericsPolicy | None:
    """The one leaf the expert banks' wg/wu/wd resolve to, or None when they
    differ (the router stays a GEMM of its own either way)."""
    return _one_leaf(policy, _MOE_FFN_SITES)


def decode_moe_ffn_enabled(policy: NumericsPolicy, C: int) -> bool:
    """Whether an MoE FFN over a capacity of ``C`` rows an expert runs as
    the one stacked expert-bank launch (``decode_moe_ffn``)."""
    return _chain_leaf_ok(moe_ffn_leaf(policy)) and C <= MOE_FFN_MAX_C


def decode_fuse_attn_enabled(policy: NumericsPolicy, T: int) -> bool:
    """Whether the attention core folds into the back-half launch (2
    launches a layer instead of 3) for a ring of ``T`` slots."""
    return decode_chain_enabled(policy) and T <= FUSE_ATTN_MAX_T


def _chain_call(policy: NumericsPolicy, device, leaf: NumericsPolicy | None = None):
    """(plain?, lut, M) of the chain leaf (or ``leaf``): the kernels under
    ``amsim`` with the kernel LUT, the plain versions under
    ``amsim_torch``."""
    leaf = decode_chain_leaf(policy) if leaf is None else leaf
    mult = get_multiplier(leaf.multiplier)
    if leaf.mode == "amsim":
        return False, _amsim_lut(mult, device), mult.mantissa_bits
    return True, _oracle_lut(mult, device), mult.mantissa_bits


def decode_qkv(x, g1, wq, wk, wv, policy: NumericsPolicy, eps: float):
    """rmsnorm(x; g1) and the q/k/v projections of a decode step, x
    (rows, d) -> (q, k, v); forward only.  Callers check
    :func:`decode_chain_enabled`."""
    _forward_only("decode_qkv", x, g1, wq, wk, wv)
    plain, lut, M = _chain_call(policy, x.device)
    fn = fused_qkv_norm_plain if plain else fused_qkv_norm
    return fn(x, g1, wq, wk, wv, lut, M, eps=eps)


def decode_out_mlp_b(x, attn, g2, wo, wg, wu, wd, bo, bd, policy: NumericsPolicy,
                     eps: float):
    """The back half of a decode step with optional wo/wd biases (None
    when absent): x (rows, d) residual stream, attn (rows, H*dh) ->
    (rows, d); forward only."""
    _forward_only("decode_out_mlp_b", x, attn, g2, wo, wg, wu, wd, bo, bd)
    plain, lut, M = _chain_call(policy, x.device)
    fn = fused_out_mlp_plain if plain else fused_out_mlp
    return fn(x, attn, g2, wo, wg, wu, wd, lut, M, eps=eps, bo=bo, bd=bd)


def decode_attn_out_mlp(x, q, k, v, q_pos, k_pos, g2, wo, wg, wu, wd, bo, bd,
                        policy: NumericsPolicy, eps: float, causal: bool, window: int):
    """The attention core and the back half of a decode step in one launch:
    x (B, d), q (B, 1, H, dh) roped, k/v (B, T, KV, dh) the cache after
    this step's write -> (B, d); forward only.  Callers check
    :func:`decode_fuse_attn_enabled`."""
    _forward_only("decode_attn_out_mlp", x, q, k, v, g2, wo, wg, wu, wd, bo, bd)
    plain, lut, M = _chain_call(policy, x.device)
    fn = fused_attn_out_mlp_plain if plain else fused_attn_out_mlp
    return fn(x, q, k, v, q_pos, k_pos, g2, wo, wg, wu, wd, lut, M, eps=eps, causal=causal,
              window=int(window), bo=bo, bd=bd)


def decode_wo_norm(x, attn, g2, wo, bo, policy: NumericsPolicy, eps: float):
    """The MoE back half's prefix of a decode step: x (rows, d) residual
    stream, attn (rows, H*dh) -> (x1, h), x1 = x + attn@wo (+bo) and h =
    rmsnorm(x1; g2); forward only.  Callers check
    :func:`decode_chain_enabled`."""
    _forward_only("decode_wo_norm", x, attn, g2, wo, bo)
    plain, lut, M = _chain_call(policy, x.device)
    fn = fused_wo_norm_plain if plain else fused_wo_norm
    return fn(x, attn, g2, wo, lut, M, eps=eps, bo=bo)


def decode_moe_ffn(buf, wg, wu, wd, policy: NumericsPolicy):
    """The swiglu FFN of every expert over its capacity buffer: buf (E, C,
    d), wg/wu (E, d, F), wd (E, F, d) -> (E, C, d); forward only.  Callers
    check :func:`decode_moe_ffn_enabled`."""
    _forward_only("decode_moe_ffn", buf, wg, wu, wd)
    plain, lut, M = _chain_call(policy, buf.device, moe_ffn_leaf(policy))
    fn = fused_moe_ffn_plain if plain else fused_moe_ffn
    return fn(buf.contiguous(), wg, wu, wd, lut, M)
