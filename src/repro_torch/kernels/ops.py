"""Policy-routed matmul, einsum, conv2d, attention and the decode chain:
the port's AMDENSE/AMCONV2D ops (§VI) and the LM serving path.

Every GEMM, conv and attention contraction of a model goes through these
ops with a policy (a flat ``NumericsPolicy`` or a per-site
``PolicyTable``) and a site label; the policy resolves the leaf ``(mode,
multiplier)`` for the site and pass, and the leaf picks the lowering:

  native       ``torch.matmul`` / ``torch.einsum`` / ``F.conv2d``, exact
               float32 (TF32 off)
  surrogate    operands cut to the multiplier's per-operand widths, then
               the exact ``torch.matmul`` (the conv through im2col)
  amsim        the CUDA kernels ``approx_gemm`` / ``approx_gemm_batched`` /
               ``approx_conv2d_fused`` / ``approx_conv2d_dw`` /
               ``approx_attention`` and the decode chain's five
  amsim_torch  their plain PyTorch versions (im2col for the conv)
  direct       im2col + the sequential-k GEMM over ``Multiplier.torch_mul``

The matmul and the conv are ``torch.autograd.Function``s whose backward
runs the two gradient products under the leaves ``policy.resolve(site,
pass_="dx")`` and ``pass_="dw"`` (paper: approximate multipliers in the
forward pass and in backpropagation), the twins of the JAX package's
``custom_vjp``s (``repro/kernels/ops.py`` ``_mm_fwd``/``_mm_bwd``,
``_conv_fwd``/``_conv_bwd``).  A gradient whose input needs none is not
computed, as JAX's ``jit`` drops it as dead code.  The fused attention and
the five decode-chain entries run their kernel forward and take their
gradient from a recompute of the per-op lowering (``attend_einsum``, the
``decode_*_oracle``s) with grad enabled, as JAX's ``_pattn_bwd`` and
``_decode_*_bwd`` do: no backward kernel, the forward kernels on other
operands.

Every table the ops read comes through ``_amsim_lut`` / ``_oracle_lut``,
the fault-injection seam (``core/faults.py``): the active fault spec is
part of the key of the cache of tables on each device, so a faulted table
is uploaded once and never served under the clean key, and with faults
off the same tensor as ever comes back.  ``lut_uploads`` counts the
uploads of each key.

Four kill switches, read as the JAX package reads them, are explicit
opt-outs (each defaults to on; "0" or "false" turns it off), never a
fallback on failure: ``REPRO_CONV_FUSED=0`` runs an ``amsim`` conv (forward,
dx and dw) through im2col and the GEMM kernel; ``REPRO_ATTN_FUSED=0`` runs
an ``amsim`` attention as the einsum lowering (two batched GEMMs);
``REPRO_DECODE_FUSED=0`` runs a decode step per op, without the chain
kernels or the expert-bank launch; ``REPRO_DECODE_FUSE_ATTN=0`` keeps the
attention core out of the back-half launch (the chain's 3-launch form).
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from repro_torch.core import faults
from repro_torch.core.float_bits import torch_round_mantissa, torch_truncate_mantissa
from repro_torch.core.lutgen import get_lut, get_packed_lut
from repro_torch.core.multipliers import Multiplier, get_multiplier
from repro_torch.core.policy import PASSES, Numerics, NumericsPolicy
from .approx_attention import approx_attention, approx_attention_plain, softmax_scores
from .approx_conv import (approx_conv2d_dw, approx_conv2d_fused, conv_out_shape, conv_pads,
                          dilate)
from .approx_gemm import approx_gemm, approx_gemm_batched
from .common import attention_mask, best_chunk, lut_tensor
from .decode_chain import (fused_attn_out_mlp, fused_attn_out_mlp_plain, fused_moe_ffn,
                           fused_moe_ffn_plain, fused_out_mlp, fused_out_mlp_plain,
                           fused_qkv_norm, fused_qkv_norm_plain, fused_wo_norm,
                           fused_wo_norm_plain, silu)
from .ref import ref_amsim_gemm, ref_direct_gemm, ref_im2col


def switched_off(name: str) -> bool:
    """Whether the kill switch ``name`` (an environment variable, on unless
    "0" or "false") is off."""
    return os.environ.get(name, "1").lower() in ("0", "false")


def conv_fused_enabled(leaf: NumericsPolicy) -> bool:
    """Whether a conv pass under ``leaf`` runs the conv kernels (an
    ``amsim`` leaf, ``REPRO_CONV_FUSED`` on); else im2col and a GEMM."""
    return leaf.mode == "amsim" and not leaf.is_native and not switched_off("REPRO_CONV_FUSED")


# (multiplier, M, packed, device, fault spec or None) -> the table there.
_LUTS: dict[tuple, torch.Tensor] = {}
# The same keys -> how many times the table was copied to its device.
lut_uploads: dict[tuple, int] = {}


def _lut_on(mult: Multiplier, device: torch.device, packed: bool) -> torch.Tensor:
    """The table of ``mult`` in one layout on ``device`` under the active
    fault spec.  A spec that leaves this table as it is (zero faults
    drawn, or aimed at another multiplier) serves the clean tensor."""
    spec = faults.active_spec()
    key = (mult.name, mult.mantissa_bits, packed, str(device), spec)
    if key not in _LUTS:
        table = get_packed_lut(mult) if packed else get_lut(mult)
        faulted = table if spec is None else faults.apply_faults(
            table, mult.mantissa_bits, spec, packed=packed, mult=mult.name)
        if faulted is table and spec is not None:     # the spec leaves this table as it is
            with faults.inject(None):
                _LUTS[key] = _lut_on(mult, device, packed)
        else:
            _LUTS[key] = lut_tensor(faulted, device)
            lut_uploads[key] = lut_uploads.get(key, 0) + 1
    return _LUTS[key]


def _amsim_lut(mult: Multiplier, device: torch.device) -> torch.Tensor:
    """Kernel LUT for ``mult`` on ``device``: packed (int16 storage) when
    the table packs, which halves its shared-memory footprint; canonical
    (int32 storage) otherwise.  The fault seam: faulted by the active spec
    (``core/faults.py``), cached per (multiplier, layout, device, spec)."""
    return _lut_on(mult, device, get_packed_lut(mult) is not None)


def _oracle_lut(mult: Multiplier, device: torch.device) -> torch.Tensor:
    """Canonical LUT for the ``amsim_torch`` reference mode, through the
    same fault seam (the packed and canonical forms fault alike)."""
    return _lut_on(mult, device, False)


def exact_fp32():
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


def _surrogate(a, b, mult: Multiplier):
    """The ``surrogate`` product (JAX ``_matmul_nograd``): each operand cut
    to its own width of ``mult.operand_bits`` (bf16 of the hand-written zoo
    rounds its operands, every other multiplier truncates them), then the
    exact float32 ``torch.matmul``."""
    ma, mb = mult.operand_bits
    cut = (torch_round_mantissa if mult.pipeline is None and mult.name.startswith("bf16")
           else torch_truncate_mantissa)
    exact_fp32()
    return torch.matmul(cut(a, ma), cut(b, mb))


def _gemm2d(a, b, leaf: NumericsPolicy):
    """(m, k) @ (k, n) -> (m, n) under a leaf policy's numerics."""
    if leaf.is_native:
        exact_fp32()
        return torch.matmul(a, b)
    if leaf.mode == "surrogate":
        return _surrogate(a, b, get_multiplier(leaf.multiplier))
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
        exact_fp32()
        return torch.matmul(a, b)
    if leaf.mode == "surrogate":
        return _surrogate(a, b, get_multiplier(leaf.multiplier))
    if leaf.mode == "amsim":
        mult = get_multiplier(leaf.multiplier)
        batch, (m, k), n = a.shape[:-2], a.shape[-2:], b.shape[-1]
        out = approx_gemm_batched(a.reshape(-1, m, k).contiguous(),
                                  b.reshape(-1, k, n).contiguous(),
                                  _amsim_lut(mult, a.device), mult.mantissa_bits)
        return out.reshape(*batch, m, n)
    return _GEMM_MODES[leaf.mode](a, b, get_multiplier(leaf.multiplier))


# Sites whose second operand is a parameter even when it is a stacked 3-D
# bank: the MoE expert FFN runs (E, C, d) @ (E, d, F), the equal-batch
# layout of the attention einsums, but its db is a weight gradient and
# resolves under the dw pass (the JAX package's ``_STACKED_WEIGHT_SITES``).
_STACKED_WEIGHT_SITES = frozenset({"wg", "wu", "wd"})


def _sum_to(x, shape):
    """x summed over the leading dims it has beyond ``shape`` and over the
    dims where ``shape`` broadcasts a 1 (the JAX ``_mm_bwd`` sums)."""
    extra = x.ndim - len(shape)
    if extra > 0:
        x = x.sum(dim=tuple(range(extra)))
    dims = tuple(i for i, (xs, s) in enumerate(zip(x.shape, shape)) if s == 1 and xs != 1)
    return x.sum(dim=dims, keepdim=True) if dims else x


class _PolicyMatmul(torch.autograd.Function):
    """(..., m, k) @ (k, n) or (..., m, k) @ (..., k, n) with the fwd, dx
    and dw leaves of one site."""

    @staticmethod
    def forward(ctx, a, b, policy: Numerics, site):
        ctx.save_for_backward(a, b)
        ctx.policy, ctx.site = policy, site
        return _matmul_nograd(a, b, policy.resolve(site))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        leaf_dx = ctx.policy.resolve(ctx.site, pass_="dx")
        leaf_dw = ctx.policy.resolve(ctx.site, pass_="dw")
        da = db = None
        if ctx.needs_input_grad[0]:
            # dA = g @ B^T under the dx leaf, in the forward's batch layout.
            da = _sum_to(_matmul_nograd(g, b.transpose(-1, -2), leaf_dx), a.shape)
        if ctx.needs_input_grad[1]:
            if b.ndim == 2:
                # dB = A_flat^T @ g_flat: every batch row folds into one
                # GEMM (paper Fig. 8b), under the dw leaf.
                db = _gemm2d(a.reshape(-1, a.shape[-1]).T, g.reshape(-1, g.shape[-1]), leaf_dw)
            else:
                # A batched b is an activation (dx) unless the site stacks
                # its weights 3-D (the MoE banks: dw).
                leaf = leaf_dw if ctx.site in _STACKED_WEIGHT_SITES else leaf_dx
                db = _sum_to(_matmul_nograd(a.transpose(-1, -2), g, leaf), b.shape)
        return da, db, None, None


def policy_matmul(a, b, policy: Numerics, site: str | None = None):
    """Differentiable matmul (..., m, k) @ (k, n) or (..., m, k) @ (..., k,
    n) under the numerics ``policy`` resolves at ``site``: forward under
    the ``fwd`` leaf, the backward products under the ``dx``/``dw`` leaves
    (a batched b's gradient under dw only at the expert-bank sites).
    Under ``amsim`` each product is one launch of the GEMM kernel, 2-D or
    batched.
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


def _all_passes_native(policy: Numerics, site: str | None) -> bool:
    return all(policy.resolve(site, pass_=p).is_native for p in PASSES)


def policy_einsum(spec: str, a, b, policy: Numerics, site: str | None = None):
    """2-operand einsum under policy numerics: ``torch.einsum`` when every
    pass resolves native, else a (batch, m, k) @ (batch, k, n)
    ``policy_matmul`` between two permutations."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if _all_passes_native(policy, site):
        exact_fp32()
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
        exact_fp32()
        y = F.conv2d(_nchw_padded(x, pads), w.permute(3, 2, 0, 1), stride=stride)
        return y.permute(0, 2, 3, 1).contiguous()
    if conv_fused_enabled(leaf):
        mult = get_multiplier(leaf.multiplier)
        return approx_conv2d_fused(x.contiguous(), w.contiguous(), _amsim_lut(mult, x.device),
                                   mult.mantissa_bits, stride=stride, padding=pads)
    return conv2d_im2col(x, w, stride, pads, leaf)


def _conv_dw(x, w_shape, g, stride: int, pads, leaf: NumericsPolicy):
    """Weight gradient (paper Fig. 8b) under ``leaf``."""
    kh, kw, c, o = w_shape
    if leaf.is_native:
        exact_fp32()
        dw = torch.nn.grad.conv2d_weight(_nchw_padded(x, pads), (o, c, kh, kw),
                                         g.permute(0, 3, 1, 2), stride=stride)
        return dw.permute(2, 3, 1, 0).contiguous()
    if conv_fused_enabled(leaf):
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
        exact_fp32()
        pt, pb, pl, pr = pads
        dxp = torch.nn.grad.conv2d_input((n, c, h + pt + pb, wid + pl + pr),
                                         w.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2),
                                         stride=stride)
        return dxp[:, :, pt:pt + h, pl:pl + wid].permute(0, 2, 3, 1).contiguous()
    if conv_fused_enabled(leaf):
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
    def forward(ctx, x, w, stride: int, pads, policy: Numerics):
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


def approx_conv2d(x, w, stride: int, padding, policy: Numerics):
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
# for an ``amsim`` leaf at every shape, and its plain version for an
# ``amsim_torch`` leaf; every other mode runs ``attend_einsum``.  Both
# contractions of the einsum lowering resolve under their own sites
# ("attn_score" / "attn_value"); the kernel bakes one LUT, so it needs the
# two to resolve alike.  The softmax of both is ``softmax_scores``, so
# ``attend_einsum`` under ``amsim_torch`` is the kernel's plain version, bit
# for bit.  ``amsim_torch`` takes ``policy_attention`` too, so that its
# backward is the kernel's (the recompute, a query chunk at a time past
# ``_BWD_Q_CHUNK``): a chunked dk sums its chunks' folds, which autograd
# through the einsum lowering would fold in one, so only the same structure
# trains bit for bit alike at 1500 encoder frames.
# =====================================================================

def attend_einsum(q, k, v, q_pos, k_pos, policy: Numerics, *, causal: bool,
                  window: int):
    """Grouped-query einsum attention under ``policy`` numerics: q
    (B,S,H,dh), k/v (B,T,KV,dh), q_pos (S,) and k_pos (T,) absolute
    positions, or (B, S) and (B, T) per batch row (negative = unwritten
    slot, masked) -> (B,S,H,dh).  The KV-head axis stays a batch axis, so
    K/V are never repeated G times."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, dh)
    scores = policy_einsum("bqkgd,btkd->bkgqt", qg, k, policy, "attn_score")
    mask = attention_mask(q_pos, k_pos, causal=causal, window=window)
    # (S, T) broadcasts over (B, KV, G); a per-row (B, S, T) over (KV, G)
    if mask.ndim == 3:
        mask = mask[:, None, None]
    probs = softmax_scores(scores, mask, dh)
    out = policy_einsum("bkgqt,btkd->bqkgd", probs, v, policy, "attn_value")
    return out.reshape(B, S, H, dh)


def attention_fused_leaf(policy: Numerics) -> NumericsPolicy | None:
    """The one leaf both attention contractions resolve to, or None when
    the score and value sites resolve differently."""
    ls = policy.resolve("attn_score")
    lv = policy.resolve("attn_value")
    if (ls.mode, ls.multiplier) != (lv.mode, lv.multiplier):
        return None
    return ls


def fused_attention_enabled(policy: Numerics) -> bool:
    """The attention dispatch: the fused kernel for an ``amsim`` leaf,
    at every shape (the kernel has no size guard) and every position
    layout, unless ``REPRO_ATTN_FUSED`` is off."""
    return _one_call_attention_mode(policy) == "amsim"


def one_call_attention_enabled(policy: Numerics) -> bool:
    """Whether attention runs as ``policy_attention``: the fused kernel
    (``amsim``) or its plain version (``amsim_torch``)."""
    return _one_call_attention_mode(policy) is not None


def _one_call_attention_mode(policy: Numerics) -> str | None:
    leaf = attention_fused_leaf(policy)
    if (leaf is None or leaf.mode not in ("amsim", "amsim_torch") or leaf.is_native
            or switched_off("REPRO_ATTN_FUSED")):
        return None
    return leaf.mode


class _Recompute(torch.autograd.Function):
    """A kernel's forward, ``fwd(*tensors)``, whose gradient ``bwd(tensors,
    needs, grads)`` computes by recomputing the per-op lowering: the shape
    of the JAX package's fused ``custom_vjp``s.  ``needs`` marks the tensors
    that want a gradient; ``bwd`` returns one gradient or None per tensor."""

    @staticmethod
    def forward(ctx, fwd, bwd, *tensors):
        ctx.bwd = bwd
        ctx.save_for_backward(*tensors)
        return fwd(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.bwd(ctx.saved_tensors, ctx.needs_input_grad[2:], grads))


def _vjp(fn, tensors, needs, grads):
    """The gradients of ``fn(*tensors)`` against ``grads`` for the tensors
    ``needs`` marks (None for the others), from a recompute of ``fn`` with
    grad enabled."""
    with torch.enable_grad():
        leaves = [t if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(tensors, needs)]
        out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    wrt = [t for t, n in zip(leaves, needs) if n]
    got = iter(torch.autograd.grad(outs, wrt, [g.to(torch.float32) for g in grads],
                                   allow_unused=True))
    return [next(got) if n else None for n in needs]


# The query chunk of the attention backward's recompute (the JAX package's
# ``_BWD_Q_CHUNK``, = ``ArchConfig.q_chunk``'s default): the recompute
# holds (B, KV, G, chunk, T) scores, not all S query rows at once.
_BWD_Q_CHUNK = 1024


def _attention_bwd(policy: Numerics, causal: bool, window: int):
    """The fused attention's backward (JAX ``_pattn_bwd``): the gradient of
    ``attend_einsum`` recomputed a query chunk at a time when the sequence
    splits into chunks of more than ``_BWD_Q_CHUNK // 16`` rows, so dq
    splits by chunk and dk, dv sum over chunks in order; else in one.
    Per-row (B, S) positions (the paged cache's short segments) are
    recomputed in one, as there."""
    def bwd(tensors, needs, grads):
        q, k, v, q_pos, k_pos = tensors
        (g,) = grads
        S = q.shape[1]

        def grads_of(q_c, qp_c, g_c):
            fn = lambda q_, k_, v_: attend_einsum(q_, k_, v_, qp_c, k_pos, policy,  # noqa: E731
                                                 causal=causal, window=window)
            return _vjp(fn, (q_c, k, v), needs[:3], (g_c,))

        bqc = best_chunk(_BWD_Q_CHUNK, S)
        if not S > bqc > _BWD_Q_CHUNK // 16 or q_pos.ndim != 1:
            return (*grads_of(q, q_pos, g), None, None)
        dq, dk, dv = [], None, None
        for i in range(0, S, bqc):
            dq_c, dk_c, dv_c = grads_of(q[:, i:i + bqc], q_pos[i:i + bqc], g[:, i:i + bqc])
            dq.append(dq_c)
            dk = dk_c if dk is None or dk_c is None else dk + dk_c
            dv = dv_c if dv is None or dv_c is None else dv + dv_c
        return (torch.cat(dq, dim=1) if needs[0] else None), dk, dv, None, None
    return bwd


def policy_attention(q, k, v, q_pos, k_pos, policy: Numerics, causal: bool,
                     window: int):
    """Differentiable one-launch fused attention under the policy's
    ``amsim`` leaf (its plain version under ``amsim_torch``): the kernel
    forward, the gradient from a recompute of ``attend_einsum`` (each
    backward product under its site's dx leaf).  Callers check
    :func:`one_call_attention_enabled`."""
    leaf = attention_fused_leaf(policy)
    mult = get_multiplier(leaf.multiplier)
    attend, lut_of = ((approx_attention, _amsim_lut) if leaf.mode == "amsim"
                      else (approx_attention_plain, _oracle_lut))

    def fwd(q, k, v, q_pos, k_pos):
        return attend(q.contiguous(), k.contiguous(), v.contiguous(), q_pos, k_pos,
                      lut_of(mult, q.device), mult.mantissa_bits, causal=causal,
                      window=int(window))

    return _Recompute.apply(fwd, _attention_bwd(policy, causal, int(window)),
                            q.to(torch.float32), k.to(torch.float32), v.to(torch.float32),
                            q_pos, k_pos)


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
# (prefill too) whose capacity C is at most ``MOE_FFN_MAX_C``; larger
# buffers run three batched GEMMs.  There is no other guard: the kernels
# take every shape.
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
# ones the three batched GEMMs, as there.  At llama4-maverick-400b-a17b's
# (128 experts, d 5120, expert d_ff 8192) it fails at every capacity, and
# JAX runs the three batched GEMMs; the port keeps the one launch up to
# C = 256 there too (the card has no VMEM budget).  The bits are the same
# either way.
MOE_FFN_MAX_C = 256


def _one_leaf(policy: Numerics, sites) -> NumericsPolicy | None:
    leaves = [policy.resolve(s) for s in sites]
    first = leaves[0]
    if any((lf.mode, lf.multiplier) != (first.mode, first.multiplier) for lf in leaves[1:]):
        return None
    return first


def chain_leaf_ok(leaf: NumericsPolicy | None) -> bool:
    """Whether ``leaf`` is a chain leaf: ``amsim`` or ``amsim_torch``, not
    native."""
    return leaf is not None and leaf.mode in _CHAIN_MODES and not leaf.is_native


def decode_chain_leaf(policy: Numerics) -> NumericsPolicy | None:
    """The one forward leaf every chain and attention site resolves to, or
    None when any two differ."""
    return _one_leaf(policy, _CHAIN_SITES)


def _sharded(leaf: NumericsPolicy) -> bool:
    """Whether the sharded per-op path owns this leaf's products (an active
    mesh: ``distributed/shard_fused.active_mesh``).  The chain then stays
    off, as JAX's; under REPRO_SHARD_FUSED=0 it runs on gathered weights."""
    from repro_torch.distributed import shard_fused   # lazy: it imports this module
    return shard_fused.active_mesh(leaf) is not None


def decode_chain_enabled(policy: Numerics) -> bool:
    """Whether a single-token step runs as the chain (one chain leaf,
    ``REPRO_DECODE_FUSED`` on, no active mesh)."""
    leaf = decode_chain_leaf(policy)
    return (chain_leaf_ok(leaf) and not switched_off("REPRO_DECODE_FUSED")
            and not _sharded(leaf))


def moe_ffn_leaf(policy: Numerics) -> NumericsPolicy | None:
    """The one leaf the expert banks' wg/wu/wd resolve to, or None when they
    differ (the router stays a GEMM of its own either way)."""
    return _one_leaf(policy, _MOE_FFN_SITES)


def decode_moe_ffn_enabled(policy: Numerics, C: int) -> bool:
    """Whether an MoE FFN over a capacity of ``C`` rows an expert runs as
    the one stacked expert-bank launch (``decode_moe_ffn``)."""
    leaf = moe_ffn_leaf(policy)
    return (chain_leaf_ok(leaf) and C <= MOE_FFN_MAX_C
            and not switched_off("REPRO_DECODE_FUSED") and not _sharded(leaf))


def decode_fuse_attn_enabled(policy: Numerics, T: int) -> bool:
    """Whether the attention core folds into the back-half launch (2
    launches a layer instead of 3) for ``T`` key slots (a ring's, or a
    paged table's pages x page size): unless ``REPRO_ATTN_FUSED`` or
    ``REPRO_DECODE_FUSE_ATTN`` is off."""
    return (decode_chain_enabled(policy) and T <= FUSE_ATTN_MAX_T
            and not switched_off("REPRO_ATTN_FUSED") and not switched_off("REPRO_DECODE_FUSE_ATTN"))


def _chain_call(policy: Numerics, device, leaf: NumericsPolicy | None = None):
    """(plain?, lut, M) of the chain leaf (or ``leaf``): the kernels under
    ``amsim`` with the kernel LUT, the plain versions under
    ``amsim_torch``."""
    leaf = decode_chain_leaf(policy) if leaf is None else leaf
    mult = get_multiplier(leaf.multiplier)
    if leaf.mode == "amsim":
        return False, _amsim_lut(mult, device), mult.mantissa_bits
    return True, _oracle_lut(mult, device), mult.mantissa_bits


def rmsnorm_expr(x, g, eps: float):
    """rmsnorm(x; g) over the last dim: ``models.layers.rmsnorm``'s
    expression, which the decode oracles recompute."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)) * g


def _bias(y, b):
    return y if b is None else y + b


def decode_qkv_oracle(x, g1, wq, wk, wv, policy: Numerics, eps: float):
    """The chain's front half per op: rmsnorm, then three ``policy_matmul``
    projections under site "qkv" (JAX ``decode_qkv_oracle``)."""
    h = rmsnorm_expr(x.to(torch.float32), g1, eps)
    return tuple(policy_matmul(h, w, policy, "qkv") for w in (wq, wk, wv))


def decode_out_mlp_oracle(x, attn, g2, wo, wg, wu, wd, policy: Numerics, eps: float,
                          bo=None, bd=None):
    """The chain's back half per op: wo (+bo), +residual, rmsnorm, the
    swiglu FFN (+bd), +residual (JAX ``decode_out_mlp_oracle``)."""
    x1, h = decode_wo_norm_oracle(x, attn, g2, wo, bo, policy, eps)
    return x1 + _bias(decode_moe_ffn_oracle(h, wg, wu, wd, policy), bd)


def decode_wo_norm_oracle(x, attn, g2, wo, bo, policy: Numerics, eps: float):
    """The MoE back half's prefix per op: x1 = x + attn @ wo (+bo) and h =
    rmsnorm(x1; g2); returns (x1, h) (JAX ``decode_wo_norm_oracle``)."""
    x1 = x.to(torch.float32) + _bias(policy_matmul(attn, wo, policy, "wo"), bo)
    return x1, rmsnorm_expr(x1, g2, eps)


def decode_moe_ffn_oracle(buf, wg, wu, wd, policy: Numerics):
    """The swiglu FFN per op, three ``policy_matmul``s under the wg/wu/wd
    sites: of a row block with 2-D weights, or of every expert's capacity
    buffer with the stacked banks (JAX ``decode_moe_ffn_oracle``)."""
    return policy_matmul(silu(policy_matmul(buf, wg, policy, "wg"))
                         * policy_matmul(buf, wu, policy, "wu"), wd, policy, "wd")


def _chain_fn(policy: Numerics, device, kernel, plain, leaf=None):
    """The chain launch of the leaf (``decode_chain_leaf`` or ``leaf``):
    ``kernel`` under ``amsim``, ``plain`` under ``amsim_torch``, with its
    LUT and M bound."""
    is_plain, lut, M = _chain_call(policy, device, leaf)
    fn = plain if is_plain else kernel
    return lambda *args, **kw: fn(*args, lut, M, **kw)


def _oracle_bwd(oracle):
    """The backward of a chain entry: the gradient of ``oracle`` over the
    entry's tensors, recomputed."""
    return lambda tensors, needs, grads: _vjp(oracle, tensors, needs, grads)


def decode_qkv(x, g1, wq, wk, wv, policy: Numerics, eps: float):
    """rmsnorm(x; g1) and the q/k/v projections of a decode step, x
    (rows, d) -> (q, k, v), in one launch; the gradient recomputes
    :func:`decode_qkv_oracle`.  Callers check
    :func:`decode_chain_enabled`."""
    fn = _chain_fn(policy, x.device, fused_qkv_norm, fused_qkv_norm_plain)
    return _Recompute.apply(
        lambda *t: fn(*t, eps=eps),
        _oracle_bwd(lambda *t: decode_qkv_oracle(*t, policy, eps)), x, g1, wq, wk, wv)


def decode_out_mlp_b(x, attn, g2, wo, wg, wu, wd, bo, bd, policy: Numerics,
                     eps: float):
    """The back half of a decode step with optional wo/wd biases (None
    when absent): x (rows, d) residual stream, attn (rows, H*dh) ->
    (rows, d), in one launch; the gradient recomputes
    :func:`decode_out_mlp_oracle`."""
    fn = _chain_fn(policy, x.device, fused_out_mlp, fused_out_mlp_plain)
    return _Recompute.apply(
        lambda *t: fn(*t[:7], eps=eps, bo=t[7], bd=t[8]),
        _oracle_bwd(lambda *t: decode_out_mlp_oracle(*t[:7], policy, eps, bo=t[7], bd=t[8])),
        x, attn, g2, wo, wg, wu, wd, bo, bd)


def decode_attn_out_mlp(x, q, k, v, q_pos, k_pos, g2, wo, wg, wu, wd, bo, bd,
                        policy: Numerics, eps: float, causal: bool, window: int):
    """The attention core and the back half of a decode step in one launch:
    x (B, d), q (B, 1, H, dh) roped, k/v (B, T, KV, dh) the cache after
    this step's write -> (B, d); the gradient recomputes ``attend_einsum``
    and :func:`decode_out_mlp_oracle`.  Callers check
    :func:`decode_fuse_attn_enabled`."""
    fn = _chain_fn(policy, x.device, fused_attn_out_mlp, fused_attn_out_mlp_plain)
    window = int(window)

    def oracle(x, q, k, v, q_pos, k_pos, g2, wo, wg, wu, wd, bo, bd):
        B, S, H, dh = q.shape
        a = attend_einsum(q, k, v, q_pos, k_pos, policy, causal=causal, window=window)
        return decode_out_mlp_oracle(x, a.reshape(B * S, H * dh), g2, wo, wg, wu, wd, policy,
                                     eps, bo=bo, bd=bd)

    return _Recompute.apply(
        lambda *t: fn(*t[:11], eps=eps, causal=causal, window=window, bo=t[11], bd=t[12]),
        _oracle_bwd(oracle), x, q, k, v, q_pos, k_pos, g2, wo, wg, wu, wd, bo, bd)


def decode_wo_norm(x, attn, g2, wo, bo, policy: Numerics, eps: float):
    """The MoE back half's prefix of a decode step: x (rows, d) residual
    stream, attn (rows, H*dh) -> (x1, h), x1 = x + attn@wo (+bo) and h =
    rmsnorm(x1; g2), in one launch; the gradient recomputes
    :func:`decode_wo_norm_oracle`.  Callers check
    :func:`decode_chain_enabled`."""
    fn = _chain_fn(policy, x.device, fused_wo_norm, fused_wo_norm_plain)
    return _Recompute.apply(
        lambda *t: fn(*t[:4], eps=eps, bo=t[4]),
        _oracle_bwd(lambda *t: decode_wo_norm_oracle(*t, policy, eps)), x, attn, g2, wo, bo)


def decode_moe_ffn(buf, wg, wu, wd, policy: Numerics):
    """The swiglu FFN of every expert over its capacity buffer: buf (E, C,
    d), wg/wu (E, d, F), wd (E, F, d) -> (E, C, d), in one launch; the
    gradient recomputes :func:`decode_moe_ffn_oracle` (the banks' db under
    the dw leaf).  Callers check :func:`decode_moe_ffn_enabled`."""
    fn = _chain_fn(policy, buf.device, fused_moe_ffn, fused_moe_ffn_plain, moe_ffn_leaf(policy))
    return _Recompute.apply(
        lambda buf, wg, wu, wd: fn(buf.contiguous(), wg, wu, wd),
        _oracle_bwd(lambda *t: decode_moe_ffn_oracle(*t, policy)), buf, wg, wu, wd)
