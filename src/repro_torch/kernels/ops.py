"""Policy-routed matmul and conv2d: the port's AMDENSE/AMCONV2D ops (§VI).

Every GEMM and conv of a model goes through ``policy_matmul`` or
``approx_conv2d`` with a ``NumericsPolicy`` and a site label; the policy
resolves the leaf ``(mode, multiplier)`` for the site and pass, and the
leaf picks the lowering:

  native       ``torch.matmul`` / ``F.conv2d``, exact float32 (TF32 off)
  amsim        the CUDA kernels ``approx_gemm`` / ``approx_conv2d_fused`` /
               ``approx_conv2d_dw``
  amsim_torch  their plain PyTorch versions (im2col for the conv)
  direct       im2col + the sequential-k GEMM over ``Multiplier.torch_mul``

Both ops are ``torch.autograd.Function``s whose backward runs the two
gradient products under the leaves ``policy.resolve(site, pass_="dx")``
and ``pass_="dw"`` (paper: approximate multipliers in the forward pass
and in backpropagation), the twins of the JAX package's ``custom_vjp``s
(``repro/kernels/ops.py`` ``_mm_fwd``/``_mm_bwd``, ``_conv_fwd``/
``_conv_bwd``).  A gradient whose input needs none is not computed, as
JAX's ``jit`` drops it as dead code.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.lutgen import get_lut, get_packed_lut
from repro_torch.core.multipliers import Multiplier, get_multiplier
from repro_torch.core.policy import NumericsPolicy
from .approx_conv import approx_conv2d_dw, approx_conv2d_fused, conv_out_shape, conv_pads
from .approx_gemm import approx_gemm
from .common import lut_tensor
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
    """(..., m, k) @ (k, n): a 2-D weight folds a's batch into m, one GEMM."""
    if a.ndim == 2:
        return _gemm2d(a, b, leaf)
    k = a.shape[-1]
    out = _gemm2d(a.reshape(-1, k), b, leaf)
    return out.reshape(*a.shape[:-1], b.shape[-1])


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
    backward GEMMs under the ``dx``/``dw`` leaves.

    The equal-batch layout (attention scores, MoE expert banks) needs the
    batched kernel, which a later slice ports.
    """
    if b.ndim != 2 or a.ndim < 2:
        raise NotImplementedError(
            "only (..., m, k) @ (k, n) is ported; batched approximate GEMMs "
            "need approx_gemm_batched, which comes in a later slice")
    return _PolicyMatmul.apply(a.to(torch.float32), b.to(torch.float32), policy, site)


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


def conv_dx_operands(g, w, x_hw: tuple[int, int], stride: int, pads):
    """The data gradient as a stride-1 conv (paper Fig. 8c): the error g
    dilated by ``stride`` (zeros between its rows and columns), the weights
    reversed in (ki, kj) with C and O swapped, and the explicit pads under
    which that conv returns H x W.  Returns (gd, w_rt, pads)."""
    n, oh, ow, o = g.shape
    kh, kw = w.shape[:2]
    h, wid = x_hw
    if stride > 1:
        gd = g.new_zeros((n, (oh - 1) * stride + 1, (ow - 1) * stride + 1, o))
        gd[:, ::stride, ::stride, :] = g
    else:
        gd = g
    pt = kh - 1 - pads[0]
    pl = kw - 1 - pads[2]
    pb = h - (gd.shape[1] + pt - kh + 1)
    pr = wid - (gd.shape[2] + pl - kw + 1)
    w_rt = w.flip(0, 1).permute(0, 1, 3, 2).contiguous()
    return gd.contiguous(), w_rt, (pt, pb, pl, pr)


def _conv_dx(x_shape, w, g, stride: int, pads, leaf: NumericsPolicy):
    """Data gradient under ``leaf``: the native backward, or the forward
    lowering on the operands of ``conv_dx_operands``."""
    n, h, wid, c = x_shape
    if leaf.is_native:
        _exact_fp32()
        pt, pb, pl, pr = pads
        dxp = torch.nn.grad.conv2d_input((n, c, h + pt + pb, wid + pl + pr),
                                         w.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2),
                                         stride=stride)
        return dxp[:, :, pt:pt + h, pl:pl + wid].permute(0, 2, 3, 1).contiguous()
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
