"""Policy-routed matmul and conv2d: the port's AMDENSE/AMCONV2D ops (§VI).

Every GEMM and conv of a model goes through ``policy_matmul`` or
``approx_conv2d`` with a ``NumericsPolicy`` and a site label; the policy
resolves the leaf ``(mode, multiplier)`` for the site, and the leaf picks
the lowering:

  native       ``torch.matmul`` / ``F.conv2d``, exact float32 (TF32 off)
  amsim        the CUDA kernels ``approx_gemm`` / ``approx_conv2d_fused``
  amsim_torch  their plain PyTorch versions (im2col for the conv)

This slice is forward-only: the backward GEMMs (the dx/dw passes, as
``torch.autograd.Function``s) come with the training slice.  Callers run
inference under ``torch.inference_mode()``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.lutgen import get_lut, get_packed_lut
from repro_torch.core.multipliers import Multiplier, get_multiplier
from repro_torch.core.policy import NumericsPolicy
from .approx_conv import approx_conv2d_fused, conv_out_shape, conv_pads
from .approx_gemm import approx_gemm
from .common import lut_tensor
from .ref import ref_amsim_gemm, ref_im2col

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
}


def _gemm2d(a, b, leaf: NumericsPolicy):
    """(m, k) @ (k, n) -> (m, n) under a leaf policy's numerics."""
    if leaf.is_native:
        _exact_fp32()
        return torch.matmul(a, b)
    return _GEMM_MODES[leaf.mode](a.contiguous(), b.contiguous(),
                                  get_multiplier(leaf.multiplier))


def _matmul_nograd(a, b, leaf: NumericsPolicy):
    """(..., m, k) @ (k, n): a 2-D weight folds a's batch into m, one GEMM.

    The equal-batch layout (attention scores, MoE expert banks) needs the
    batched kernel, which a later slice ports.
    """
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if b.ndim != 2 or a.ndim < 2:
        raise NotImplementedError(
            "only (..., m, k) @ (k, n) is ported; batched approximate GEMMs "
            "need approx_gemm_batched, which comes in a later slice")
    if a.ndim == 2:
        return _gemm2d(a, b, leaf)
    batch = a.shape[:-2]
    m, k = a.shape[-2:]
    out = _gemm2d(a.reshape(-1, k), b, leaf)
    return out.reshape(*batch, m, b.shape[-1])


def policy_matmul(a, b, policy: NumericsPolicy, site: str | None = None):
    """Matmul under the numerics ``policy`` resolves at ``site`` (forward)."""
    return _matmul_nograd(a, b, policy.resolve(site))


# =====================================================================
# Conv2D (AMCONV2D forward)
# =====================================================================

def conv2d_im2col(x, w, stride, padding, policy: NumericsPolicy):
    """x (N,H,W,C), w (KH,KW,C,O) -> (N,OH,OW,O) via materialised im2col +
    policy GEMM (the reference lowering of the fused conv)."""
    n, h, wid, c = x.shape
    kh, kw, _, o = w.shape
    pads = conv_pads(h, wid, kh, kw, stride, padding)
    cols = ref_im2col(x, kh, kw, stride, pads)      # (N*OH*OW, KH*KW*C)
    out = policy_matmul(cols, w.reshape(-1, o), policy, "conv")
    oh, ow = conv_out_shape(h, wid, kh, kw, stride, pads)
    return out.reshape(n, oh, ow, o)


def _native_conv2d(x, w, stride, padding):
    _exact_fp32()
    pt, pb, pl, pr = conv_pads(x.shape[1], x.shape[2], w.shape[0], w.shape[1],
                               stride, padding)
    xn = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def approx_conv2d(x, w, stride: int, padding, policy: NumericsPolicy):
    """NHWC conv2d with the numerics ``policy`` resolves at site "conv"
    (forward).  ``amsim`` runs the fused CUDA kernel on every shape."""
    leaf = policy.resolve("conv")
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    if leaf.is_native:
        return _native_conv2d(x, w, stride, padding)
    if leaf.mode == "amsim":
        mult = get_multiplier(leaf.multiplier)
        return approx_conv2d_fused(
            x.contiguous(), w.contiguous(), _amsim_lut(mult, x.device),
            mult.mantissa_bits, stride=stride, padding=padding)
    return conv2d_im2col(x, w, stride, padding, policy)
