"""AMCONV2D: the LUT-simulated NHWC convolution and its weight gradient,
two CUDA kernels.

``approx_conv2d_fused`` computes an implicit-GEMM conv with every product
simulated by AMSim (``csrc/approx_conv.cu``; it replaces the TPU kernel
``repro/kernels/approx_conv.py:_amconv_kernel``).  The data gradient dx
runs through it too, as a stride-1 conv of the dilated error
(``ops.py``).  ``approx_conv2d_dw`` computes the weight gradient
(``csrc/approx_conv_dw.cu``; it replaces ``_amconv_dw_kernel``).
Activations are NHWC and weights HWIO, as in the JAX package.  On a CUDA
tensor each wrapper launches its kernel or raises; on a CPU tensor it
runs its plain version (``approx_conv2d_plain``, ``approx_conv2d_dw_plain``:
im2col with (ki, kj, c) columns, then the sequential-k GEMM), which folds
in the kernel's order.

The kernels stage no image, so they take every conv shape: the port needs
no ``fused_supported`` guard and no im2col fallback.

``approx_conv2d_fused.launches`` and ``approx_conv2d_dw.launches`` count
the kernels' launches.
"""
from __future__ import annotations

import torch

from .common import (call_kernel, check_contiguous, check_float32, check_lut,
                     lut_bytes, lut_in_smem, operand_device)
from .ref import ref_amsim_gemm, ref_im2col


# ------------------------------------------------------------------ padding
def conv_pads(h: int, w: int, kh: int, kw: int, stride: int,
              padding) -> tuple[int, int, int, int]:
    """(top, bottom, left, right) pads with XLA's conv semantics.

    "SAME" gives ceil(in / stride) outputs and splits the total pad with
    the extra one low=floor, high=remainder, as ``lax.padtype_to_pads``
    does (asymmetric for even kernels and for stride 2 on even inputs);
    "VALID" pads nothing.  An explicit 4-tuple is passed through.
    """
    if not isinstance(padding, str):
        pt, pb, pl, pr = padding
        return (int(pt), int(pb), int(pl), int(pr))
    mode = padding.upper()
    if mode == "VALID":
        return (0, 0, 0, 0)
    if mode != "SAME":
        raise ValueError(f"padding must be 'SAME', 'VALID' or a 4-tuple, got {padding!r}")
    pads = []
    for size, k in ((h, kh), (w, kw)):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


def conv_out_shape(h: int, w: int, kh: int, kw: int, stride: int,
                   pads: tuple[int, int, int, int]) -> tuple[int, int]:
    pt, pb, pl, pr = pads
    return ((h + pt + pb - kh) // stride + 1,
            (w + pl + pr - kw) // stride + 1)


# ------------------------------------------------------------------ forward
def approx_conv2d_plain(x, w, lut, M: int, stride: int, pads):
    """The kernel's plain PyTorch version: im2col + sequential-k GEMM."""
    n, h, wid, _ = x.shape
    kh, kw, _, o = w.shape
    oh, ow = conv_out_shape(h, wid, kh, kw, stride, pads)
    cols = ref_im2col(x, kh, kw, stride, pads)
    return ref_amsim_gemm(cols, w.reshape(-1, o), lut, M).reshape(n, oh, ow, o)


def approx_conv2d_fused(x: torch.Tensor, w: torch.Tensor, lut: torch.Tensor, M: int, *,
                        stride: int = 1, padding="SAME") -> torch.Tensor:
    """Implicit-GEMM LUT-simulated conv2d: x (N,H,W,C), w (KH,KW,C,O) ->
    (N,OH,OW,O), f32 accumulate.

    ``padding`` is "SAME"/"VALID" or explicit (top, bottom, left, right).
    ``lut`` is the table in kernel storage (int16 packed, int32 canonical).
    """
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"approx_conv2d_fused takes x (N,H,W,C) and w (KH,KW,C,O), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    check_float32(x, w)
    check_lut(lut, M)
    n, h, wid, c = x.shape
    kh, kw, _, o = w.shape
    pads = conv_pads(h, wid, kh, kw, stride, padding)
    if min(pads) < 0:
        raise ValueError(f"pads must be >= 0, got {pads}")
    oh, ow = conv_out_shape(h, wid, kh, kw, stride, pads)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"empty conv output {(oh, ow)} for {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, stride {stride}, pads {pads}")
    device = operand_device(x, w, lut)
    if device.type == "cpu":
        return approx_conv2d_plain(x, w, lut, M, stride, pads)
    check_contiguous(x, w, lut)
    out = torch.empty((n, oh, ow, o), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    call_kernel("approx_conv", "approx_conv2d_f32", device,
                x.data_ptr(), w.data_ptr(), lut.data_ptr(), out.data_ptr(),
                n, h, wid, c, kh, kw, o, stride, pads[0], pads[2], oh, ow, M,
                int(lut.dtype == torch.int16), int(lut_in_smem(lut)), lut_bytes(lut))
    approx_conv2d_fused.launches += 1
    return out


approx_conv2d_fused.launches = 0


# ---------------------------------------------------------- weight gradient
def approx_conv2d_dw_plain(x, g, lut, M: int, kh: int, kw: int, stride: int, pads):
    """The dw kernel's plain PyTorch version: cols^T @ g as a sequential-k
    GEMM, k = (n, oy, ox) row-major."""
    c = x.shape[3]
    o = g.shape[3]
    cols = ref_im2col(x, kh, kw, stride, pads)
    return ref_amsim_gemm(cols.T, g.reshape(-1, o), lut, M).reshape(kh, kw, c, o)


def approx_conv2d_dw(x: torch.Tensor, g: torch.Tensor, lut: torch.Tensor, M: int, *,
                     kh: int, kw: int, stride: int = 1, padding="SAME") -> torch.Tensor:
    """LUT-simulated conv weight gradient (paper Fig. 8b): x (N,H,W,C) and
    the upstream error g (N,OH,OW,O) -> dw (KH,KW,C,O), with
    dw[ki,kj,c,o] = sum_{n,oy,ox} amsim(x[n, oy*s+ki-pt, ox*s+kj-pl, c],
    g[n,oy,ox,o]) folded in (n, oy, ox) order from +0.0.

    ``padding`` is the forward conv's: "SAME"/"VALID" or explicit (top,
    bottom, left, right).  ``lut`` is the table in kernel storage.
    """
    if x.ndim != 4 or g.ndim != 4 or x.shape[0] != g.shape[0]:
        raise ValueError(f"approx_conv2d_dw takes x (N,H,W,C) and g (N,OH,OW,O), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    check_float32(x, g)
    check_lut(lut, M)
    n, h, wid, c = x.shape
    o = g.shape[3]
    pads = conv_pads(h, wid, kh, kw, stride, padding)
    if min(pads) < 0:
        raise ValueError(f"pads must be >= 0, got {pads}")
    oh, ow = conv_out_shape(h, wid, kh, kw, stride, pads)
    if (oh, ow) != tuple(g.shape[1:3]):
        raise ValueError(f"g is {tuple(g.shape)} but the conv of {tuple(x.shape)} with a "
                         f"{kh}x{kw} kernel, stride {stride}, pads {pads} gives {(oh, ow)}")
    device = operand_device(x, g, lut)
    if device.type == "cpu":
        return approx_conv2d_dw_plain(x, g, lut, M, kh, kw, stride, pads)
    check_contiguous(x, g, lut)
    if n * oh * ow > 2**30 or kh * kw * c * o > 2**30:
        raise ValueError(f"approx_conv2d_dw folds at most 2^30 positions into at most 2^30 "
                         f"outputs (32-bit indices), got {n * oh * ow} and {kh * kw * c * o}")
    out = torch.empty((kh, kw, c, o), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    call_kernel("approx_conv_dw", "approx_conv2d_dw_f32", device,
                x.data_ptr(), g.data_ptr(), lut.data_ptr(), out.data_ptr(),
                n, h, wid, c, kh, kw, o, stride, pads[0], pads[2], oh, ow, M,
                int(lut.dtype == torch.int16), int(lut_in_smem(lut)), lut_bytes(lut))
    approx_conv2d_dw.launches += 1
    return out


approx_conv2d_dw.launches = 0
