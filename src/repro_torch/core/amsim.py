"""Algorithm 2: AMSim, the LUT-based approximate FP multiply (paper §V-B).

Given FP32 operands and the mantissa-product LUT from Algorithm 1:
  1. fetch the mantissa product (+carry) from the LUT,
  2. compute sign (XOR) and exponent (ea + eb - 127 + carry) exactly,
  3. concatenate; flush to zero on underflow or a zero input, inf on
     overflow.

``amsim_multiply`` works on torch tensors and is the arithmetic of the
plain GEMM and conv (``kernels/ref.py``), and of the CUDA device function
in ``kernels/csrc/amsim.cuh``.  ``np_amsim_multiply`` is its numpy twin.

On the torch side a LUT is held as the kernels take it: int32 storage of
the canonical uint32 table, or int16 storage of the packed uint16 table
(``kernels/common.lut_tensor``); the dtype says which.
"""
from __future__ import annotations

import numpy as np
import torch

from .float_bits import MNT_BITS, np_bits, np_float, torch_bits, torch_float

_MNT_MASK = 0x007F_FFFF


def _amsim(ua, ub, lut, M: int, xp, packed: bool = False):
    """Alg. 2 over int64 words holding uint32 values; ``xp`` is torch or numpy.

    ``lut`` holds the unsigned table entries as int64; ``packed`` reads the
    uint16 layout of ``lutgen.pack_lut``: entry = (carry << M) | top-M
    mantissa bits.  int64 because torch on the CPU has no uint32 right
    shift; every shift is followed by a mask.
    """
    amnt = ua & _MNT_MASK
    bmnt = ub & _MNT_MASK
    # Index = concat(top-M bits of A mantissa, top-M bits of B mantissa)
    # (paper line 8; shift-then-or so it also works for M=12).
    idx = ((amnt >> (MNT_BITS - M)) << M) | (bmnt >> (MNT_BITS - M))
    entry = lut[idx]
    if packed:
        entry = ((entry >> M) << MNT_BITS) | ((entry & ((1 << M) - 1)) << (MNT_BITS - M))
    carry = (entry >> MNT_BITS) & 1  # line 9
    mnt = entry & _MNT_MASK  # line 10
    sign = ((ua ^ ub) >> 31) & 1  # line 11
    ea = (ua >> MNT_BITS) & 0xFF
    eb = (ub >> MNT_BITS) & 0xFF
    e = ea + eb - 127  # line 12
    zero = (e <= 0) | (ea == 0) | (eb == 0)  # line 13, before the carry
    e = e + carry  # line 18
    inf = (e >= 255) & ~zero  # line 15, after the carry
    e = xp.clip(e, 0, 255)
    out = (sign << 31) | (e << MNT_BITS) | mnt  # line 19
    out = xp.where(inf, (sign << 31) | 0x7F80_0000, out)
    return xp.where(zero, sign << 31, out)  # signed zero


def lut_words(lut: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """(int64 unsigned entries, packed?) of a LUT in kernel storage."""
    if lut.dtype == torch.int16:
        return lut.to(torch.int64) & 0xFFFF, True
    if lut.dtype == torch.int32:
        return lut.to(torch.int64) & 0xFFFF_FFFF, False
    raise TypeError(f"LUT must be int16 (packed) or int32 (canonical), got {lut.dtype}")


def amsim_multiply(a, b, lut: torch.Tensor, M: int):
    """Approximate product of broadcastable float32 tensors ``a``, ``b``;
    ``lut`` in kernel storage (int16 packed, int32 canonical)."""
    a, b = torch.broadcast_tensors(a.to(torch.float32), b.to(torch.float32))
    words, packed = lut_words(lut)
    return torch_float(_amsim(torch_bits(a), torch_bits(b), words, M, torch, packed=packed))


def np_amsim_multiply(a, b, lut, M: int, packed: bool = False):
    """numpy twin of ``amsim_multiply`` (the LUT-correctness oracle)."""
    a, b = np.broadcast_arrays(np.asarray(a, np.float32), np.asarray(b, np.float32))
    lut = np.asarray(lut, np.uint16 if packed else np.uint32)
    ua = np_bits(a).astype(np.int64)
    ub = np_bits(b).astype(np.int64)
    out = _amsim(ua, ub, lut.astype(np.int64), M, np, packed=packed)
    return np_float(out.astype(np.uint32))
