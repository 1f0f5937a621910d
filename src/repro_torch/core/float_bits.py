"""Bit-level IEEE-754 FP32 helpers (numpy and torch).

Floats are handled as raw 32-bit words ``[ sign:1 | exponent:8 |
mantissa:23 ]``.  The numpy helpers (``np_*``) serve the multiplier models
and the LUT generator; the torch helpers carry the words in int64, because
torch on the CPU has no uint32 right shift and ``>>`` on int32 is
arithmetic.  Every torch word therefore holds a value in ``[0, 2**32)``,
and code masks after each shift.
"""
from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------- constants
SIGN_MASK = np.uint32(0x8000_0000)
EXP_MASK = np.uint32(0x7F80_0000)
MNT_MASK = np.uint32(0x007F_FFFF)
CARRY_BIT = np.uint32(0x0080_0000)  # bit 23: LUT carry flag (paper Alg. 1 l.14)
EXP_BIAS = 127
MNT_BITS = 23

# Storage formats: name -> significand fraction bits ((1, 8, m) formats of
# Table II).  Only the mantissa width of a format is simulated.
FLOAT_FORMATS = {
    "fp32": 23,
    "tf32": 10,
    "fp16": 10,
    "bf16": 7,
    "fp8e4m3": 3,
    "fp8e5m2": 2,
}


def format_mantissa_bits(fmt: str) -> int:
    """Fraction bits of a named storage format (``FLOAT_FORMATS``)."""
    try:
        return FLOAT_FORMATS[fmt]
    except KeyError:
        raise ValueError(
            f"unknown float format {fmt!r}; have {sorted(FLOAT_FORMATS)}"
        ) from None


# ---------------------------------------------------------------- numpy side
def np_bits(x) -> np.ndarray:
    """float32 array -> uint32 bit pattern."""
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def np_float(u) -> np.ndarray:
    """uint32 bit pattern -> float32 array."""
    return np.asarray(u, dtype=np.uint32).view(np.float32)


def np_sign(u) -> np.ndarray:
    return (u & SIGN_MASK) >> np.uint32(31)


def np_exp(u) -> np.ndarray:
    """Biased exponent field (0..255)."""
    return (u & EXP_MASK) >> np.uint32(MNT_BITS)


def np_mnt(u) -> np.ndarray:
    """23-bit mantissa field."""
    return u & MNT_MASK


def np_pack(sign, exp, mnt) -> np.ndarray:
    """Assemble (sign, biased-exp, mantissa-field) -> uint32 word."""
    sign = np.asarray(sign, np.uint32)
    exp = np.asarray(exp, np.uint32)
    mnt = np.asarray(mnt, np.uint32)
    return (sign << np.uint32(31)) | (exp << np.uint32(MNT_BITS)) | (mnt & MNT_MASK)


def np_truncate_mantissa(x, m: int) -> np.ndarray:
    """Keep the top ``m`` mantissa bits of float32 ``x`` (no rounding)."""
    if m >= MNT_BITS:
        return np.asarray(x, np.float32)
    keep = np.uint32(0xFFFF_FFFF) << np.uint32(MNT_BITS - m)
    return np_float(np_bits(x) & keep)


def np_round_mantissa(x, m: int) -> np.ndarray:
    """Round-to-nearest-even the mantissa of float32 ``x`` to ``m`` bits."""
    if m >= MNT_BITS:
        return np.asarray(x, np.float32)
    u = np_bits(x).astype(np.uint64)
    shift = MNT_BITS - m
    half = np.uint64(1 << (shift - 1))
    lsb = (u >> np.uint64(shift)) & np.uint64(1)
    u = u + half - np.uint64(1) + lsb  # RNE trick
    u = (u >> np.uint64(shift)) << np.uint64(shift)
    return np_float(u.astype(np.uint32))


# ---------------------------------------------------------------- torch side
_WORD = 0xFFFF_FFFF


def torch_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 tensor -> int64 tensor of its uint32 bit patterns."""
    return x.to(torch.float32).view(torch.int32).to(torch.int64) & _WORD


def torch_float(u: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 bit patterns -> float32 tensor."""
    u = u & _WORD
    signed = torch.where(u >= 2**31, u - 2**32, u)
    return signed.to(torch.int32).view(torch.float32)


def torch_truncate_mantissa(x: torch.Tensor, m: int) -> torch.Tensor:
    """Keep the top ``m`` mantissa bits of float32 ``x`` (no rounding);
    bitwise ``np_truncate_mantissa``."""
    if m >= MNT_BITS:
        return x.to(torch.float32)
    return torch_float(torch_bits(x) & ((_WORD << (MNT_BITS - m)) & _WORD))


def torch_round_mantissa(x: torch.Tensor, m: int) -> torch.Tensor:
    """Round-to-nearest-even the mantissa of float32 ``x`` to ``m`` bits;
    bitwise ``np_round_mantissa`` (a carry past bit 31 is dropped, as the
    numpy twin's cast back to uint32 drops it)."""
    if m >= MNT_BITS:
        return x.to(torch.float32)
    u = torch_bits(x)
    shift = MNT_BITS - m
    u = u + (1 << (shift - 1)) - 1 + ((u >> shift) & 1)
    return torch_float((u >> shift) << shift)
