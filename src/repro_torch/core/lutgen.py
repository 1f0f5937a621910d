"""Algorithm 1: black-box mantissa-product LUT generation (paper §V-A).

Probes a functional multiplier model over all 2^M x 2^M mantissa pairs at
a safe exponent and records the approximate mantissa product and the
carry bit of each:

    mntmult_lut[k * 2^M + j] = (carry << 23) | mantissa_field(C)

(uint32 entries, 2^(2M) of them).  ``pack_lut`` compresses a table to
uint16 entries ``(carry << M) | top-M mantissa``.  A generated multiplier
(``fpstages``) is emitted by its staged integer pipeline instead of probed,
bit for bit the same table.  Tables are cached per process only, keyed on
the multiplier's canonical name: one with M <= 8 generates in
milliseconds, an M = 10 cross-format one in well under a second.
"""
from __future__ import annotations

import os

import numpy as np

from .float_bits import MNT_BITS, MNT_MASK, np_bits, np_float, np_pack
from .multipliers import Multiplier, get_multiplier

_CACHE: dict[tuple[str, int], np.ndarray] = {}
_PACKED_CACHE: dict[tuple[str, int], np.ndarray | None] = {}

# Widest M whose packed entry (carry bit + M mantissa bits) fits uint16.
PACK_MAX_M = 15

# Safe exponent per Alg. 1 line 4: N = K = 127 -> product exponent
# N + K - 127 = 127, well inside [1, 254] even after a carry.
_SAFE_EXP = 127


def _pipeline_generation_enabled() -> bool:
    """REPRO_PIPELINE_LUT=0 sends generated multipliers through the
    black-box Algorithm 1 (probing ``np_mul``) instead of the staged
    emission; both give the same bits."""
    return os.environ.get("REPRO_PIPELINE_LUT", "1").lower() not in ("0", "false", "off")


def generate_lut(multiplier: Multiplier, M: int | None = None) -> np.ndarray:
    """Run Algorithm 1 against ``multiplier``; returns uint32[2^(2M)].

    A generated multiplier (``multiplier.pipeline`` set) is emitted by
    ``fpstages.pipeline_lut`` when M is its table's M; any other M goes
    through the black-box probe, as for the hand-written models."""
    spec = multiplier.pipeline
    if (spec is not None and _pipeline_generation_enabled()
            and (M is None or M == spec.table_bits)):
        from .fpstages import pipeline_lut

        return pipeline_lut(spec)
    return _generate_lut_blackbox(multiplier, M)


def _generate_lut_blackbox(multiplier: Multiplier, M: int | None = None) -> np.ndarray:
    """The paper's Algorithm 1 proper: probe ``np_mul`` on the mantissa grid."""
    M = multiplier.mantissa_bits if M is None else M
    if not 1 <= M <= 12:
        raise ValueError(f"LUT mantissa bits must be in [1,12], got {M}")
    n = 1 << M
    # All mantissa-field combinations, top-M bits significant (lines 5-7).
    k = np.arange(n, dtype=np.uint32) << np.uint32(MNT_BITS - M)
    ka, kb = np.meshgrid(k, k, indexing="ij")  # A index is the row (k*2^M+j)
    A = np_float(np_pack(0, _SAFE_EXP, ka))
    B = np_float(np_pack(0, _SAFE_EXP, kb))
    C = np.asarray(multiplier.np_mul(A, B), dtype=np.float32)  # line 8
    uc = np_bits(C)
    exp_c = (uc >> np.uint32(MNT_BITS)) & np.uint32(0xFF)
    # Lines 9-13: carry detection against the unnormalised exponent.
    carry = (exp_c > _SAFE_EXP + _SAFE_EXP - 127).astype(np.uint32)
    entry = (carry << np.uint32(MNT_BITS)) | (uc & MNT_MASK)  # line 14
    return entry.reshape(-1)


def pack_lut(lut: np.ndarray, M: int) -> np.ndarray:
    """Compress a uint32 LUT to uint16: entry = (carry << M) | top-M mantissa.

    Valid only when every entry's mantissa field is confined to its top-M
    bits (true for every core in ``multipliers.py``); checked, so a
    full-precision model fails loudly instead of losing bits.
    """
    if not 1 <= M <= PACK_MAX_M:
        raise ValueError(f"packed LUT requires 1 <= M <= {PACK_MAX_M}, got {M}")
    lut = np.asarray(lut, np.uint32)
    carry = (lut >> np.uint32(MNT_BITS)) & np.uint32(1)
    mnt = lut & MNT_MASK
    low = np.uint32((1 << (MNT_BITS - M)) - 1)
    if np.any(mnt & low):
        raise ValueError(
            f"LUT has mantissa bits below the top {M}; not packable")
    return ((carry << np.uint32(M)) | (mnt >> np.uint32(MNT_BITS - M))).astype(
        np.uint16)


def unpack_lut(packed: np.ndarray, M: int) -> np.ndarray:
    """Inverse of ``pack_lut``: uint16 -> the canonical uint32 layout."""
    p = np.asarray(packed, np.uint32)
    carry = p >> np.uint32(M)
    mnt = (p & np.uint32((1 << M) - 1)) << np.uint32(MNT_BITS - M)
    return ((carry << np.uint32(MNT_BITS)) | mnt).astype(np.uint32)


def _resolve(name_or_mult, M):
    mult = get_multiplier(name_or_mult) if isinstance(name_or_mult, str) else name_or_mult
    return mult, (mult.mantissa_bits if M is None else M)


def get_lut(name_or_mult, M: int | None = None) -> np.ndarray:
    """Canonical uint32 LUT, generated once per process."""
    mult, M = _resolve(name_or_mult, M)
    key = (mult.name, M)
    if key not in _CACHE:
        _CACHE[key] = generate_lut(mult, M)
    return _CACHE[key]


def get_packed_lut(name_or_mult, M: int | None = None) -> np.ndarray | None:
    """Packed uint16 LUT, or None if this multiplier's table is unpackable."""
    mult, M = _resolve(name_or_mult, M)
    key = (mult.name, M)
    if key not in _PACKED_CACHE:
        try:
            _PACKED_CACHE[key] = pack_lut(get_lut(mult, M), M)
        except ValueError:
            _PACKED_CACHE[key] = None
    return _PACKED_CACHE[key]
