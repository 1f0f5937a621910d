"""Functional models of approximate FP multipliers (paper §III-B, §V).

The numpy half of ``repro.core.multipliers``: the black-box "user C
models" that Algorithm 1 (``lutgen.py``) probes.  Only the mantissa
product is approximated; sign and exponent are exact, plus a carry from
mantissa overflow.

Families: ``exact``, ``trunc<M>``, ``bf16``, ``mitchell<M>``, ``afm<M>``
and ``realm<M>`` (see the JAX module for what each models), and the
cross-format staged pipelines ``<fmt_a>x<fmt_b>[_trunc|_sr<seed>]``
(``fp16xbf16``...) that the generator ``fpstages`` builds.

Each model also has a torch twin, ``Multiplier.torch_mul``, for the
``direct`` mode (LUTs cap at M=12, so afm32 is simulated this way).  It
carries words in int64, because torch on the CPU has no uint32 right
shift, and is bitwise equal to ``np_mul``: the exact family forms the
full 48-bit mantissa product, which fits int64.
"""
from __future__ import annotations

import dataclasses
import difflib
import re
from functools import partial
from typing import Any, Callable

import numpy as np
import torch

from .float_bits import (FLOAT_FORMATS, MNT_BITS, MNT_MASK, np_bits, np_float, np_pack,
                         torch_bits, torch_float)

_MNT_ONE = 1 << MNT_BITS  # implicit leading 1 in fixed-point mantissa


# =====================================================================
# Mantissa cores.  Inputs: uint32 23-bit mantissa fields already cut to
# the model's M significant bits.  Output: (mnt_field, carry), carry=1
# when the true mantissa product is >= 2.0.  Integer fixed point with 23
# fractional bits.
# =====================================================================

def _core_exact(ma, mb, M, round_result=False):
    """Exact mantissa product (1.ma * 1.mb), truncated or RNE-rounded to M bits.

    Fixed point: p = (2^23+ma)(2^23+mb) is Q2.46, value in [2^46, 2^48).
    """
    a = ma.astype(np.uint64) + np.uint64(_MNT_ONE)
    b = mb.astype(np.uint64) + np.uint64(_MNT_ONE)
    p = a * b
    carry = (p >> np.uint64(2 * MNT_BITS + 1)).astype(np.uint32)
    # Bit position of the M-bit result LSB within p.
    tot = np.uint64(2 * MNT_BITS - M) + carry.astype(np.uint64)
    if round_result:
        half = np.uint64(1) << (tot - np.uint64(1))
        lsb = (p >> tot) & np.uint64(1)
        p = p + half - np.uint64(1) + lsb
        # Rounding can only bump carry 0 -> 1; renormalise.
        carry2 = (p >> np.uint64(2 * MNT_BITS + 1)).astype(np.uint32)
        tot = tot + (carry2 - carry).astype(np.uint64)
        carry = carry2
    mnt = (((p >> tot) << np.uint64(MNT_BITS - M)) & np.uint64(MNT_MASK)).astype(
        np.uint32)
    return mnt, carry


def _keep_top(mnt, M):
    if M < MNT_BITS:
        mnt = mnt & np.uint32((0xFFFF_FFFF << (MNT_BITS - M)) & 0xFFFF_FFFF)
    return mnt


def _core_mitchell(ma, mb, M):
    """Mitchell log multiplier: (1+ma)(1+mb) ~ 2^carry * (1+frac)."""
    s = ma.astype(np.uint32) + mb.astype(np.uint32)  # Q0.23 sum, < 2^24
    carry = (s >> np.uint32(MNT_BITS)).astype(np.uint32)
    return _keep_top(s & np.uint32(MNT_MASK), M), carry


# Minimal-bias compensation: Mitchell drops a term of mean 1/12 over
# uniform mantissas; adding 1/12 zero-means the error.
_AFM_C = int(round(_MNT_ONE / 12.0))
_SAT = np.uint32((1 << (MNT_BITS + 1)) - 1)  # carry=1, mantissa all ones


def _core_afm(ma, mb, M):
    s = ma.astype(np.uint32) + mb.astype(np.uint32) + np.uint32(_AFM_C)
    s = np.minimum(s, _SAT)  # saturate rather than wrap
    carry = (s >> np.uint32(MNT_BITS)).astype(np.uint32)
    return _keep_top(s & np.uint32(MNT_MASK), M), carry


def _realm_table():
    """8-segment piecewise-constant compensation over the Mitchell sum."""
    segs = []
    for i in range(8):
        lo, hi = i / 8.0, (i + 1) / 8.0
        smid = lo + hi  # midpoint of s = 2*(segment midpoint)
        e = (smid**2) / 6.0 if smid < 1.0 else ((2.0 - smid) ** 2) / 6.0
        segs.append(int(round(e * _MNT_ONE)))
    return segs


_REALM_SEGS = np.asarray(_realm_table(), dtype=np.uint32)


def _core_realm(ma, mb, M):
    s = ma.astype(np.uint32) + mb.astype(np.uint32)  # Q1.23 in [0, 2)
    seg = (s >> np.uint32(MNT_BITS - 2)) & np.uint32(0x7)  # top-3 bits of s/2
    s = np.minimum(s + _REALM_SEGS[seg], _SAT)
    carry = (s >> np.uint32(MNT_BITS)).astype(np.uint32)
    return _keep_top(s & np.uint32(MNT_MASK), M), carry


# =====================================================================
# Full FP multiply: exact sign/exponent + a mantissa core, with AMSim's
# special cases (paper Alg. 2): flush to zero on exponent underflow or a
# zero input, +/-inf on overflow.
# =====================================================================

def _full_multiply(core, a, b, M):
    ua, ub = np_bits(a), np_bits(b)
    keep = (np.uint32((0xFFFF_FFFF << (MNT_BITS - M)) & 0xFFFF_FFFF)
            if M < MNT_BITS else np.uint32(0xFFFF_FFFF))
    ma = ua & MNT_MASK & keep
    mb = ub & MNT_MASK & keep
    ea = (ua >> np.uint32(MNT_BITS)) & np.uint32(0xFF)
    eb = (ub >> np.uint32(MNT_BITS)) & np.uint32(0xFF)
    sign = ((ua ^ ub) >> np.uint32(31)).astype(np.uint32)
    mnt, carry = core(ma, mb, M)
    e = ea.astype(np.int32) + eb.astype(np.int32) - 127 + carry.astype(np.int32)
    zero = (e <= 0) | (ea == 0) | (eb == 0)
    inf = (e >= 255) & ~zero
    e = np.clip(e, 0, 255).astype(np.uint32)
    out = np_pack(sign, e, mnt)
    out = np.where(inf, np_pack(sign, np.uint32(255), np.uint32(0)), out)
    out = np.where(zero, np_pack(sign, np.uint32(0), np.uint32(0)), out)
    return np_float(out)


# =====================================================================
# Torch twins of the cores and of the full multiply, over int64 tensors
# holding unsigned values; every shift is of a non-negative value.
# =====================================================================

_MASK = int(MNT_MASK)
_SAT_INT = int(_SAT)
_REALM_SEGS_LIST = [int(v) for v in _REALM_SEGS]


def _keep_top_t(mnt, M):
    if M < MNT_BITS:
        mnt = mnt & ((0xFFFF_FFFF << (MNT_BITS - M)) & 0xFFFF_FFFF)
    return mnt


def _torch_core_exact(ma, mb, M, round_result=False):
    p = (ma + _MNT_ONE) * (mb + _MNT_ONE)  # < 2^48
    carry = (p >> (2 * MNT_BITS + 1)) & 1
    tot = (2 * MNT_BITS - M) + carry
    if round_result:
        half = torch.ones_like(p) << (tot - 1)
        lsb = (p >> tot) & 1
        p = p + half - 1 + lsb
        carry2 = (p >> (2 * MNT_BITS + 1)) & 1
        tot = tot + (carry2 - carry)
        carry = carry2
    return ((p >> tot) << (MNT_BITS - M)) & _MASK, carry


def _torch_core_mitchell(ma, mb, M):
    s = ma + mb
    return _keep_top_t(s & _MASK, M), (s >> MNT_BITS) & 1


def _torch_core_afm(ma, mb, M):
    s = torch.clamp(ma + mb + _AFM_C, max=_SAT_INT)
    return _keep_top_t(s & _MASK, M), (s >> MNT_BITS) & 1


def _torch_core_realm(ma, mb, M):
    s = ma + mb
    seg = (s >> (MNT_BITS - 2)) & 0x7
    segs = torch.tensor(_REALM_SEGS_LIST, dtype=torch.int64, device=s.device)
    s = torch.clamp(s + segs[seg], max=_SAT_INT)
    return _keep_top_t(s & _MASK, M), (s >> MNT_BITS) & 1


def _torch_full_multiply(core, a, b, M):
    """``_full_multiply`` on float32 tensors (broadcastable)."""
    ua, ub = torch_bits(a), torch_bits(b)
    keep = ((0xFFFF_FFFF << (MNT_BITS - M)) & 0xFFFF_FFFF) if M < MNT_BITS else 0xFFFF_FFFF
    ma = ua & _MASK & keep
    mb = ub & _MASK & keep
    ea = (ua >> MNT_BITS) & 0xFF
    eb = (ub >> MNT_BITS) & 0xFF
    sign = ((ua ^ ub) >> 31) & 1
    mnt, carry = core(ma, mb, M)
    e = ea + eb - 127 + carry
    zero = (e <= 0) | (ea == 0) | (eb == 0)
    inf = (e >= 255) & ~zero
    e = torch.clamp(e, 0, 255)
    out = (sign << 31) | (e << MNT_BITS) | (mnt & _MASK)
    out = torch.where(inf, (sign << 31) | (255 << MNT_BITS), out)
    out = torch.where(zero, sign << 31, out)
    return torch_float(out)


# =====================================================================
# Public registry
# =====================================================================

@dataclasses.dataclass(frozen=True)
class Multiplier:
    """A functional approximate-FP-multiplier model.

    ``np_mul(a, b)`` is the numpy "user C model" consumed by Algorithm 1;
    ``torch_mul(a, b)`` is its bitwise torch twin on float32 tensors (the
    ``direct`` mode); ``mantissa_bits`` is M, the number of significant
    mantissa bits of the format (Table II: FP32 -> 23, bfloat16-like -> 7).
    """

    name: str
    mantissa_bits: int
    np_mul: Callable
    torch_mul: Callable
    exact_family: bool = False  # mantissa product exact up to truncation?
    # The staged pipeline (fpstages.PipelineSpec) of a generated multiplier;
    # None for the hand-written zoo.
    pipeline: Any = None

    @property
    def operand_bits(self) -> tuple[int, int]:
        """(ma, mb) significant mantissa bits of operand A / B: the
        hand-written families are symmetric, a cross-format pipeline has
        one width an operand (the ``surrogate`` GEMM truncates each operand
        to its own)."""
        if self.pipeline is not None:
            return (self.pipeline.ma_bits, self.pipeline.mb_bits)
        return (self.mantissa_bits, self.mantissa_bits)

    def __call__(self, a, b):
        return self.np_mul(a, b)


_CORES = {
    "exact": partial(_core_exact, round_result=True),  # IEEE RNE == native
    "trunc": partial(_core_exact, round_result=False),
    "bf16": partial(_core_exact, round_result=True),
    "mitchell": _core_mitchell,
    "afm": _core_afm,
    "realm": _core_realm,
}
_TORCH_CORES = {
    "exact": partial(_torch_core_exact, round_result=True),
    "trunc": partial(_torch_core_exact, round_result=False),
    "bf16": partial(_torch_core_exact, round_result=True),
    "mitchell": _torch_core_mitchell,
    "afm": _torch_core_afm,
    "realm": _torch_core_realm,
}
_EXACT_FAMILY = {"exact", "trunc", "bf16"}


def make_multiplier(family: str, mantissa_bits: int = 23) -> Multiplier:
    """Build a multiplier model. ``family`` in {exact, trunc, bf16,
    mitchell, afm, realm}; ``mantissa_bits`` = M in [1, 23]."""
    if family not in _CORES:
        raise ValueError(f"unknown multiplier family {family!r}; have {sorted(_CORES)}")
    if not 1 <= mantissa_bits <= 23:
        raise ValueError(f"mantissa_bits must be in [1,23], got {mantissa_bits}")
    core, torch_core = _CORES[family], _TORCH_CORES[family]
    return Multiplier(
        name=f"{family}{mantissa_bits}",
        mantissa_bits=mantissa_bits,
        np_mul=lambda a, b: _full_multiply(core, a, b, mantissa_bits),
        torch_mul=lambda a, b: _torch_full_multiply(torch_core, a, b, mantissa_bits),
        exact_family=family in _EXACT_FAMILY,
    )


# Canonical instances used throughout the paper's experiments (Table II).
FP32 = make_multiplier("exact", 23)
BF16 = make_multiplier("bf16", 7)
AFM32 = make_multiplier("afm", 23)
AFM16 = make_multiplier("afm", 7)
MIT16 = make_multiplier("mitchell", 7)
REALM16 = make_multiplier("realm", 7)

REGISTRY = {m.name: m for m in [FP32, BF16, AFM32, AFM16, MIT16, REALM16]}
# Table II bit-width aliases: "<name>16" = (1,8,7) format (M=7),
# "<name>32" = (1,8,23).  Distinct from the '<family><M>' scheme that
# get_multiplier falls back to.
REGISTRY.update({
    "fp32": FP32,
    "bf16": BF16,
    "afm32": AFM32,
    "afm16": AFM16,
    "mit16": MIT16,
    "mitchell16": MIT16,
    "realm16": REALM16,
    "mit32": make_multiplier("mitchell", 23),
    "realm32": make_multiplier("realm", 23),
    "trunc16": make_multiplier("trunc", 7),
})

# Multipliers built at run time (cross-format pipelines, names added with
# register_multiplier), kept out of REGISTRY so the canonical zoo stays
# enumerable.  A lookup returns the same object every time, so the LUT
# caches, which key on the canonical name, hold one table a multiplier.
_DYNAMIC: dict[str, Multiplier] = {}

# '<fmt_a>x<fmt_b>[_trunc|_sr<seed>]': cross-format staged pipelines (exact
# core).  RNE is the default and canonical without a suffix ('fp16xbf16');
# '_rne' is accepted and normalised away.
_FMT = "|".join(sorted(FLOAT_FORMATS, key=len, reverse=True))
_CROSS_RE = re.compile(
    rf"^(?P<fa>{_FMT})x(?P<fb>{_FMT})(?:_(?P<rnd>rne|trunc|sr(?P<seed>\d+)))?$")


def register_multiplier(mult: Multiplier, *aliases: str) -> Multiplier:
    """Make ``mult`` resolvable by its name and ``aliases`` through
    ``get_multiplier`` (so in policy rules and the fault seam).
    Registering the same object again is a no-op; a name already taken by
    another model raises (the LUT caches key on names)."""
    for key in (mult.name, *aliases):
        existing = REGISTRY.get(key) or _DYNAMIC.get(key)
        if existing is not None and existing is not mult:
            raise ValueError(f"multiplier name {key!r} is already registered "
                             f"(to {existing.name!r})")
        _DYNAMIC[key] = mult
    return mult


def _parse_cross_format(name: str) -> Multiplier | None:
    m = _CROSS_RE.match(name)
    if not m:
        return None
    from . import fpstages

    rnd = m.group("rnd") or "rne"
    rounding = {"rne": "rne", "trunc": "truncate"}.get(rnd, "stochastic")
    suffix = "" if rounding == "rne" else f"_{rnd}"
    canonical = f"{m.group('fa')}x{m.group('fb')}{suffix}"
    if canonical not in _DYNAMIC:
        spec = fpstages.cross_format_spec(m.group("fa"), m.group("fb"), rounding=rounding,
                                          seed=int(m.group("seed") or 0))
        register_multiplier(fpstages.make_pipeline_multiplier(spec, name=canonical))
    mult = _DYNAMIC[canonical]
    if name != canonical:
        _DYNAMIC.setdefault(name, mult)
    return mult


def _unknown_multiplier_error(name: str) -> ValueError:
    candidates = sorted(set(REGISTRY) | set(_DYNAMIC)
                        | {f"{a}x{b}" for a in FLOAT_FORMATS for b in FLOAT_FORMATS}
                        | {f"{fam}7" for fam in _CORES})
    msg = (
        f"unknown multiplier {name!r}. Known names: {', '.join(sorted(REGISTRY))}. "
        f"Also parsed: '<family><M>' with family in {sorted(_CORES)}, and cross-format "
        f"'<fmt>x<fmt>[_trunc|_sr<seed>]' with fmt in {sorted(FLOAT_FORMATS)}."
    )
    close = difflib.get_close_matches(name, candidates, n=1, cutoff=0.6)
    if close:
        msg += f" Did you mean {close[0]!r}?"
    return ValueError(msg)


def get_multiplier(name: str) -> Multiplier:
    """Resolve a multiplier name: the canonical registry, the names built
    or registered at run time, '<family><M>' (e.g. 'afm7'), then the
    cross-format grammar '<fmt_a>x<fmt_b>[_trunc|_sr<seed>]' (e.g.
    'fp16xbf16').  Unknown names raise ValueError with the known names and
    a nearest-match hint."""
    if name in REGISTRY:
        return REGISTRY[name]
    if name in _DYNAMIC:
        return _DYNAMIC[name]
    for fam in _CORES:
        if name.startswith(fam):
            suffix = name[len(fam):]
            if suffix.isdigit():
                return make_multiplier(fam, int(suffix))
    cross = _parse_cross_format(name)
    if cross is not None:
        return cross
    raise _unknown_multiplier_error(name)
