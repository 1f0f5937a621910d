"""Staged IEEE-754 multiplier pipelines -> bit-faithful LUTs (generator).

The port of ``repro.core.fpstages``: an approximate FP multiplier is a
composition of four stages (the classic FP-multiplier pipeline):

    DenormStage     operand special handling (flush-to-zero or gradual
                    underflow) and per-operand truncation to (ma, mb)
                    significant mantissa bits: what makes cross-format
                    multipliers (fp16 x bf16) expressible;
    MulCoreStage    the mantissa-product core: a raw fixed-point
                    partial-product core (``exact``, ``trunc_pp``) or a
                    log-domain core of the hand-written zoo (``mitchell``,
                    ``afm``, ``realm``);
    NormalizeStage  a raw Q2.(ma+mb) product to (significand, carry);
    RoundStage      rounding to ``out_bits``: RNE, truncation, or a
                    deterministic stochastic rounding seeded by a hash of
                    the operand mantissas.

``pipeline_lut`` evaluates a ``PipelineSpec`` over every mantissa pair into
the LUT layout every kernel reads (uint32 ``(carry << 23) |
mantissa_field``, packable to uint16), so a generated multiplier is only
another table: no kernel changes.  ``pipeline_multiply`` is the numpy
full-FP32 reference and ``torch_pipeline_multiply`` its bitwise torch twin
(int64 words; ``Multiplier.torch_mul`` of a generated multiplier, the
``direct`` mode).  In FTZ mode both match AMSim's special cases bit for
bit; gradual mode handles denormal operands and results, which the LUT
executor flushes (the documented divergence).

Cross-format tables are square at ``table_bits = max(ma, mb)``, the
narrower operand's extra truncation baked into the entries, so the operand
slots are positional: ``amsim[fa x fb](a, b) == amsim[fb x fa](b, a)``, and
a kernel must put the same operand in the A role as the reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .float_bits import (MNT_BITS, MNT_MASK, format_mantissa_bits, np_bits, np_float,
                         np_pack, torch_bits, torch_float)
from .multipliers import (_core_afm, _core_mitchell, _core_realm, _torch_core_afm,
                          _torch_core_mitchell, _torch_core_realm)

_U1 = np.uint64(1)

# Log-domain cores reused from the hand-written zoo.  They consume/produce
# 23-bit mantissa *fields* and return an already-normalised
# (mantissa_field, carry) pair — 2^carry * (1 + field/2^23) — so they skip
# NormalizeStage (a Mitchell-type antilog has no Q2.x product to shift).
_LOG_CORES = {
    "mitchell": _core_mitchell,
    "afm": _core_afm,
    "realm": _core_realm,
}
_RAW_CORES = ("exact", "trunc_pp")
CORE_KINDS = tuple(_RAW_CORES) + tuple(_LOG_CORES)
ROUND_MODES = ("rne", "truncate", "stochastic")
DENORM_MODES = ("ftz", "gradual")


# =====================================================================
# Stage specs (frozen, hashable — they key LUT caches via spec.name)
# =====================================================================

@dataclasses.dataclass(frozen=True)
class DenormStage:
    """Operand special handling.

    ``ftz``      denormal operands flush to zero, denormal results flush
                 to zero — the AMSim contract (Alg. 2 line 13).
    ``gradual``  denormal operands are normalised into an extended
                 (biased exponent <= 0) range, denormal results are
                 emitted; only representable by ``pipeline_multiply``,
                 never by the LUT executor (documented divergence).
    """

    mode: str = "ftz"

    def __post_init__(self):
        if self.mode not in DENORM_MODES:
            raise ValueError(
                f"denorm mode must be one of {DENORM_MODES}, got {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class MulCoreStage:
    """Mantissa-product core.

    ``exact``     full partial-product array: p = (1.fa)(1.fb), Q2.(ma+mb).
    ``trunc_pp``  broken-array truncated multiplier: the partial-product
                  bits in the ``drop_cols`` least-significant columns are
                  dropped (never formed, as in fixed-width array
                  multipliers); ``compensate`` adds the expected value of
                  the dropped columns (E[a_i * b_j] = 1/4) as a constant.
    ``mitchell`` / ``afm`` / ``realm``   the hand-written log cores.
    """

    kind: str = "exact"
    drop_cols: int = 0
    compensate: bool = False

    def __post_init__(self):
        if self.kind not in CORE_KINDS:
            raise ValueError(
                f"core kind must be one of {CORE_KINDS}, got {self.kind!r}")
        if self.kind != "trunc_pp" and (self.drop_cols or self.compensate):
            raise ValueError("drop_cols/compensate only apply to trunc_pp")
        if self.kind == "trunc_pp" and self.drop_cols < 0:
            raise ValueError(f"drop_cols must be >= 0, got {self.drop_cols}")

    @property
    def raw(self) -> bool:
        """True if the core emits a raw fixed-point product (needs
        NormalizeStage); False for log cores (already normalised)."""
        return self.kind in _RAW_CORES


@dataclasses.dataclass(frozen=True)
class NormalizeStage:
    """Raw product -> (significand, carry).  p in [2^f, 2^(f+2)) with
    f = ma+mb fraction bits; carry = 1 iff p >= 2^(f+1) (product >= 2.0).
    The significand is left in place — only the binary point moves — so
    normalisation is exact and RoundStage sees every product bit."""

    def carry_of(self, p: np.ndarray, frac_bits: int) -> np.ndarray:
        return (p >> np.uint64(frac_bits + 1)).astype(np.uint64)


@dataclasses.dataclass(frozen=True)
class RoundStage:
    """Final rounding of the normalised significand to ``out_bits``.

    ``rne``         round-to-nearest, ties-to-even.
    ``truncate``    chop (round toward zero) — what the hand-written
                    ``trunc``/log families do.
    ``stochastic``  deterministic stochastic rounding: the dither is a
                    splitmix64-style hash of (fa, fb, seed), so the same
                    operand pair always rounds the same way — LUTs stay
                    reproducible and CI-stable while the *population* of
                    roundings is unbiased.
    """

    mode: str = "rne"
    seed: int = 0

    def __post_init__(self):
        if self.mode not in ROUND_MODES:
            raise ValueError(
                f"round mode must be one of {ROUND_MODES}, got {self.mode!r}")
        if self.seed and self.mode != "stochastic":
            raise ValueError("seed only applies to stochastic rounding")

    def apply(self, sig, drop, fa, fb, out_bits):
        """Round ``sig`` (uint64, ``out_bits + drop`` fraction bits, per-
        element ``drop``) to ``out_bits``; returns (q, ovf) with q in
        [2^out, 2^(out+1)) after renormalising q == 2^(out+1) -> ovf=1."""
        sig = sig.astype(np.uint64)
        drop = drop.astype(np.uint64)
        safe = np.maximum(drop, _U1)  # avoid 1 << (0-1) lanes; masked below
        if self.mode == "truncate":
            q = sig >> drop
        elif self.mode == "rne":
            half = _U1 << (safe - _U1)
            lsb = (sig >> safe) & _U1
            q = (sig + half - _U1 + lsb) >> safe
            q = np.where(drop == 0, sig, q)
        else:  # stochastic
            dither = _sr_hash(fa, fb, self.seed) & ((_U1 << safe) - _U1)
            q = (sig + dither) >> safe
            q = np.where(drop == 0, sig, q)
        ovf = (q >> np.uint64(out_bits + 1)).astype(np.uint64)
        q = np.where(ovf > 0, q >> _U1, q)
        return q, ovf


def _sr_hash(fa, fb, seed: int):
    """Deterministic 64-bit mix of the truncated operand fractions."""
    with np.errstate(over="ignore"):
        x = (
            (np.asarray(fa, np.uint64) << np.uint64(32))
            | np.asarray(fb, np.uint64)
        ) ^ np.uint64((seed * 0x9E3779B97F4A7C15) & 0xFFFF_FFFF_FFFF_FFFF)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


# =====================================================================
# PipelineSpec
# =====================================================================

@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """A complete staged multiplier: operand widths + the four stages.

    ``ma_bits`` / ``mb_bits``  significant mantissa bits of operand A / B
                               (the *formats*: bf16 -> 7, fp16 -> 10).
    ``out_bits``               result mantissa bits (<= 23); defaults to
                               ``max(ma_bits, mb_bits)`` so the emitted
                               LUT stays uint16-packable.
    """

    ma_bits: int
    mb_bits: int
    out_bits: int = 0  # 0 -> max(ma_bits, mb_bits), resolved in __post_init__
    denorm: DenormStage = DenormStage()
    core: MulCoreStage = MulCoreStage()
    normalize: NormalizeStage = NormalizeStage()
    round: RoundStage = RoundStage()

    def __post_init__(self):
        if not 1 <= self.ma_bits <= MNT_BITS:
            raise ValueError(f"ma_bits must be in [1,23], got {self.ma_bits}")
        if not 1 <= self.mb_bits <= MNT_BITS:
            raise ValueError(f"mb_bits must be in [1,23], got {self.mb_bits}")
        if self.out_bits == 0:
            object.__setattr__(self, "out_bits", max(self.ma_bits, self.mb_bits))
        if not 1 <= self.out_bits <= MNT_BITS:
            raise ValueError(f"out_bits must be in [1,23], got {self.out_bits}")
        if self.core.kind == "trunc_pp" and self.core.drop_cols > min(
                self.ma_bits, self.mb_bits):
            # Keeps every dropped partial-product bit uniform (the leading
            # always-1 bits never participate) and guarantees the
            # truncated product cannot drop below 1.0.
            raise ValueError(
                f"trunc_pp drop_cols ({self.core.drop_cols}) must be <= "
                f"min(ma_bits, mb_bits) = {min(self.ma_bits, self.mb_bits)}")

    @property
    def table_bits(self) -> int:
        """M of the (square) LUT this pipeline tabulates to."""
        return max(self.ma_bits, self.mb_bits)

    @property
    def symmetric(self) -> bool:
        return self.ma_bits == self.mb_bits

    @property
    def name(self) -> str:
        """Deterministic spec-derived name (keys LUT disk/process caches)."""
        c = self.core
        core = (f"tpp{c.drop_cols}{'c' if c.compensate else ''}"
                if c.kind == "trunc_pp" else c.kind)
        rnd = {"rne": "rne", "truncate": "tr",
               "stochastic": f"sr{self.round.seed}"}[self.round.mode]
        grad = "_grad" if self.denorm.mode == "gradual" else ""
        return (f"p{self.ma_bits}x{self.mb_bits}o{self.out_bits}"
                f"_{core}_{rnd}{grad}")

    def mirrored(self) -> "PipelineSpec":
        """The operand-swapped pipeline (for the mirror law)."""
        return dataclasses.replace(self, ma_bits=self.mb_bits,
                                   mb_bits=self.ma_bits)


def cross_format_spec(fmt_a: str, fmt_b: str, rounding: str = "rne",
                      seed: int = 0, denorm: str = "ftz",
                      out_bits: int = 0) -> PipelineSpec:
    """Spec for an exact-core cross-format multiplier, e.g. fp16 x bf16.

    Models an MXU-style unit that takes an ``fmt_a`` activation and an
    ``fmt_b`` weight, forms the exact product of the truncated
    significands, and rounds to ``out_bits`` (default: the wider format).
    """
    return PipelineSpec(
        ma_bits=format_mantissa_bits(fmt_a),
        mb_bits=format_mantissa_bits(fmt_b),
        out_bits=out_bits,
        denorm=DenormStage(denorm),
        core=MulCoreStage("exact"),
        round=RoundStage(rounding, seed=seed if rounding == "stochastic" else 0),
    )


# =====================================================================
# Staged evaluation
# =====================================================================

def pipeline_mantissa_product(spec: PipelineSpec, fa, fb):
    """Run core -> normalize -> round on operand mantissa *fractions*.

    ``fa`` / ``fb``: uint arrays of top-aligned truncated fractions, i.e.
    integers in [0, 2^ma_bits) / [0, 2^mb_bits) — operand significands
    are (1 + fa/2^ma_bits).  Returns ``(mnt_field, carry)``: the 23-bit
    result mantissa field (top ``out_bits`` significant) and the uint32
    carry (validated <= 1 by the LUT emitters).
    """
    fa = np.asarray(fa, np.uint64)
    fb = np.asarray(fb, np.uint64)
    ma, mb, out = spec.ma_bits, spec.mb_bits, spec.out_bits
    core = spec.core
    if core.raw:
        sa = fa + (_U1 << np.uint64(ma))
        sb = fb + (_U1 << np.uint64(mb))
        p = sa * sb  # Q2.(ma+mb), in [2^(ma+mb), 2^(ma+mb+2))
        frac = ma + mb
        if core.kind == "trunc_pp" and core.drop_cols:
            p = p - _dropped_columns(sa, sb, core.drop_cols)
            if core.compensate:
                p = p + np.uint64(_pp_compensation(core.drop_cols))
                p = np.minimum(p, (_U1 << np.uint64(frac + 2)) - _U1)
        if out > frac:  # widen so the round stage only ever shifts right
            p = p << np.uint64(out - frac)
            frac = out
        carry = spec.normalize.carry_of(p, frac)
        drop = np.uint64(frac - out) + carry
        sig = p
    else:
        # Log cores speak 23-bit mantissa fields; feed the truncated
        # fractions top-aligned and let the core run at full precision —
        # RoundStage then reduces to out_bits (M=23 disables the core's
        # internal result masking).
        f23a = (fa << np.uint64(MNT_BITS - ma)).astype(np.uint32)
        f23b = (fb << np.uint64(MNT_BITS - mb)).astype(np.uint32)
        mnt23, carry = _LOG_CORES[core.kind](f23a, f23b, MNT_BITS)
        sig = mnt23.astype(np.uint64) | (_U1 << np.uint64(MNT_BITS))
        carry = carry.astype(np.uint64)
        drop = np.broadcast_to(np.uint64(MNT_BITS - out), sig.shape)
    q, ovf = spec.round.apply(sig, drop, fa, fb, out)
    carry = (carry + ovf).astype(np.uint32)
    mnt_field = ((q.astype(np.uint32) & np.uint32((1 << out) - 1))
                 << np.uint32(MNT_BITS - out))
    return mnt_field, carry


def _dropped_columns(sa, sb, drop_cols: int):
    """Sum of the partial-product bits in columns < drop_cols (the bits a
    broken-array multiplier never forms): sum a_i * b_j * 2^(i+j)."""
    dropped = np.zeros_like(sa)
    for c in range(drop_cols):
        col = np.uint64(0)
        for i in range(c + 1):
            col = col + (((sa >> np.uint64(i)) & _U1)
                         * ((sb >> np.uint64(c - i)) & _U1))
        dropped = dropped + (col << np.uint64(c))
    return dropped


def _pp_compensation(drop_cols: int) -> int:
    """E[dropped columns] over uniform mantissa bits: each dropped
    partial-product bit a_i*b_j has expectation 1/4 (drop_cols <=
    min(ma, mb) keeps the always-1 leading bits out of the dropped
    region), and column c holds c+1 such bits."""
    total4 = sum((c + 1) << c for c in range(drop_cols))  # 4*E in units of 1
    return (total4 + 2) // 4


def pipeline_lut(spec: PipelineSpec) -> np.ndarray:
    """Exhaustively evaluate the staged pipeline into a LUT.

    Returns the canonical uint32 layout of ``lutgen.generate_lut``:
    ``lut[ia * 2^M + ib] = (carry << 23) | mantissa_field`` with
    ``M = spec.table_bits`` — index A is the *first* operand (format
    ``ma_bits``): cross-format tables are positional.
    """
    M = spec.table_bits
    if not 1 <= M <= 12:
        raise ValueError(f"LUT mantissa bits must be in [1,12], got {M}")
    n = 1 << M
    ia, ib = np.meshgrid(np.arange(n, dtype=np.uint64),
                         np.arange(n, dtype=np.uint64), indexing="ij")
    # The table index carries the top-M mantissa bits; each operand is
    # further truncated to its own format width (DenormStage truncation).
    fa = ia >> np.uint64(M - spec.ma_bits)
    fb = ib >> np.uint64(M - spec.mb_bits)
    mnt, carry = pipeline_mantissa_product(spec, fa, fb)
    if carry.max(initial=0) > 1:
        raise ValueError(
            f"pipeline {spec.name!r} produced carry={int(carry.max())} "
            "(mantissa product >= 4.0): not representable in the "
            "(carry << 23) LUT layout — lower out_bits or disable "
            "compensation/rounding that saturates the significand")
    return ((carry << np.uint32(MNT_BITS)) | mnt).reshape(-1)


# =====================================================================
# Full-FP staged reference (the numpy oracle)
# =====================================================================

def pipeline_multiply(spec: PipelineSpec, a, b) -> np.ndarray:
    """Numpy staged reference multiply: full FP32 in/out.

    FTZ mode matches AMSim's specials bit-for-bit (the underflow check
    uses the *pre-carry* exponent, Alg. 2 line 13); gradual mode extends
    the model with denormal inputs and outputs (LUT executors cannot
    represent this — conformance tests pin the divergence).  Exponent
    fields of 255 (inf/NaN) are treated as huge exponents (-> inf), the
    same contract as the hand-written models.
    """
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    a, b = np.broadcast_arrays(a, b)
    ua, ub = np_bits(a), np_bits(b)
    sign = ((ua ^ ub) >> np.uint32(31)).astype(np.uint32)
    gradual = spec.denorm.mode == "gradual"
    ea, fa, zero_a = _denorm_operand(ua, spec.ma_bits, gradual)
    eb, fb, zero_b = _denorm_operand(ub, spec.mb_bits, gradual)
    mnt, carry = pipeline_mantissa_product(spec, fa, fb)
    e_pre = ea + eb - 127
    e = e_pre + carry.astype(np.int64)
    zero = zero_a | zero_b
    if gradual:
        out = _pack_gradual(sign, e, mnt, spec.out_bits)
        inf = (e >= 255) & ~zero
    else:
        zero = zero | (e_pre <= 0)
        inf = (e >= 255) & ~zero
        out = np_pack(sign, np.clip(e, 0, 255).astype(np.uint32), mnt)
    out = np.where(inf, np_pack(sign, np.uint32(255), np.uint32(0)), out)
    out = np.where(zero, np_pack(sign, np.uint32(0), np.uint32(0)), out)
    return np_float(out)


def _denorm_operand(u, m_bits: int, gradual: bool):
    """DenormStage on one operand: returns (extended biased exponent
    int64, top-aligned truncated fraction uint64 in [0, 2^m_bits), and
    the flushed/zero mask)."""
    e = ((u >> np.uint32(MNT_BITS)) & np.uint32(0xFF)).astype(np.int64)
    f23 = (u & MNT_MASK).astype(np.uint64)
    is_den = (e == 0) & (f23 != 0)
    zero = (e == 0) & (f23 == 0)
    if gradual and bool(is_den.any()):
        # Normalise 0.f x 2^(1-127) into 1.f' x 2^(e_eff-127) with an
        # extended biased exponent e_eff = msb(f) - 22 <= 0.
        _, ex = np.frexp(f23.astype(np.float64))  # f = m * 2^ex, m in [.5,1)
        msb = np.maximum(ex - 1, 0).astype(np.int64)
        e_den = msb - (MNT_BITS - 1)
        f_den = (f23 << (np.uint64(MNT_BITS) - msb.astype(np.uint64))) \
            & np.uint64(MNT_MASK)
        e = np.where(is_den, e_den, e)
        f23 = np.where(is_den, f_den, f23)
    else:
        zero = zero | is_den  # ftz: denormal operands flush
    fa = f23 >> np.uint64(MNT_BITS - m_bits)
    return e, fa, zero


def _pack_gradual(sign, e, mnt, out_bits: int):
    """Pack a result whose biased exponent may be <= 0 as a denormal
    (gradual underflow, truncating the shifted-out bits)."""
    sig = mnt.astype(np.uint64) | (_U1 << np.uint64(MNT_BITS))
    shift = np.clip(1 - e, 0, MNT_BITS + 1).astype(np.uint64)
    den_f = (sig >> shift).astype(np.uint32) & MNT_MASK
    is_den = e <= 0
    e_out = np.where(is_den, 0, np.clip(e, 0, 255)).astype(np.uint32)
    f_out = np.where(is_den, den_f, mnt.astype(np.uint32))
    return np_pack(sign, e_out, f_out)


# =====================================================================
# The torch twin (int64 words holding unsigned values)
# =====================================================================

_TORCH_LOG_CORES = {
    "mitchell": _torch_core_mitchell,
    "afm": _torch_core_afm,
    "realm": _torch_core_realm,
}
_M64 = (1 << 64) - 1


def _s64(v: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    v &= _M64
    return v - (1 << 64) if v >= 1 << 63 else v


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 words holding uint64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _torch_sr_hash(fa, fb, seed: int) -> torch.Tensor:
    """``_sr_hash`` on int64 words: the products wrap modulo 2^64 as the
    numpy uint64 ones do, and the shifts are logical."""
    x = ((fa << 32) | fb) ^ _s64(seed * 0x9E3779B97F4A7C15)
    x = (x ^ _lsr(x, 30)) * _s64(0xBF58476D1CE4E5B9)
    x = (x ^ _lsr(x, 27)) * _s64(0x94D049BB133111EB)
    return x ^ _lsr(x, 31)


def _torch_round(rnd: RoundStage, sig, drop, fa, fb, out_bits: int):
    """``RoundStage.apply`` on int64 tensors; the significand stays below
    2^50, so only the stochastic hash needs 64-bit care."""
    safe = torch.clamp(drop, min=1)
    if rnd.mode == "truncate":
        q = sig >> drop
    elif rnd.mode == "rne":
        q = (sig + (torch.ones_like(safe) << (safe - 1)) - 1 + ((sig >> safe) & 1)) >> safe
        q = torch.where(drop == 0, sig, q)
    else:
        dither = _torch_sr_hash(fa, fb, rnd.seed) & ((torch.ones_like(safe) << safe) - 1)
        q = torch.where(drop == 0, sig, (sig + dither) >> safe)
    ovf = q >> (out_bits + 1)
    return torch.where(ovf > 0, q >> 1, q), ovf


def _torch_dropped_columns(sa, sb, drop_cols: int):
    dropped = torch.zeros_like(sa)
    for c in range(drop_cols):
        col = torch.zeros_like(sa)
        for i in range(c + 1):
            col = col + ((sa >> i) & 1) * ((sb >> (c - i)) & 1)
        dropped = dropped + (col << c)
    return dropped


def torch_pipeline_mantissa_product(spec: PipelineSpec, fa: torch.Tensor, fb: torch.Tensor):
    """``pipeline_mantissa_product`` on int64 tensors of truncated operand
    fractions; returns (23-bit mantissa field, carry), int64."""
    ma, mb, out = spec.ma_bits, spec.mb_bits, spec.out_bits
    core = spec.core
    fa, fb = torch.broadcast_tensors(fa, fb)
    if core.raw:
        sa, sb = fa + (1 << ma), fb + (1 << mb)
        p = sa * sb                      # < 2^48
        frac = ma + mb
        if core.kind == "trunc_pp" and core.drop_cols:
            p = p - _torch_dropped_columns(sa, sb, core.drop_cols)
            if core.compensate:
                p = torch.clamp(p + _pp_compensation(core.drop_cols), max=(1 << (frac + 2)) - 1)
        if out > frac:
            p = p << (out - frac)
            frac = out
        carry = p >> (frac + 1)
        drop = (frac - out) + carry
        sig = p
    else:
        mnt23, carry = _TORCH_LOG_CORES[core.kind](fa << (MNT_BITS - ma), fb << (MNT_BITS - mb),
                                                   MNT_BITS)
        sig = mnt23 | (1 << MNT_BITS)
        drop = torch.full_like(sig, MNT_BITS - out)
    q, ovf = _torch_round(spec.round, sig, drop, fa, fb, out)
    return (q & ((1 << out) - 1)) << (MNT_BITS - out), carry + ovf


def _torch_denorm_operand(u, m_bits: int, gradual: bool):
    e = (u >> MNT_BITS) & 0xFF
    f23 = u & int(MNT_MASK)
    is_den = (e == 0) & (f23 != 0)
    zero = (e == 0) & (f23 == 0)
    if gradual and bool(is_den.any()):
        _, ex = torch.frexp(f23.to(torch.float64))
        msb = torch.clamp(ex.to(torch.int64) - 1, min=0)
        e = torch.where(is_den, msb - (MNT_BITS - 1), e)
        f23 = torch.where(is_den, (f23 << (MNT_BITS - msb)) & int(MNT_MASK), f23)
    else:
        zero = zero | is_den
    return e, f23 >> (MNT_BITS - m_bits), zero


def torch_pipeline_multiply(spec: PipelineSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``pipeline_multiply`` on float32 tensors (broadcastable), bitwise."""
    ua, ub = torch.broadcast_tensors(torch_bits(a), torch_bits(b))
    sign = ((ua ^ ub) >> 31) & 1
    gradual = spec.denorm.mode == "gradual"
    ea, fa, zero_a = _torch_denorm_operand(ua, spec.ma_bits, gradual)
    eb, fb, zero_b = _torch_denorm_operand(ub, spec.mb_bits, gradual)
    mnt, carry = torch_pipeline_mantissa_product(spec, fa, fb)
    e_pre = ea + eb - 127
    e = e_pre + carry
    zero = zero_a | zero_b
    if gradual:
        sig = mnt | (1 << MNT_BITS)
        shift = torch.clamp(1 - e, 0, MNT_BITS + 1)
        is_den = e <= 0
        e_out = torch.where(is_den, torch.zeros_like(e), torch.clamp(e, 0, 255))
        f_out = torch.where(is_den, (sig >> shift) & int(MNT_MASK), mnt)
        out = (sign << 31) | (e_out << MNT_BITS) | f_out
    else:
        zero = zero | (e_pre <= 0)
        out = (sign << 31) | (torch.clamp(e, 0, 255) << MNT_BITS) | (mnt & int(MNT_MASK))
    inf = (e >= 255) & ~zero
    out = torch.where(inf, (sign << 31) | (255 << MNT_BITS), out)
    out = torch.where(zero, sign << 31, out)
    return torch_float(out)


# =====================================================================
# Multiplier construction
# =====================================================================

def make_pipeline_multiplier(spec: PipelineSpec, name: str | None = None):
    """Wrap a PipelineSpec as a registry-compatible ``Multiplier``:
    ``np_mul`` is the staged reference (what Algorithm 1 probes),
    ``torch_mul`` its int64 torch twin; ``mantissa_bits`` is the table M,
    so the kernels, the fault seam and the LUT caches treat a generated
    multiplier as a hand-written one."""
    from .multipliers import Multiplier

    return Multiplier(
        name=name or spec.name,
        mantissa_bits=spec.table_bits,
        np_mul=lambda a, b: pipeline_multiply(spec, a, b),
        torch_mul=lambda a, b: torch_pipeline_multiply(spec, a, b),
        exact_family=spec.core.kind == "exact",
        pipeline=spec,
    )
