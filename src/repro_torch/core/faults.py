"""Hardware-fault injection for LUT multipliers: the port of
``repro.core.faults``.

What does an SEU bit flip or a stuck-at LUT cell do to training and
serving?  Every AMSim product reads a mantissa-product LUT, so a fault in
the multiplier array is a perturbation of that table: a numpy transform
applied at the one seam where the ops fetch a table (``kernels/ops.py``
``_amsim_lut`` / ``_oracle_lut``), and every kernel (GEMM, conv, dw,
attention, decode chain) and every plain version inherits it unchanged.

Fault models (seeded, reproducible, composable in a
:class:`FaultCampaign`):

``bitflip``   every (entry, bit) cell flips with probability ``rate``;
``stuck1``    seeded random cells forced to 1 (``rate``: expected share);
``stuck0``    the same, forced to 0;
``burst``     ``width`` rows (or columns) of the ``2^M x 2^M`` table with
              one bit position flipped in every entry.

Bit positions are significant-bit indices ``b in [0, M]`` (``b == M`` is
the carry), mapped onto both layouts (packed uint16 bit ``b``, canonical
uint32 bit ``23 - M + b``), so ``unpack_lut(faulted(packed)) ==
faulted(unpack_lut(packed))``.  The random draws come from
``np.random.default_rng([seed, crc32(multiplier name), M])``, so a spec
faults a table the same way in this package and in the JAX one.

The seam is off by default, and off it hands back the very table it was
given.  ``REPRO_FAULTS`` (a spec string) or :func:`set_active` /
:func:`inject` turn it on; the ops read the active spec at every table
fetch and key their table cache on it, so a changed spec takes effect at
the next op call and a faulted table goes to the card once.

Spec grammar (also the ``REPRO_FAULTS`` value)::

    kind[:key=value[,key=value...]]

    bitflip:rate=1e-4,seed=0
    stuck1:rate=1e-3,seed=7,mult=mitchell8
    burst:axis=row,width=2,bit=7,start=40
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import zlib

import numpy as np

from .float_bits import MNT_BITS

FAULT_KINDS = ("bitflip", "stuck0", "stuck1", "burst")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault model instance.  Frozen/hashable so it can key caches
    and ride in report JSON; ``rate`` is interpreted per kind (see
    module docstring).  ``mult`` restricts the spec to one multiplier's
    LUTs (None = every LUT the process touches)."""

    kind: str = "bitflip"
    rate: float = 0.0
    seed: int = 0
    mult: str | None = None
    # burst-only knobs:
    axis: str = "row"          # "row" (first operand) | "col"
    start: int | None = None   # band origin; None = seeded random
    width: int = 1             # band height/width in rows/cols
    bit: int | None = None     # significant-bit index; None = seeded random

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {FAULT_KINDS}")
        if self.kind != "burst" and not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.axis not in ("row", "col"):
            raise ValueError(f"axis must be 'row' or 'col', got {self.axis!r}")
        if self.width < 1:
            raise ValueError(f"width must be >= 1, got {self.width}")

    @property
    def is_noop(self) -> bool:
        """True when applying this spec can never change a table."""
        return self.kind != "burst" and self.rate == 0.0

    def describe(self) -> str:
        parts = [f"rate={self.rate:g}"] if self.kind != "burst" else \
            [f"axis={self.axis}", f"width={self.width}",
             f"start={'auto' if self.start is None else self.start}",
             f"bit={'auto' if self.bit is None else self.bit}"]
        parts.append(f"seed={self.seed}")
        if self.mult:
            parts.append(f"mult={self.mult}")
        return f"{self.kind}:" + ",".join(parts)

    def to_json(self) -> dict:
        d = {"kind": self.kind, "seed": self.seed}
        if self.kind == "burst":
            d.update(axis=self.axis, width=self.width)
            if self.start is not None:
                d["start"] = self.start
            if self.bit is not None:
                d["bit"] = self.bit
        else:
            d["rate"] = self.rate
        if self.mult:
            d["mult"] = self.mult
        return d


def parse_spec(text: str | FaultSpec) -> FaultSpec:
    """``"kind:key=val,..."`` -> :class:`FaultSpec` (the ``REPRO_FAULTS``
    grammar; passes an already-built spec through unchanged)."""
    if isinstance(text, FaultSpec):
        return text
    text = text.strip()
    if not text:
        raise ValueError("empty fault spec")
    kind, _, rest = text.partition(":")
    kw: dict = {}
    for part in filter(None, (p.strip() for p in rest.split(","))):
        if "=" not in part:
            raise ValueError(f"fault-spec field {part!r} is not key=value "
                             f"(spec {text!r})")
        key, val = (s.strip() for s in part.split("=", 1))
        if key == "rate":
            kw[key] = float(val)
        elif key in ("seed", "start", "width", "bit"):
            kw[key] = int(val)
        elif key in ("mult", "axis"):
            kw[key] = val
        else:
            raise ValueError(f"unknown fault-spec key {key!r} in {text!r}")
    return FaultSpec(kind=kind, **kw)


# =====================================================================
# Applying a spec to a LUT array
# =====================================================================

def _rng_for(spec: FaultSpec, mult: str | None, M: int) -> np.random.Generator:
    """Deterministic per (spec.seed, multiplier, M): two LUTs never share
    a fault pattern, but reruns reproduce it exactly."""
    name = (mult or "").encode()
    return np.random.default_rng([spec.seed, zlib.crc32(name), M])


def _cell_masks(spec: FaultSpec, n_entries: int, M: int,
                rng: np.random.Generator):
    """(entry indices, bit indices) of the faulted cells for the random
    models.  Cells are drawn with replacement (duplicates are rare at
    realistic rates; for flips they cancel pairwise, for stuck-ats they
    are idempotent), which keeps sampling O(k) even for M=12 tables."""
    nbits = M + 1
    k = int(rng.binomial(n_entries * nbits, spec.rate))
    if k == 0:
        return None, None
    cells = rng.integers(0, n_entries * nbits, size=k)
    return cells // nbits, cells % nbits


def apply_faults(lut: np.ndarray, M: int, spec: FaultSpec, *,
                 packed: bool, mult: str | None = None) -> np.ndarray:
    """Return ``lut`` with ``spec``'s faults applied (a copy — the input,
    typically the process-level LUT cache entry, is never mutated).

    ``packed`` selects the physical layout: uint16 ``(carry << M) |
    top-M mantissa`` vs canonical uint32 ``(carry << 23) | mantissa``.
    Significant-bit index ``b`` maps to physical bit ``b`` (packed) or
    ``MNT_BITS - M + b`` (canonical), so the same spec faults both
    layouts equivalently.
    """
    if spec.mult is not None and mult is not None and spec.mult != mult:
        return lut
    if spec.is_noop:
        return lut
    lut = np.asarray(lut)
    out = lut.copy()
    shift = 0 if packed else MNT_BITS - M
    dtype = out.dtype
    rng = _rng_for(spec, mult, M)

    if spec.kind == "burst":
        n = 1 << M
        if out.size != n * n:
            raise ValueError(f"burst fault expects a full 2^{2 * M}-entry "
                             f"LUT, got {out.size} entries")
        bit = spec.bit if spec.bit is not None else int(rng.integers(0, M + 1))
        if not 0 <= bit <= M:
            raise ValueError(f"bit must be in [0, {M}], got {bit}")
        start = (spec.start if spec.start is not None
                 else int(rng.integers(0, n)))
        rows = (np.arange(start, start + spec.width) % n)
        sq = out.reshape(n, n)
        mask = dtype.type(1 << (bit + shift))
        if spec.axis == "row":
            sq[rows, :] ^= mask
        else:
            sq[:, rows] ^= mask
        return out.reshape(lut.shape)

    entries, bits = _cell_masks(spec, out.size, M, rng)
    if entries is None:
        return lut  # zero faults drawn: bitwise-identical table
    flat = out.reshape(-1)
    masks = (np.uint64(1) << (bits + shift).astype(np.uint64)).astype(dtype)
    if spec.kind == "bitflip":
        np.bitwise_xor.at(flat, entries, masks)
    elif spec.kind == "stuck1":
        np.bitwise_or.at(flat, entries, masks)
    else:  # stuck0
        np.bitwise_and.at(flat, entries, ~masks)
    return out


# =====================================================================
# Process-level active spec (the kernels/ops.py seam reads this)
# =====================================================================

# Sentinel distinguishing "never set programmatically" (fall through to
# the env var) from "explicitly set to None" (faults forced off even if
# REPRO_FAULTS is exported).
_UNSET = object()
_active: FaultSpec | None | object = _UNSET
_env_cache: tuple[str, FaultSpec] | None = None


def active_spec() -> FaultSpec | None:
    """The spec the injection seam currently applies, or None (off).

    Programmatic state (:func:`set_active` / :func:`inject`) wins;
    otherwise ``REPRO_FAULTS`` is parsed (and cached per value).  The ops
    read it at every table fetch."""
    global _env_cache
    if _active is not _UNSET:
        return _active  # type: ignore[return-value]
    text = os.environ.get("REPRO_FAULTS", "").strip()
    if not text:
        return None
    if _env_cache is None or _env_cache[0] != text:
        _env_cache = (text, parse_spec(text))
    return _env_cache[1]


def set_active(spec: FaultSpec | str | None) -> None:
    """Set (or with None: force off) the process-wide fault spec,
    overriding ``REPRO_FAULTS``.  :func:`clear_active` restores env
    control."""
    global _active
    _active = None if spec is None else parse_spec(spec)


def clear_active() -> None:
    """Drop any programmatic spec; the seam falls back to REPRO_FAULTS."""
    global _active
    _active = _UNSET


@contextlib.contextmanager
def inject(spec: FaultSpec | str | None):
    """Context manager scoping a fault spec: every op called inside reads
    the faulted tables."""
    global _active
    prev = _active
    set_active(spec)
    try:
        yield active_spec()
    finally:
        _active = prev


def faulted_lut(lut: np.ndarray, M: int, *, packed: bool,
                mult: str | None = None) -> np.ndarray:
    """Apply the active spec to ``lut``, or, with no spec active (the
    common case), return ``lut`` itself: the same object, no copy."""
    spec = active_spec()
    if spec is None:
        return lut
    return apply_faults(lut, M, spec, packed=packed, mult=mult)


# =====================================================================
# Campaigns
# =====================================================================

@dataclasses.dataclass(frozen=True)
class FaultCampaign:
    """An ordered set of named fault points, the sweep axis of a
    resilience curve (``launch/faultsweep.py`` trains one point per spec
    and reports loss and accuracy against the fault rate)."""

    points: tuple[tuple[str, FaultSpec | None], ...]

    @staticmethod
    def from_rates(kind: str, rates, *, seed: int = 0,
                   mult: str | None = None) -> "FaultCampaign":
        """One point per rate; rate 0.0 becomes the fault-free baseline
        point (spec None, so the seam stays bitwise off)."""
        pts = []
        for r in rates:
            r = float(r)
            if r == 0.0:
                pts.append(("rate=0", None))
            else:
                pts.append((f"rate={r:g}",
                            FaultSpec(kind=kind, rate=r, seed=seed,
                                      mult=mult)))
        return FaultCampaign(tuple(pts))

    def __iter__(self):
        return iter(self.points)

    def __len__(self):
        return len(self.points)
