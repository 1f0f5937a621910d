"""Numerics policies: the dispatch point for every multiplication.

The flat form of ``repro.core.policy``: one ``(mode, multiplier)`` pair
for the whole model, resolved per ``(site, family, pass)`` by
:meth:`NumericsPolicy.resolve`, whose two legacy switches act as
compiled-in default rules.

Modes in the port:

  native       exact f32: ``torch.matmul`` and ``F.conv2d`` (TF32 off)
  amsim        the hand-written CUDA LUT kernels (paper's ATxG)
  amsim_torch  the kernels' plain PyTorch versions (the twin of the JAX
               package's ``amsim_jnp``; the reference mode)
  direct       the multiplier model's own bit arithmetic
               (``Multiplier.torch_mul``) in a sequential-k GEMM; the
               path for M > 12, where there is no LUT (afm32)

``surrogate`` and the per-site ``PolicyTable`` are not ported yet; asking
for them raises.
"""
from __future__ import annotations

import dataclasses

from .multipliers import get_multiplier

MODES = ("native", "amsim", "amsim_torch", "direct")
# Modes of the JAX package that later slices port.
_LATER_MODES = ("surrogate", "amsim_jnp")

FAMILIES = ("gemm", "conv", "attention")
PASSES = ("fwd", "dx", "dw")

# The site registry: every named multiply site in models/ (the JAX
# package's list, so labels carry over unchanged).
SITES = (
    "qkv",         # attention Q/K/V projections (column-parallel)
    "wo",          # attention output projection (row-parallel)
    "wg",          # FFN gate projection (column-parallel)
    "wu",          # FFN up projection (column-parallel)
    "wd",          # FFN down projection (row-parallel)
    "router",      # MoE router logits
    "head",        # LM / classifier head
    "unembed",     # tied LM head (embedding transpose)
    "dense",       # vision MLP hidden dense layers
    "ssm",         # Mamba2 projections + SSD einsums
    "conv",        # conv2d layers (family: conv)
    "attn_score",  # attention Q.K^T contraction (family: attention)
    "attn_value",  # attention probs.V contraction (family: attention)
)

_SITE_FAMILY = {"conv": "conv", "attn_score": "attention",
                "attn_value": "attention"}


def site_family(site: str | None) -> str:
    """The op family a site belongs to (``gemm`` unless conv/attention)."""
    return _SITE_FAMILY.get(site, "gemm")


def _check_query(site, family, pass_):
    if site is not None and site not in SITES:
        raise ValueError(f"unknown site {site!r}; registry: {SITES}")
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; have {FAMILIES}")
    if pass_ not in PASSES:
        raise ValueError(f"unknown pass {pass_!r}; have {PASSES}")


@dataclasses.dataclass(frozen=True)
class NumericsPolicy:
    """Flat numerics configuration: one (mode, multiplier) everywhere.

    Also the leaf type ``resolve`` returns: the object the kernels consume.
    """

    mode: str = "native"
    multiplier: str = "fp32"
    # Approximate the attention score/value contractions too.
    approx_attention: bool = True
    # Approximate the backward GEMMs (paper: yes, both phases).
    approx_backward: bool = True

    def __post_init__(self):
        if self.mode in _LATER_MODES:
            raise NotImplementedError(
                f"mode {self.mode!r} is not ported yet: it comes with the slice that "
                f"ports the rest of kernels/ops.py; the port has {MODES}")
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.mode != "native":
            get_multiplier(self.multiplier)  # validates the name

    @property
    def mantissa_bits(self) -> int:
        return get_multiplier(self.multiplier).mantissa_bits

    @property
    def is_native(self) -> bool:
        return self.mode == "native" or self.multiplier in ("fp32", "exact23")

    def resolve(self, site: str | None = None, family: str | None = None,
                pass_: str = "fwd") -> "NumericsPolicy":
        """Leaf numerics at ``(site, family, pass_)``: with
        ``approx_attention=False`` the attention family resolves native,
        with ``approx_backward=False`` the ``dx``/``dw`` passes do."""
        family = site_family(site) if family is None else family
        _check_query(site, family, pass_)
        leaf = self
        if family == "attention" and not (self.approx_attention
                                          or self.is_native):
            leaf = dataclasses.replace(leaf, mode="native")
        if pass_ != "fwd" and not self.approx_backward:
            leaf = dataclasses.replace(leaf, mode="native")
        return leaf


class PolicyTable:
    """Per-site, per-pass rule tables (``repro.core.policy.PolicyTable``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PolicyTable is not ported yet: it comes with the slice that ports "
            "the rest of kernels/ops.py; use the flat NumericsPolicy")


NATIVE = NumericsPolicy()


def demote_numerics(numerics: NumericsPolicy) -> NumericsPolicy | None:
    """One rung down the degradation ladder: an approximate multiplier
    becomes ``exact7`` in the same mode (still the LUT datapath, with an
    exact mantissa product), ``exact7`` becomes ``native``; a native
    policy gives None, the ladder's "no safer rung" (JAX
    ``demote_numerics`` for the flat policy; a train step built on the
    result is a ``TrainerConfig.degrade_fn`` rung)."""
    if numerics.is_native:
        return None
    if numerics.multiplier != "exact7":
        return dataclasses.replace(numerics, multiplier="exact7")
    return dataclasses.replace(numerics, mode="native", multiplier="fp32")


def load_numerics(numerics: str, multiplier: str = "fp32", **kw) -> NumericsPolicy:
    """CLI helper: a flat policy of mode ``numerics`` with ``multiplier``
    (``native`` ignores it).  A policy-table JSON path raises: tables are
    not ported yet."""
    if numerics.endswith(".json") or "/" in numerics:
        raise NotImplementedError("policy-table JSON files need PolicyTable, which is not "
                                  "ported yet; pass a mode name")
    if numerics == "native":
        return NumericsPolicy(**kw)
    return NumericsPolicy(mode=numerics, multiplier=multiplier, **kw)
