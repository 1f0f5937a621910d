"""Numerics policies: the dispatch point for every multiplication.

The port of ``repro.core.policy``.  Every GEMM, conv and attention
contraction of a model carries a *site* label (its layer role: ``qkv``,
``wd``, ``conv``, ``attn_score``, ...), and the policy decides, per
``(site, op family, pass)``, which mode and multiplier that product runs
under.  Modes in the port:

  native       exact f32: ``torch.matmul`` and ``F.conv2d`` (TF32 off)
  surrogate    operands cut to the multiplier's mantissa widths (bf16
               rounded, everything else truncated), then the exact
               ``torch.matmul``: numerics-equal per product for the
               truncation family up to the final rounding, at native speed
  amsim        the hand-written CUDA LUT kernels (paper's ATxG)
  amsim_torch  the kernels' plain PyTorch versions (the twin of the JAX
               package's ``amsim_jnp``; the reference mode)
  direct       the multiplier model's own bit arithmetic
               (``Multiplier.torch_mul``) in a sequential-k GEMM; the
               path for M > 12, where there is no LUT (afm32)

Two policy forms, both frozen and hashable:

* :class:`NumericsPolicy`: one ``(mode, multiplier)`` everywhere, with the
  ``approx_attention`` / ``approx_backward`` switches as compiled-in
  default rules;
* :class:`PolicyTable`: :class:`PolicyRule` patterns over ``(site, family,
  pass)`` (None = wildcard), most specific wins; every query is resolved
  once when the table is built.

``resolve(site, family, pass_)`` on either returns the flat *leaf* policy
the ops consume.  Multiplier names take the full grammar of
``multipliers.get_multiplier``, cross-format pipelines included
(``fp16xbf16``: operand A is the format before the ``x``).  A table file
of the JAX package that names ``amsim_jnp`` loads with ``amsim_torch``,
its twin here.  Schema and precedence: docs/policies.md.
"""
from __future__ import annotations

import dataclasses
import json
import os

from .multipliers import get_multiplier

MODES = ("native", "surrogate", "amsim", "amsim_torch", "direct")
# The JAX package's pure-jnp reference mode, and its twin here.
_JAX_TWINS = {"amsim_jnp": "amsim_torch"}

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


def _check_mode_multiplier(mode: str, multiplier: str):
    if mode in _JAX_TWINS:
        raise ValueError(f"mode {mode!r} is the JAX package's; its twin here is "
                         f"{_JAX_TWINS[mode]!r} (modes: {MODES})")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if mode != "native":
        m = get_multiplier(multiplier)  # validates the name
        if mode == "surrogate" and not m.exact_family:
            raise ValueError(
                f"surrogate mode is only numerics-equivalent for the truncation family; "
                f"{m.name} is log-based: use amsim or direct")


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
        _check_mode_multiplier(self.mode, self.multiplier)

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

    def as_table(self) -> "PolicyTable":
        """The equivalent explicit :class:`PolicyTable`: the two switches
        become default rules, and ``resolve`` agrees cell for cell."""
        rules = [PolicyRule(self.mode, self.multiplier)]
        if not (self.approx_attention or self.is_native):
            rules.append(PolicyRule("native", self.multiplier, family="attention"))
        if not self.approx_backward:
            rules += [PolicyRule("native", self.multiplier, pass_="dx"),
                      PolicyRule("native", self.multiplier, pass_="dw")]
            if not (self.approx_attention or self.is_native):
                rules += [PolicyRule("native", self.multiplier, family="attention", pass_="dx"),
                          PolicyRule("native", self.multiplier, family="attention", pass_="dw")]
        return PolicyTable(tuple(rules))


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """One table rule: a ``(site, family, pass)`` pattern (None =
    wildcard) mapped to ``(mode, multiplier)``."""

    mode: str
    multiplier: str = "fp32"
    site: str | None = None
    family: str | None = None
    pass_: str | None = None

    def __post_init__(self):
        _check_mode_multiplier(self.mode, self.multiplier)
        if self.site is not None and self.site not in SITES:
            raise ValueError(f"unknown site {self.site!r}; registry: {SITES}")
        if self.family is not None and self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.pass_ is not None and self.pass_ not in PASSES:
            raise ValueError(f"unknown pass {self.pass_!r}")
        if (self.site is not None and self.family is not None
                and self.family != site_family(self.site)):
            raise ValueError(f"rule can never match: site {self.site!r} belongs to family "
                             f"{site_family(self.site)!r}, not {self.family!r}")

    @property
    def key(self):
        return (self.site, self.family, self.pass_)

    @property
    def specificity(self) -> int:
        """Site outweighs family outweighs pass; the score encodes which
        fields are set, so two rules that match one query never tie
        (duplicate patterns are refused by the table)."""
        return ((4 if self.site is not None else 0) + (2 if self.family is not None else 0)
                + (1 if self.pass_ is not None else 0))

    def matches(self, site, family, pass_) -> bool:
        return ((self.site is None or self.site == site)
                and (self.family is None or self.family == family)
                and (self.pass_ is None or self.pass_ == pass_))

    def leaf(self) -> NumericsPolicy:
        return NumericsPolicy(mode=self.mode, multiplier=self.multiplier)

    def describe(self) -> str:
        pat = ", ".join(f"{k}={v if v is not None else '*'}"
                        for k, v in zip(("site", "family", "pass"), self.key))
        tgt = self.mode if self.mode == "native" else f"{self.mode}/{self.multiplier}"
        return f"({pat}) -> {tgt}"


# Every query the models issue: each site's cells, and the unlabelled
# (site=None) cells of each family.  Coverage is checked against exactly
# these, and a table resolves each of them once, when it is built.
_ALL_QUERIES = tuple(
    [(s, site_family(s), p) for s in SITES for p in PASSES]
    + [(None, f, p) for f in FAMILIES for p in PASSES]
)


@dataclasses.dataclass(frozen=True)
class PolicyTable:
    """Per-site numerics: a most-specific-wins rule table.

    Construction validates every rule, refuses duplicate patterns (which
    would make resolution order-dependent) and requires every query of
    ``_ALL_QUERIES`` to match a rule (in practice, a wildcard default
    rule); then it resolves each of those queries into a dict, so
    ``resolve`` on the ops' hot path is a lookup.  Frozen and hashable,
    equal when the rules are: a table can key a cache like a flat policy.
    """

    rules: tuple[PolicyRule, ...]
    _leaves: dict = dataclasses.field(init=False, repr=False, compare=False, hash=False)

    def __post_init__(self):
        rules = tuple(self.rules)
        object.__setattr__(self, "rules", rules)
        if not rules:
            raise ValueError("PolicyTable needs at least one rule")
        seen = {}
        for r in rules:
            if not isinstance(r, PolicyRule):
                raise TypeError(f"rules must be PolicyRule, got {type(r)}")
            if r.key in seen:
                raise ValueError(f"conflicting rules for pattern {r.key}: "
                                 f"{seen[r.key].describe()} vs {r.describe()}")
            seen[r.key] = r
        uncovered = [q for q in _ALL_QUERIES if not any(r.matches(*q) for r in rules)]
        if uncovered:
            raise ValueError(f"table does not cover {len(uncovered)} cells, e.g. (site, family, "
                             f"pass)={uncovered[0]}; add a default wildcard rule "
                             f"(site=family=pass=None)")
        leaves, by_rule = {}, {}
        for q in _ALL_QUERIES:
            r = self._winner(*q)
            leaves[q] = by_rule.setdefault(r.key, r.leaf())
        object.__setattr__(self, "_leaves", leaves)

    def _winner(self, site, family, pass_) -> PolicyRule:
        return max((r for r in self.rules if r.matches(site, family, pass_)),
                   key=lambda r: r.specificity)

    def resolve(self, site: str | None = None, family: str | None = None,
                pass_: str = "fwd") -> NumericsPolicy:
        """The most specific matching rule's leaf: deterministic (no two
        matches tie) and total (coverage checked at construction)."""
        family = site_family(site) if family is None else family
        leaf = self._leaves.get((site, family, pass_))
        if leaf is not None:
            return leaf
        _check_query(site, family, pass_)
        return self._winner(site, family, pass_).leaf()

    def winning_rule(self, site=None, family=None, pass_="fwd") -> PolicyRule:
        """The rule ``resolve`` picks (for reports)."""
        family = site_family(site) if family is None else family
        _check_query(site, family, pass_)
        return self._winner(site, family, pass_)

    def to_json(self) -> dict:
        """JSON-able dict (docs/policies.md documents the schema)."""
        def rule_obj(r: PolicyRule):
            o = {"mode": r.mode}
            if r.mode != "native":
                o["multiplier"] = r.multiplier
            for k, v in zip(("site", "family", "pass"), r.key):
                if v is not None:
                    o[k] = v
            return o

        return {"version": 1, "rules": [rule_obj(r) for r in self.rules]}

    def describe(self) -> list[str]:
        """One line a rule, most specific first."""
        order = sorted(self.rules, key=lambda r: (-r.specificity, r.key[0] or "",
                                                  r.key[1] or "", r.key[2] or ""))
        return [r.describe() for r in order]


NATIVE = NumericsPolicy()

# Either policy form; every op takes both.
Numerics = NumericsPolicy | PolicyTable


def policy_from_flags(mode: str = "native", multiplier: str = "fp32", **kw) -> NumericsPolicy:
    return NumericsPolicy(mode=mode, multiplier=multiplier, **kw)


def as_table(numerics: Numerics) -> PolicyTable:
    """Either policy form as a :class:`PolicyTable`."""
    return numerics if isinstance(numerics, PolicyTable) else numerics.as_table()


# =====================================================================
# Table construction: JSON files and --assign shorthand
# =====================================================================

def _port_mode(mode: str) -> str:
    """A mode name of a JAX table file in this package (``amsim_jnp`` runs
    as ``amsim_torch``)."""
    return _JAX_TWINS.get(mode, mode)


def _rule_from_obj(obj: dict, where: str) -> PolicyRule:
    extra = set(obj) - {"mode", "multiplier", "site", "family", "pass"}
    if extra:
        raise ValueError(f"{where}: unknown rule keys {sorted(extra)}")
    if "mode" not in obj:
        raise ValueError(f"{where}: rule needs a 'mode'")
    return PolicyRule(mode=_port_mode(obj["mode"]), multiplier=obj.get("multiplier", "fp32"),
                      site=obj.get("site"), family=obj.get("family"), pass_=obj.get("pass"))


def table_from_json(src) -> PolicyTable:
    """A table from a JSON file path or an already-parsed dict::

        {"version": 1,
         "default": {"mode": "amsim", "multiplier": "afm10"},
         "rules": [{"site": "conv", "mode": "amsim", "multiplier": "mitchell8"},
                   {"pass": "dw", "mode": "native"}]}

    ``default`` is sugar for a full-wildcard rule.  ``amsim_jnp`` (the JAX
    package's reference mode) loads as ``amsim_torch``.
    """
    if not isinstance(src, dict):
        with open(src) as f:
            src = json.load(f)
    if not isinstance(src, dict):
        raise ValueError("policy-table JSON must be an object")
    if src.get("version", 1) != 1:
        raise ValueError(f"unsupported policy-table version {src.get('version')!r}")
    rules = []
    if "default" in src:
        d = dict(src["default"])
        for k in ("site", "family", "pass"):
            if d.get(k) is not None:
                raise ValueError("'default' must be a wildcard rule")
        rules.append(_rule_from_obj(d, "default"))
    for i, obj in enumerate(src.get("rules", [])):
        rules.append(_rule_from_obj(obj, f"rules[{i}]"))
    return PolicyTable(tuple(rules))


def _parse_target(value: str, default_mode: str) -> tuple[str, str]:
    """'native' | '<multiplier>' | '<mode>:<multiplier>' -> (mode, mult)."""
    if value == "native":
        return "native", "fp32"
    if ":" in value:
        mode, mult = value.split(":", 1)
        mode = _port_mode(mode)
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r} in assignment {value!r}")
        return mode, mult
    return default_mode, value


def table_from_assignments(spec: str, *, default: tuple[str, str] | None = None,
                           default_mode: str = "amsim") -> PolicyTable:
    """A table from CLI shorthand such as
    ``"qkv=mitchell8,attn_score=bf16,dw=native,default=afm16"``.

    Keys: a site, a family, a pass, ``default``, or ``<site-or-family>.<pass>``
    (``qkv.dw=native``).  Values: ``native``, a multiplier name (mode
    ``default_mode``: the CUDA kernels), or ``mode:multiplier``.  Without
    ``default=`` (or the ``default`` argument) unassigned sites run native.
    Site rules outrank pass rules: in ``"qkv=mitchell8,dw=native"`` the qkv
    site's dw pass runs mitchell8; ``qkv.dw=native`` pins it.
    """
    rules = []
    saw_default = False
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise ValueError(f"assignment {part!r} is not key=value")
        key, value = (s.strip() for s in part.split("=", 1))
        mode, mult = _parse_target(value, default_mode)
        if key == "default":
            rules.append(PolicyRule(mode, mult))
            saw_default = True
        elif "." in key:
            base, pas = key.split(".", 1)
            if pas not in PASSES:
                raise ValueError(f"unknown pass {pas!r} in key {key!r}; have {PASSES}")
            if base in SITES:
                rules.append(PolicyRule(mode, mult, site=base, pass_=pas))
            elif base in FAMILIES:
                rules.append(PolicyRule(mode, mult, family=base, pass_=pas))
            else:
                raise ValueError(f"unknown site/family {base!r} in key {key!r}")
        elif key in SITES:
            rules.append(PolicyRule(mode, mult, site=key))
        elif key in FAMILIES:
            rules.append(PolicyRule(mode, mult, family=key))
        elif key in PASSES:
            rules.append(PolicyRule(mode, mult, pass_=key))
        else:
            raise ValueError(f"unknown assignment key {key!r}: not a site {SITES}, family "
                             f"{FAMILIES}, pass {PASSES}, '<site>.<pass>', or 'default'")
    if not saw_default:
        rules.append(PolicyRule(*default) if default is not None else PolicyRule("native", "fp32"))
    return PolicyTable(tuple(rules))


def demote_numerics(numerics: Numerics) -> Numerics | None:
    """One rung down the degradation ladder: every approximate leaf steps
    toward exactness, an approximate multiplier to ``exact7`` in the same
    mode (still the LUT datapath, with an exact mantissa product) and
    ``exact7`` to ``native``; a table is demoted rule by rule.  None when
    nothing is left to demote, the ladder's "no safer rung" (a train step
    built on the result is a ``TrainerConfig.degrade_fn`` rung)."""
    def demote_leaf(mode: str, multiplier: str) -> tuple[str, str] | None:
        if NumericsPolicy(mode=mode, multiplier=multiplier).is_native:
            return None
        if multiplier != "exact7":
            return mode, "exact7"
        return "native", "fp32"

    if isinstance(numerics, NumericsPolicy):
        step = demote_leaf(numerics.mode, numerics.multiplier)
        if step is None:
            return None
        return dataclasses.replace(numerics, mode=step[0], multiplier=step[1])
    new_rules, changed = [], False
    for r in numerics.rules:
        step = demote_leaf(r.mode, r.multiplier)
        if step is None:
            new_rules.append(r)
        else:
            changed = True
            new_rules.append(dataclasses.replace(r, mode=step[0], multiplier=step[1]))
    return PolicyTable(tuple(new_rules)) if changed else None


def load_numerics(numerics: str, multiplier: str = "fp32", **kw) -> Numerics:
    """CLI helper: ``numerics`` is a mode name (a flat policy with
    ``multiplier``; ``native`` ignores it) or the path of a policy-table
    JSON file (a ``.json`` suffix or a path separator)."""
    if numerics.endswith(".json") or os.sep in numerics:
        return table_from_json(numerics)
    if numerics not in MODES:
        raise ValueError(f"--numerics must be one of {'|'.join(MODES)} or a policy-table JSON "
                         f"path (docs/policies.md); got {numerics!r}")
    if numerics == "native":
        return NumericsPolicy(**kw)
    return NumericsPolicy(mode=numerics, multiplier=multiplier, **kw)
