"""The port's per-site policy tables against the JAX package's.

``repro_torch.core.policy.PolicyTable`` mirrors ``tests/test_policy_table.py``:
construction-time validation, most-specific-wins resolution (equal to the
JAX table's cell for cell on the same rules), the assignment shorthand and
JSON (the JAX files, ``amsim_jnp`` loading as ``amsim_torch``), a uniform
table bitwise the flat policy through the GEMM, einsum, conv, attention
and decode-chain ops (forward and gradients), dx/dw splits, the expert
banks' dw leaf, the attention split guard, ``demote_numerics`` over
tables, and the table flags of ``launch.train`` and ``repro_torch.serve``.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the property form runs when hypothesis is installed
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:  # the seeded twin covers the law
    HAVE_HYPOTHESIS = False

from repro.core import policy as jpolicy  # noqa: E402
from repro_torch.configs.base import get_arch, reduced  # noqa: E402
from repro_torch.core.policy import (FAMILIES, PASSES, SITES, NumericsPolicy,  # noqa: E402
                                     PolicyRule, PolicyTable, as_table, demote_numerics,
                                     load_numerics, site_family, table_from_assignments,
                                     table_from_json)
from repro_torch.data.pipeline import lm_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import init_lm, lm_loss  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _bitwise(a, b):
    return torch.equal(a.detach().contiguous().view(torch.int32),
                       b.detach().contiguous().view(torch.int32))


def _t(rng, *shape, scale=1.0, grad=False):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)
                            ).requires_grad_(grad)


def _cells():
    for site in list(SITES) + [None]:
        for fam in ([site_family(site)] if site is not None else list(FAMILIES)):
            for pas in PASSES:
                yield site, fam, pas


# ================================================================ validation
def test_invalid_tables_raise_at_construction():
    with pytest.raises(ValueError, match="does not cover"):
        PolicyTable((PolicyRule("amsim", "mitchell8", site="conv"),))
    with pytest.raises(ValueError, match="surrogate"):
        PolicyRule("surrogate", "mitchell8", site="wd")
    with pytest.raises(ValueError, match="mode"):
        PolicyRule("quantum", "fp32")
    with pytest.raises(ValueError, match="multiplier"):
        PolicyRule("amsim", "notamult")
    with pytest.raises(ValueError, match="site"):
        PolicyRule("native", site="wx")
    with pytest.raises(ValueError, match="family"):
        PolicyRule("native", family="fft")
    with pytest.raises(ValueError, match="pass"):
        PolicyRule("native", pass_="sideways")
    with pytest.raises(ValueError, match="never match"):
        PolicyRule("native", site="conv", family="gemm")
    with pytest.raises(ValueError, match="conflicting"):
        PolicyTable((PolicyRule("amsim", "mitchell8"), PolicyRule("native")))
    with pytest.raises(ValueError, match="at least one rule"):
        PolicyTable(())
    with pytest.raises(TypeError, match="PolicyRule"):
        PolicyTable(("amsim",))


SPECS = ["conv=mitchell8,attn_score=bf16,dw=native,default=afm10",
         "qkv=mitchell8,qkv.dw=native,dw=native,default=amsim_torch:afm16",
         "attention.dx=native,wd=fp16xbf16,default=afm16",
         "qkv=mitchell8,attn_score=bf16,dw=native,default=afm16",
         "head=native,router=bf16,default=surrogate:trunc7"]


@pytest.mark.parametrize("spec", SPECS)
def test_resolution_equals_jax_cell_for_cell(spec):
    """The same shorthand gives the same leaf in both packages at every
    query (JAX's ``amsim_jnp`` is ``amsim_torch`` here)."""
    ours = table_from_assignments(spec)
    ref = jpolicy.table_from_assignments(spec.replace("amsim_torch", "amsim_jnp"))
    for site, fam, pas in _cells():
        a, b = ours.resolve(site, fam, pas), ref.resolve(site, fam, pas)
        assert (a.mode, a.multiplier) == ({"amsim_jnp": "amsim_torch"}.get(b.mode, b.mode),
                                          b.multiplier), (spec, site, fam, pas)
    assert ours.describe() == [line.replace("amsim_jnp", "amsim_torch")
                               for line in ref.describe()]


def test_assignment_and_json_round_trip(tmp_path):
    t = table_from_assignments(SPECS[0])
    assert t.resolve("conv").multiplier == "mitchell8"
    assert t.resolve("attn_score").multiplier == "bf16"
    assert t.resolve("wg", pass_="dw").mode == "native"
    assert t.resolve("wg").multiplier == "afm10"
    path = tmp_path / "table.json"
    path.write_text(json.dumps(t.to_json()))
    t2 = table_from_json(str(path))
    assert t2 == t and hash(t2) == hash(t)
    assert t.to_json() == jpolicy.table_from_assignments(SPECS[0]).to_json()
    assert isinstance(load_numerics("amsim_torch", "afm16"), NumericsPolicy)
    assert isinstance(load_numerics(str(path)), PolicyTable)
    with pytest.raises(ValueError, match="policy-table JSON path"):
        load_numerics("amsim_jnp")
    with pytest.raises(ValueError, match="unknown assignment key"):
        table_from_assignments("wx=bf16")
    with pytest.raises(ValueError, match="key=value"):
        table_from_assignments("conv")
    with pytest.raises(ValueError, match="unknown pass"):
        table_from_assignments("qkv.up=native")
    with pytest.raises(ValueError, match="unknown site/family"):
        table_from_assignments("wx.dw=native")
    with pytest.raises(ValueError, match="unknown rule keys"):
        table_from_json({"rules": [{"mode": "native", "where": "x"}]})
    with pytest.raises(ValueError, match="wildcard"):
        table_from_json({"default": {"mode": "native", "site": "qkv"}})
    with pytest.raises(ValueError, match="version"):
        table_from_json({"version": 2, "default": {"mode": "native"}})


def test_jax_table_files_load_unchanged(tmp_path):
    """The table of docs/policies.md, and a JAX file naming ``amsim_jnp``
    (loaded as ``amsim_torch``, its twin)."""
    doc = (REPO / "docs" / "policies.md").read_text()
    block = doc[doc.index("```json") + len("```json"):]
    src = json.loads(block[:block.index("```")])
    t = table_from_json(src)
    j = jpolicy.table_from_json(src)
    for site, fam, pas in _cells():
        a, b = t.resolve(site, fam, pas), j.resolve(site, fam, pas)
        assert (a.mode, a.multiplier) == (b.mode, b.multiplier)
    path = tmp_path / "jnp.json"
    path.write_text(json.dumps({"version": 1,
                                "default": {"mode": "amsim_jnp", "multiplier": "afm16"},
                                "rules": [{"site": "qkv", "mode": "amsim_jnp",
                                           "multiplier": "fp16xbf16"}]}))
    tj = load_numerics(str(path))
    assert tj.resolve("wg").mode == "amsim_torch"
    assert (tj.resolve("qkv").mode, tj.resolve("qkv").multiplier) == ("amsim_torch", "fp16xbf16")
    assert table_from_assignments("default=amsim_jnp:afm16").resolve("wd").mode == "amsim_torch"


def test_combined_site_pass_shorthand():
    t = table_from_assignments("qkv=mitchell8,dw=native,default=amsim_torch:afm16")
    assert t.resolve("qkv", pass_="dw").multiplier == "mitchell8"
    assert t.resolve("wd", pass_="dw").mode == "native"
    t2 = table_from_assignments("qkv=mitchell8,qkv.dw=native,dw=native,"
                                "default=amsim_torch:afm16")
    assert t2.resolve("qkv", pass_="dw").mode == "native"
    assert t2.resolve("qkv").multiplier == "mitchell8"
    t3 = table_from_assignments("attention.dx=native,default=amsim_torch:afm16")
    assert t3.resolve("attn_score", pass_="dx").mode == "native"
    assert t3.resolve("attn_score").multiplier == "afm16"


# ================================================================ precedence
_MULTS = ("bf16", "mitchell8", "afm10", "exact7", "trunc7", "fp16xbf16")


def _random_table(rng) -> PolicyTable:
    rules = [PolicyRule("amsim_torch", "afm16")]
    seen = {(None, None, None)}
    for _ in range(int(rng.integers(0, 8))):
        site = rng.choice([None, *SITES])
        site = None if site is None else str(site)
        fam = site_family(site) if site is not None else \
            (None if rng.random() < 0.5 else str(rng.choice(FAMILIES)))
        if site is not None and rng.random() < 0.5:
            fam = None
        pas = None if rng.random() < 0.5 else str(rng.choice(PASSES))
        if (site, fam, pas) in seen:
            continue
        seen.add((site, fam, pas))
        rules.append(PolicyRule("amsim_torch", str(rng.choice(_MULTS)), site=site, family=fam,
                                pass_=pas))
    return PolicyTable(tuple(rules))


def _check_precedence_laws(table: PolicyTable):
    """Total, deterministic, most specific wins, site matches dominate, and
    the resolved dict equals the rule scan at every query."""
    for site, fam, pas in _cells():
        leaf = table.resolve(site, fam, pas)
        assert leaf is table.resolve(site, fam, pas)
        win = table.winning_rule(site, fam, pas)
        assert (leaf.mode, leaf.multiplier) == (win.mode, win.multiplier)
        matches = [r for r in table.rules if r.matches(site, fam, pas)]
        assert win in matches
        for r in matches:
            if r is not win:
                assert r.specificity < win.specificity
        if any(r.site is not None for r in matches):
            assert win.site is not None


def test_precedence_deterministic_total_seeded():
    rng = np.random.default_rng(0)
    for _ in range(50):
        _check_precedence_laws(_random_table(rng))


if HAVE_HYPOTHESIS:
    @settings(max_examples=25, deadline=None)
    @given(st.integers(0, 2**32 - 1))
    def test_precedence_deterministic_total_property(seed):
        _check_precedence_laws(_random_table(np.random.default_rng(seed)))


def test_specificity_ordering_site_over_family_over_pass():
    t = PolicyTable((
        PolicyRule("amsim_torch", "afm16"),
        PolicyRule("amsim_torch", "bf16", pass_="dw"),
        PolicyRule("amsim_torch", "mitchell8", family="attention"),
        PolicyRule("amsim_torch", "exact7", site="attn_score"),
        PolicyRule("native", site="attn_score", pass_="dw"),
    ))
    assert t.resolve("wg").multiplier == "afm16"
    assert t.resolve("wg", pass_="dw").multiplier == "bf16"
    assert t.resolve("attn_value").multiplier == "mitchell8"
    assert t.resolve("attn_score").multiplier == "exact7"
    assert t.resolve("attn_score", pass_="dw").mode == "native"
    assert t.resolve("attn_value", pass_="dw").multiplier == "mitchell8"


@pytest.mark.parametrize("aa", [True, False])
@pytest.mark.parametrize("ab", [True, False])
def test_flat_policy_flags_equal_compiled_in_rules(aa, ab):
    flat = NumericsPolicy("amsim_torch", "afm16", aa, ab)
    table = as_table(flat)
    assert as_table(table) is table
    for site in list(SITES) + [None]:
        for p in PASSES:
            lf, lt = flat.resolve(site, pass_=p), table.resolve(site, pass_=p)
            assert (lf.mode, lf.multiplier) == (lt.mode, lt.multiplier), (site, p)


def test_tables_are_hashable_and_resolve_once():
    t1 = table_from_assignments("conv=mitchell8,default=afm10")
    t2 = table_from_assignments("conv=mitchell8,default=afm10")
    assert hash(t1) == hash(t2) and t1 == t2 and {t1: 1}[t2] == 1
    assert t1 != table_from_assignments("conv=mitchell8,default=afm16")
    assert t1.resolve("wg").mantissa_bits == 10
    # every query was resolved at construction: a dict lookup, one leaf a rule
    assert t1.resolve("wg") is t1.resolve("wd", pass_="dx")
    assert t1.resolve("conv") is not t1.resolve("wg")


# ============================================ uniform table == flat policy
def _uniform(mode, mult):
    return PolicyTable((PolicyRule(mode, mult),))


@pytest.mark.parametrize("mult", ["exact7", "mitchell8", "fp16xbf16"])
@pytest.mark.parametrize("mode", ["amsim", "amsim_torch"])
def test_uniform_table_bit_identical_gemm(mode, mult, rng):
    flat, uni = NumericsPolicy(mode=mode, multiplier=mult), _uniform(mode, mult)
    a = _t(rng, 3, 8, 24)
    w1 = _t(rng, 24, 16, scale=0.1, grad=True)
    w2 = w1.detach().clone().requires_grad_()
    yf, yu = ops.policy_matmul(a, w1, flat), ops.policy_matmul(a, w2, uni, "wg")
    assert _bitwise(yf, yu)
    gf = torch.autograd.grad((yf ** 2).sum(), w1)[0]
    gu = torch.autograd.grad((yu ** 2).sum(), w2)[0]
    assert _bitwise(gf, gu)
    e, b = _t(rng, 3, 8, 16), _t(rng, 3, 16, 4)
    assert _bitwise(ops.policy_einsum("bmk,bkn->bmn", e, b, flat),
                    ops.policy_einsum("bmk,bkn->bmn", e, b, uni, "ssm"))


@pytest.mark.parametrize("mult", ["exact7", "mitchell8", "fp16xbf16"])
def test_uniform_table_bit_identical_conv(mult, rng):
    flat, uni = NumericsPolicy(mode="amsim", multiplier=mult), _uniform("amsim", mult)
    x, w = _t(rng, 2, 6, 6, 4), _t(rng, 3, 3, 4, 8, scale=0.1)

    def grads(pol):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = ops.approx_conv2d(xs, ws, 1, "SAME", pol)
        return (y, *torch.autograd.grad((y ** 2).sum(), (xs, ws)))

    for a, b in zip(grads(flat), grads(uni)):
        assert _bitwise(a, b)


@pytest.mark.parametrize("mult", ["exact7", "mitchell8", "fp16xbf16"])
def test_uniform_table_bit_identical_attention(mult, rng):
    flat, uni = NumericsPolicy(mode="amsim", multiplier=mult), _uniform("amsim", mult)
    B, S, H, KV, dh = 2, 8, 4, 2, 16
    q, k, v = _t(rng, B, S, H, dh), _t(rng, B, S, KV, dh), _t(rng, B, S, KV, dh)
    pos = torch.arange(S, dtype=torch.int32)
    assert ops.fused_attention_enabled(uni)

    def grads(pol):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        y = ops.policy_attention(*ts, pos, pos, pol, True, 0)
        return (y, *torch.autograd.grad((y ** 2).sum(), ts))

    for a, b in zip(grads(flat), grads(uni)):
        assert _bitwise(a, b)
    assert _bitwise(
        ops.attend_einsum(q, k, v, pos, pos, NumericsPolicy("amsim_torch", mult), causal=True,
                          window=0),
        ops.attend_einsum(q, k, v, pos, pos, _uniform("amsim_torch", mult), causal=True,
                          window=0))


def test_uniform_table_lm_loss_and_gradients_bitwise_flat():
    """A whole reduced granite-3-2b loss and every gradient: the uniform
    table and the flat policy give the same bits."""
    cfg = reduced(get_arch("granite-3-2b"), n_layers=1)
    batch = lm_batch(cfg, (2, 8), 0)
    out = []
    for pol in (NumericsPolicy("amsim", "afm16"), _uniform("amsim", "afm16")):
        model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        loss, _ = lm_loss(model, batch, pol)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert _bitwise(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert _bitwise(a, b)


# ================================================================ splits
def test_dx_dw_split_resolution(rng):
    """dw=native: dW is the exact-backward one and dA the approximate one,
    and the other way round for dx=native."""
    a, w = _t(rng, 16, 32), _t(rng, 32, 8, scale=0.1)
    approx = NumericsPolicy(mode="amsim_torch", multiplier="mitchell8")
    exact_bwd = NumericsPolicy(mode="amsim_torch", multiplier="mitchell8", approx_backward=False)

    def grads(policy, site=None):
        at, wt = a.clone().requires_grad_(), w.clone().requires_grad_()
        y = ops.policy_matmul(at, wt, policy, site)
        return torch.autograd.grad((y ** 2).sum(), (at, wt))

    ga_app, gw_app = grads(approx)
    ga_eb, gw_eb = grads(exact_bwd)
    assert not _bitwise(gw_app, gw_eb) and not _bitwise(ga_app, ga_eb)
    ga, gw = grads(table_from_assignments("dw=native,default=amsim_torch:mitchell8"), "wg")
    assert _bitwise(gw, gw_eb) and _bitwise(ga, ga_app)
    ga, gw = grads(table_from_assignments("dx=native,default=amsim_torch:mitchell8"), "wg")
    assert _bitwise(ga, ga_eb) and _bitwise(gw, gw_app)


def test_stacked_expert_weights_resolve_dw(rng):
    x, bank = _t(rng, 2, 8, 16), _t(rng, 2, 16, 24, scale=0.1)

    def gw(policy, site=None):
        wt = bank.clone().requires_grad_()
        return torch.autograd.grad((ops.policy_matmul(x, wt, policy, site) ** 2).sum(), wt)[0]

    approx = NumericsPolicy(mode="amsim_torch", multiplier="mitchell8")
    exact_bwd = NumericsPolicy(mode="amsim_torch", multiplier="mitchell8", approx_backward=False)
    assert not _bitwise(gw(approx), gw(exact_bwd))
    assert _bitwise(gw(table_from_assignments("dw=native,default=amsim_torch:mitchell8"), "wg"),
                    gw(exact_bwd))
    assert _bitwise(gw(table_from_assignments("dx=native,default=amsim_torch:mitchell8"), "ssm"),
                    gw(exact_bwd))


def test_attention_site_split_forces_einsum(rng):
    """Score and value sites on different multipliers cannot share the
    one-table kernel: the guard refuses, and the einsum lowering runs each
    contraction under its own leaf."""
    t = table_from_assignments("attn_score=bf16,attn_value=mitchell8,default=amsim:mitchell8")
    assert not ops.fused_attention_enabled(t)
    assert ops.attention_fused_leaf(t) is None
    B, S, H, KV, dh = 1, 8, 2, 1, 16
    q, k, v = _t(rng, B, S, H, dh), _t(rng, B, S, KV, dh), _t(rng, B, S, KV, dh)
    pos = torch.arange(S, dtype=torch.int32)
    out = ops.attend_einsum(q, k, v, pos, pos, t, causal=True, window=0)
    qg = q.reshape(B, S, KV, H // KV, dh)
    sc = ops.policy_einsum("bqkgd,btkd->bkgqt", qg, k, NumericsPolicy("amsim", "bf16"))
    from repro_torch.kernels.approx_attention import softmax_scores
    from repro_torch.kernels.common import attention_mask
    probs = softmax_scores(sc, attention_mask(pos, pos, causal=True, window=0), dh)
    ref = ops.policy_einsum("bkgqt,btkd->bqkgd", probs, v, NumericsPolicy("amsim", "mitchell8"))
    assert _bitwise(out, ref.reshape(B, S, H, dh))


@pytest.mark.parametrize("spec,fused", [
    ("router=bf16,head=native,default=amsim:afm16", True),
    ("router=native,default=amsim_torch:fp16xbf16", True),
    ("wd=bf16,default=amsim:afm16", False),
    ("attn_value=mitchell8,default=amsim:afm16", False),
    ("default=surrogate:bf16", False),
])
def test_decode_chain_engages_as_the_table_dictates(spec, fused):
    """The chain needs one amsim/amsim_torch leaf over its sites (qkv, wo,
    wg, wu, wd, both attention sites); the router and head may differ."""
    assert ops.decode_chain_enabled(table_from_assignments(spec)) is fused


# ================================================================ ladder
@pytest.mark.parametrize("spec", ["qkv=mitchell8,dw=native,default=afm16",
                                  "default=fp16xbf16",
                                  "router=bf16,head=exact7,default=amsim_torch:afm16"])
def test_demote_numerics_over_tables_equals_jax(spec):
    """Rule by rule toward exactness, as JAX ``demote_numerics``, until
    nothing is left: None."""
    t, j = table_from_assignments(spec), jpolicy.table_from_assignments(
        spec.replace("amsim_torch", "amsim_jnp"))
    rungs = 0
    while t is not None:
        assert j is not None
        assert t.to_json() == json.loads(json.dumps(j.to_json()).replace("amsim_jnp",
                                                                         "amsim_torch"))
        t, j = demote_numerics(t), jpolicy.demote_numerics(j)
        rungs += 1
    assert j is None and rungs == 3


# ================================================================ CLIs
def test_train_cli_takes_a_table_and_an_assignment(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    common = ["--reduced", "--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "8"]
    launch_train.main(common + ["--numerics", "amsim", "--multiplier", "afm16",
                                "--assign", "qkv=mitchell8,attn_score=bf16,dw=native"])
    out = capsys.readouterr().out
    assert "numerics table (4 rules) on cpu" in out and "default fwd amsim/afm16" in out
    assert "  qkv: fwd amsim/mitchell8, dx amsim/mitchell8, dw amsim/mitchell8" in out
    assert "  wd:" not in out and "done at step 1" in out
    path = tmp_path / "t.json"
    path.write_text(json.dumps(table_from_assignments("default=fp16xbf16").to_json()))
    for flags in (["--numerics-table", str(path)], ["--numerics", str(path)]):
        launch_train.main(common + flags)
        assert "default fwd amsim/fp16xbf16" in capsys.readouterr().out


def test_serve_cli_takes_a_table(tmp_path, capsys):
    """A table path in ``--numerics``: tokens equal the flat policy's, and
    the chain report follows the table."""
    from repro_torch.serve.__main__ import main as serve
    common = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "4",
              "--new-tokens", "3", "--n-layers", "1"]
    serve(common + ["--numerics", "amsim", "--multiplier", "afm16"])
    flat = capsys.readouterr().out
    path = tmp_path / "uni.json"
    path.write_text(json.dumps({"version": 1,
                                "default": {"mode": "amsim", "multiplier": "afm16"}}))
    serve(common + ["--numerics", str(path)])
    uni = capsys.readouterr().out
    assert "decode chain: fused" in flat and "decode chain: fused" in uni
    assert [ln for ln in flat.splitlines() if "seq" in ln] == \
        [ln for ln in uni.splitlines() if "seq" in ln]
    path.write_text(json.dumps({"version": 1, "default": {"mode": "amsim", "multiplier": "afm16"},
                                "rules": [{"site": "wd", "mode": "amsim", "multiplier": "bf16"}]}))
    serve(common + ["--numerics", str(path)])
    assert "decode chain: per-op" in capsys.readouterr().out
