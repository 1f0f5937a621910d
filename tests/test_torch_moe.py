"""The port's MoE serving slice against the JAX package's.

At the widths of ``reduced(get_arch("granite-moe-3b-a800m"))`` (d 128,
8 experts, top-2, expert d_ff 64), the same numpy inputs go through:
* the batched GEMM's plain version and JAX ``approx_gemm_batched`` at
  chunk=1 in interpret mode and the stacked numpy oracle (bitwise);
* the plain versions of the wo+norm and expert-bank kernels and the JAX
  kernels in interpret mode and per-op oracles under ``amsim_jnp``;
* ``moe_ffn``, with ample capacity and with drops, under native and
  amsim_torch (JAX: amsim_jnp): the same experts for every token;
* the whole slice at 2 layers, JAX parameters carried across by
  ``lm_params_from_jax``: prefill logits and greedy tokens through
  ``ServingEngine`` against the JAX engine.
The JAX chain kernels' tiling is pinned to its defaults with an empty
autotune cache, as ``tests/test_decode_chain.py`` pins it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch import nn  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core import lutgen as jlutgen  # noqa: E402
from repro.core.policy import NumericsPolicy as JaxPolicy  # noqa: E402
from repro.kernels import approx_gemm as japprox_gemm  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import decode_chain as jchain  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs.base import get_arch, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.core import lutgen  # noqa: E402
from repro_torch.core.amsim import np_amsim_multiply  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.kernels import approx_gemm, decode_chain, ops  # noqa: E402
from repro_torch.kernels.common import lut_tensor  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import Linear  # noqa: E402
from repro_torch.models.mlp import ffn  # noqa: E402
from repro_torch.models.transformer import lm_forward  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _own_lut_dir(tmp_path_factory):
    """The JAX package caches LUTs on disk through one fixed temporary name
    per table; give this module its own directory, so that it never writes
    the shared one while another test process reads it.  Pin the JAX
    chain's tiling to its defaults with an empty autotune cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DIR", str(tmp_path_factory.mktemp("luts")))
        mp.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path_factory.mktemp("tune") / "none.json"))
        jautotune.reload_cache()
        yield
    jautotune.reload_cache()


MULT = "afm16"
EPS = 1e-5
CFG = reduced(get_arch("granite-moe-3b-a800m"), n_layers=2)
JAX_CFG = jax_reduced(jax_get_arch("granite-moe-3b-a800m"), n_layers=2)
AMSIM_TORCH = NumericsPolicy(mode="amsim_torch", multiplier=MULT)
JAX_AMSIM = JaxPolicy(mode="amsim_jnp", multiplier=MULT)
POLICIES = {"native": (NumericsPolicy(), JaxPolicy()), "amsim_torch": (AMSIM_TORCH, JAX_AMSIM)}
# Every product meets the same LUT in both packages; the rmsnorm rsqrt,
# the silu and softmax exps and the norm, softmax and gate sums round
# differently in torch and XLA on the CPU, and a LUT product may carry such
# an ulp across a mantissa truncation step.  Observed at most 4.8e-7
# (wo+norm), 1.2e-7 (the expert banks), 2.4e-7 (moe_ffn, amsim) and 1.0e-6
# (native), 6.0e-8 (serving logits, amsim) and 6.0e-7 (native); the
# tolerance is atol=rtol=1e-5.
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _luts(name=MULT):
    """(canonical, packed) port LUTs, the JAX packed LUT, M."""
    M = lutgen.get_multiplier(name).mantissa_bits
    return (lut_tensor(lutgen.get_lut(name), "cpu"), lut_tensor(lutgen.get_packed_lut(name), "cpu"),
            jnp.asarray(jlutgen.get_packed_lut(name)), M)


def _r(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------- batched GEMM
def _np_stacked_oracle(a, b, table, M, packed):
    """Per-batch-element numpy AMSim GEMM folding k in order from +0.0."""
    acc = np.zeros((a.shape[0], a.shape[1], b.shape[2]), np.float32)
    for kk in range(a.shape[2]):
        acc = acc + np_amsim_multiply(a[:, :, kk, None], b[:, None, kk, :], table, M,
                                      packed=packed)
    return acc


@pytest.mark.parametrize("name,packed", [("afm16", True), ("afm16", False), ("afm10", True)])
@pytest.mark.parametrize("B,m,k,n", [(3, 33, 70, 17), (2, 1, 129, 5)])
def test_plain_batched_gemm_bitwise_vs_jax_chunk1_and_numpy(name, packed, B, m, k, n):
    rng = np.random.default_rng(B * 1000 + k)
    table = lutgen.get_packed_lut(name) if packed else lutgen.get_lut(name)
    M = lutgen.get_multiplier(name).mantissa_bits
    a, b = _r(rng, B, m, k), _r(rng, B, k, n)
    out = approx_gemm.approx_gemm_batched(*_t(a, b), lut_tensor(table, "cpu"), M).numpy()
    ref = japprox_gemm.approx_gemm_batched(*_j(a, b), jnp.asarray(table), M, bm=128, bn=128,
                                           bk=128, chunk=1, interpret=True)
    np.testing.assert_array_equal(out, np.asarray(ref))
    np.testing.assert_array_equal(out, _np_stacked_oracle(a, b, table, M, packed))


@pytest.mark.parametrize("sa,sb", [((4, 3, 5), (4, 5, 6)), ((2, 3, 4, 5), (2, 3, 5, 2)),
                                   ((3, 4, 5), (1, 5, 2))])
def test_batched_products_run_the_batched_kernel_under_amsim(sa, sb):
    """Equal (or broadcast) batch dims under ``amsim`` go through
    ``approx_gemm_batched`` (on the CPU its plain version): the same bits as
    ``amsim_torch``."""
    rng = np.random.default_rng(len(sa))
    a, b = _t(_r(rng, *sa), _r(rng, *sb))
    out = ops.policy_matmul(a, b, NumericsPolicy(mode="amsim", multiplier=MULT))
    assert torch.equal(out, ops.policy_matmul(a, b, AMSIM_TORCH))
    assert out.shape == torch.matmul(a, b).shape


def test_ffn_over_banks_is_one_batched_product_a_projection(monkeypatch):
    """``mlp.ffn`` on (E, C, d) with (E, d, F) banks reaches the equal-batch
    branch: three batched launches under ``amsim``."""
    rng = np.random.default_rng(3)
    E, C, d, F = 4, 8, 16, 12
    banks = nn.ModuleDict({n: Linear(w) for n, w in zip(
        ("wg", "wu", "wd"), _t(_r(rng, E, d, F), _r(rng, E, d, F), _r(rng, E, F, d)))})
    buf = torch.from_numpy(_r(rng, E, C, d))
    seen = []
    monkeypatch.setattr(ops, "approx_gemm_batched",
                        lambda *a: seen.append(tuple(a[0].shape)) or
                        approx_gemm.approx_gemm_batched(*a))
    out = ffn(banks, buf, NumericsPolicy(mode="amsim", multiplier=MULT))
    assert seen == [(E, C, d), (E, C, d), (E, C, F)]
    assert torch.equal(out, ffn(banks, buf, AMSIM_TORCH))


# ------------------------------------------------------------ chain kernels
def _chain_operands(seed):
    rng = np.random.default_rng(seed)
    d, K = CFG.d_model, CFG.n_heads * CFG.head_dim
    E, Fe, C = CFG.moe.n_experts, CFG.moe.d_ff, 8
    return dict(x=_r(rng, 2, d), attn=_r(rng, 2, K), g2=1 + _r(rng, d, scale=0.1),
                wo=_r(rng, K, d, scale=K ** -0.5), bo=_r(rng, d, scale=0.1),
                h=_r(rng, E, C, d), wg=_r(rng, E, d, Fe, scale=d ** -0.5),
                wu=_r(rng, E, d, Fe, scale=d ** -0.5), wd=_r(rng, E, Fe, d, scale=Fe ** -0.5))


@pytest.mark.parametrize("biases", [False, True])
def test_wo_norm_plain_matches_jax(biases):
    o = _chain_operands(0)
    lut, _, jlut, M = _luts()
    names = ("x", "attn", "g2", "wo")
    bo = o["bo"] if biases else None
    x1, h = decode_chain.fused_wo_norm_plain(*_t(*(o[n] for n in names)), lut, M, eps=EPS,
                                             bo=None if bo is None else torch.from_numpy(bo))
    jbo = None if bo is None else jnp.asarray(bo)
    oracle = jops.decode_wo_norm_oracle(*_j(*(o[n] for n in names)), jbo, JAX_AMSIM, EPS)
    fused = jchain.fused_wo_norm(*_j(*(o[n] for n in names)), jlut, M, eps=EPS, bo=jbo,
                                 interpret=True)
    for ref in (oracle, fused):
        np.testing.assert_allclose(x1.numpy(), np.asarray(ref[0]), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(ref[1]), **TOL)


def test_moe_ffn_plain_matches_jax():
    o = _chain_operands(1)
    lut, _, jlut, M = _luts()
    names = ("h", "wg", "wu", "wd")
    out = decode_chain.fused_moe_ffn_plain(*_t(*(o[n] for n in names)), lut, M)
    oracle = jops.decode_moe_ffn_oracle(*_j(*(o[n] for n in names)), JAX_AMSIM)
    fused = jchain.fused_moe_ffn(*_j(*(o[n] for n in names)), jlut, M, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(fused), **TOL)


def _dead_row(kind, rng, d):
    return {"zero": np.zeros(d, np.float32), "negative_zero": -np.zeros(d, np.float32),
            "subnormal": _r(rng, d, scale=1e-39)}[kind]


@pytest.mark.parametrize("kind", ["zero", "negative_zero", "subnormal"])
def test_dead_capacity_rows_give_positive_zero(kind):
    """A capacity row whose every element is +-0 or subnormal has only +-0
    AMSim products, whatever the weights (inf and NaN here, in an expert
    that holds only dead rows), so the expert FFN gives +0.0 there: exactly,
    sign bit clear, in the port's plain version and in the JAX kernel in
    interpret mode.  This is what lets the CUDA kernel write +0.0 over such
    a row without computing it.  The live rows agree at the file's TOL."""
    o = _chain_operands(3)
    rng = np.random.default_rng(4)
    E, C, d = o["h"].shape
    o["h"][1] = _dead_row(kind, rng, d)                  # expert 1: every row dead
    o["h"][0, 1:C:2] = _dead_row(kind, rng, d)           # expert 0: dead rows between live ones
    for n in ("wg", "wu", "wd"):
        o[n][1, ::3], o[n][1, 1::3], o[n][1, 2::3] = np.inf, np.nan, -np.inf
    dead = np.zeros((E, C), bool)
    dead[1], dead[0, 1::2] = True, True
    lut, _, jlut, M = _luts()
    names = ("h", "wg", "wu", "wd")
    out = decode_chain.fused_moe_ffn_plain(*_t(*(o[n] for n in names)), lut, M).numpy()
    fused = np.asarray(jchain.fused_moe_ffn(*_j(*(o[n] for n in names)), jlut, M,
                                            interpret=True))
    for got in (out, fused):
        assert not got[dead].view(np.int32).any()
        assert np.isfinite(got[~dead]).all()
    np.testing.assert_allclose(out[~dead], fused[~dead], **TOL)
    assert decode_chain.live_rows(torch.from_numpy(o["h"])).tolist() == \
        (C - dead.sum(axis=1)).tolist()


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors each wrapper runs its plain version; with the packed
    LUT it gives the canonical table's bits."""
    o = _chain_operands(2)
    lut, packed, _, M = _luts()
    wo_args = _t(*(o[n] for n in ("x", "attn", "g2", "wo")))
    bo = torch.from_numpy(o["bo"])
    for a, b in zip(decode_chain.fused_wo_norm(*wo_args, packed, M, eps=EPS, bo=bo),
                    decode_chain.fused_wo_norm_plain(*wo_args, lut, M, eps=EPS, bo=bo)):
        assert torch.equal(a, b)
    moe_args = _t(*(o[n] for n in ("h", "wg", "wu", "wd")))
    assert torch.equal(decode_chain.fused_moe_ffn(*moe_args, packed, M),
                       decode_chain.fused_moe_ffn_plain(*moe_args, lut, M))


@pytest.mark.parametrize("mode", ["amsim", "amsim_torch"])
def test_fused_expert_ffn_is_bitwise_the_batched_ffn(mode):
    """The expert-bank launch (its plain version on the CPU) and the
    per-op ``ffn`` over the banks (three batched products) give the same
    bits, so the route the capacity picks never changes a result."""
    o = _chain_operands(3)
    policy = NumericsPolicy(mode=mode, multiplier=MULT)
    h, wg, wu, wd = _t(*(o[n] for n in ("h", "wg", "wu", "wd")))
    banks = nn.ModuleDict({"wg": Linear(wg), "wu": Linear(wu), "wd": Linear(wd)})
    assert ops.decode_moe_ffn_enabled(policy, h.shape[1])
    assert torch.equal(ops.decode_moe_ffn(h, wg, wu, wd, policy), ffn(banks, h, policy))
    assert torch.equal(ops.decode_moe_ffn(h, wg, wu, wd, policy),
                       ops.decode_moe_ffn(h, wg, wu, wd, AMSIM_TORCH))


def test_moe_ffn_guard():
    amsim = NumericsPolicy(mode="amsim", multiplier=MULT)
    assert ops.decode_moe_ffn_enabled(amsim, ops.MOE_FFN_MAX_C)
    assert not ops.decode_moe_ffn_enabled(amsim, ops.MOE_FFN_MAX_C + 8)
    assert ops.decode_moe_ffn_enabled(AMSIM_TORCH, 8)
    for policy in (NumericsPolicy(), NumericsPolicy(mode="direct", multiplier=MULT),
                   NumericsPolicy(mode="amsim", multiplier="fp32")):
        assert not ops.decode_moe_ffn_enabled(policy, 8)
    # The router is no expert-bank site: native attention leaves the banks alone.
    assert ops.moe_ffn_leaf(NumericsPolicy(mode="amsim", multiplier=MULT,
                                           approx_attention=False)) is not None


# entry: (operand names, the port's entry, the port's oracle, JAX's oracle)
MOE_CHAIN_GRADS = {
    "wo_norm": (("x", "attn", "g2", "wo"),
                lambda pol, *t: ops.decode_wo_norm(*t, None, pol, EPS),
                lambda pol, *t: ops.decode_wo_norm_oracle(*t, None, pol, EPS),
                lambda *t: jops.decode_wo_norm_oracle(*t, None, JAX_AMSIM, EPS)),
    "wo_norm_biased": (("x", "attn", "g2", "wo", "bo"),
                       lambda pol, *t: ops.decode_wo_norm(*t, pol, EPS),
                       lambda pol, *t: ops.decode_wo_norm_oracle(*t, pol, EPS),
                       lambda *t: jops.decode_wo_norm_oracle(*t, JAX_AMSIM, EPS)),
    "moe_ffn": (("h", "wg", "wu", "wd"),
                lambda pol, *t: ops.decode_moe_ffn(*t, pol),
                lambda pol, *t: ops.decode_moe_ffn_oracle(*t, pol),
                lambda *t: (jops.decode_moe_ffn_oracle(*t, JAX_AMSIM),)),
}


@pytest.mark.parametrize("entry", sorted(MOE_CHAIN_GRADS))
def test_moe_chain_gradients_are_their_oracles(entry):
    """``decode_wo_norm`` and ``decode_moe_ffn`` recompute their oracles in
    the backward: under ``amsim`` (the plain versions here) every gradient
    is bitwise the oracle's under ``amsim_torch`` (the banks' db a batched
    product under the dw leaf), and within rtol 1e-4, atol 1e-5 of JAX's
    oracle VJP under ``amsim_jnp``."""
    names, port, oracle, jax_oracle = MOE_CHAIN_GRADS[entry]
    arrays = [_chain_operands(3)[n] for n in names]

    def grads(fn, policy):
        ts = [t.requires_grad_(True) for t in _t(*arrays)]
        out = fn(policy, *ts)
        outs = out if isinstance(out, tuple) else (out,)
        rng = np.random.default_rng(4)
        cot = [torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32)) for y in outs]
        return torch.autograd.grad(outs, ts, cot), cot

    got, cot = grads(port, NumericsPolicy(mode="amsim", multiplier=MULT))
    want, _ = grads(oracle, AMSIM_TORCH)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ref = jax.jit(lambda t, c: jax.vjp(jax_oracle, *t)[1](tuple(c)))(
        _j(*arrays), [jnp.asarray(c.numpy()) for c in cot])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ moe_ffn
def _port_moe(p):
    """The port's ``moe`` module dict from a JAX ``init_moe`` tree."""
    experts = {n: Linear(*_t(np.asarray(v["w"]))) for n, v in p["experts"].items()}
    return nn.ModuleDict({"router": Linear(*_t(np.asarray(p["router"]["w"]))),
                          "experts": nn.ModuleDict(experts)})


def _jax_route(p, xf, cfg, jpolicy):
    logits = jops.policy_matmul(xf, p["router"]["w"], jpolicy, "router")
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    return jax.lax.top_k(probs, cfg.moe.top_k)[1]


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("name", sorted(POLICIES))
@torch.no_grad()
def test_moe_ffn_matches_jax(name, cf):
    """64 tokens with ample capacity (cf 8: C = 64, no drops) and with drops
    (cf 0.5: C = 8 rows for 16 choices an expert on average): the same
    experts for every token, y and the aux loss within TOL."""
    policy, jpolicy = POLICIES[name]
    cfg = dataclasses.replace(CFG, moe=dataclasses.replace(CFG.moe, capacity_factor=cf))
    jcfg = dataclasses.replace(JAX_CFG, moe=dataclasses.replace(JAX_CFG.moe, capacity_factor=cf))
    p = jax.tree_util.tree_map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), jcfg))
    x = _r(np.random.default_rng(5), 4, 16, cfg.d_model)
    T = x.shape[0] * x.shape[1]
    pm = _port_moe(p)
    _, _, sel = moe.route(pm["router"], torch.from_numpy(x.reshape(T, -1)), cfg, policy)
    jsel = _jax_route(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x.reshape(T, -1)),
                      jcfg, jpolicy)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    load = np.bincount(sel.numpy().ravel(), minlength=cfg.moe.n_experts).max()
    assert (load > moe.capacity(cfg, T)) == (cf < 1)      # drops exactly when asked for
    y, aux = moe.moe_ffn(pm, torch.from_numpy(x), cfg, policy)
    jy, jaux = jmoe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jcfg, jpolicy)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)


# Tied router probabilities: 40 equal ones (granite-moe-3b-a800m's experts,
# top-8) and a row with three equal maxima (top-2).
TIES = [(np.full(40, 1 / 40, np.float32), 8),
        (np.array([0.1, 0.3, 0.3, 0.2, 0.3, 0.05], np.float32), 2)]


@pytest.mark.parametrize("case", range(len(TIES)))
@torch.no_grad()
def test_route_breaks_ties_like_jax_top_k(case):
    """Among equal probabilities the lower expert index comes first, as in
    ``jax.lax.top_k``; the gates follow the chosen order.  A router of one
    input holding log(probs) gives logits whose softmax keeps the ties."""
    probs, k = TIES[case]
    E = probs.shape[0]
    cfg = dataclasses.replace(CFG, moe=dataclasses.replace(CFG.moe, n_experts=E, top_k=k))
    router = Linear(torch.log(torch.from_numpy(probs))[None, :])
    got_probs, gate, sel = moe.route(router, torch.ones(2, 1), cfg, NumericsPolicy())
    jgate, jsel = jax.lax.top_k(jnp.asarray(got_probs.numpy()), k)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(
        gate.numpy(), np.asarray(jgate / jnp.sum(jgate, axis=-1, keepdims=True)))


@torch.no_grad()
def test_moe_ffn_matches_jax_with_a_tied_router():
    """Router weights of zero tie every probability: both packages send
    every token to experts 0 and 1 (the drops follow), y within TOL."""
    p = jax.tree_util.tree_map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(2), JAX_CFG))
    p["router"]["w"] = np.zeros_like(p["router"]["w"])
    x = _r(np.random.default_rng(7), 4, 16, CFG.d_model)
    T = x.shape[0] * x.shape[1]
    policy, jpolicy = POLICIES["native"]
    pm = _port_moe(p)
    _, _, sel = moe.route(pm["router"], torch.from_numpy(x.reshape(T, -1)), CFG, policy)
    jsel = _jax_route(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x.reshape(T, -1)),
                      JAX_CFG, jpolicy)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    assert (sel.numpy() == np.arange(CFG.moe.top_k)).all()
    y, _ = moe.moe_ffn(pm, torch.from_numpy(x), CFG, policy)
    jy, _ = jmoe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), JAX_CFG, jpolicy)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("cf", [8.0, 0.5])
@torch.no_grad()
def test_moe_ffn_amsim_is_bitwise_amsim_torch(cf):
    cfg = dataclasses.replace(CFG, moe=dataclasses.replace(CFG.moe, capacity_factor=cf))
    jcfg = dataclasses.replace(JAX_CFG, moe=dataclasses.replace(JAX_CFG.moe, capacity_factor=cf))
    pm = _port_moe(jax.tree_util.tree_map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(1), jcfg)))
    x = torch.from_numpy(_r(np.random.default_rng(6), 2, 6, cfg.d_model))
    y, aux = moe.moe_ffn(pm, x, cfg, NumericsPolicy(mode="amsim", multiplier=MULT))
    y_ref, aux_ref = moe.moe_ffn(pm, x, cfg, AMSIM_TORCH)
    assert torch.equal(y, y_ref) and torch.equal(aux, aux_ref)


@pytest.mark.parametrize("T,want", [(1, 8), (4, 8), (256, 64), (2048, 512), (10, 8)])
def test_capacity_is_the_jax_formula(T, want):
    full = get_arch("granite-moe-3b-a800m")
    assert moe.capacity(full, T) == want
    m = full.moe
    assert want == jmoe._round_up(max(int(T * m.top_k * m.capacity_factor / m.n_experts), 1), 8)


# --------------------------------------------------------------- the slice
N_NEW = 4


@pytest.fixture(scope="module")
def carried():
    params = jax.tree_util.tree_map(np.asarray, jtransformer.init_lm(jax.random.PRNGKey(0),
                                                                     JAX_CFG))
    prompts = np.random.default_rng(0).integers(0, CFG.vocab, (2, 5)).astype(np.int32)
    return params, lm_params_from_jax(params, CFG, device="cpu"), prompts


def _jax_generate(params, prompts, jpolicy, max_len):
    """Prefill + greedy decode steps of the JAX engine, keeping the
    logits that choose each token."""
    caches = jtransformer.init_lm_caches(JAX_CFG, prompts.shape[0], max_len)
    fwd = jax.jit(lambda p, t, c: jtransformer.lm_forward(p, t, JAX_CFG, jpolicy, caches=c))
    step = jax.jit(jengine.make_serve_step(JAX_CFG, jpolicy))
    logits, caches, _ = fwd(params, jnp.asarray(prompts), caches)
    nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    kept, toks = [np.asarray(logits[:, -1:])], [np.asarray(nxt)]
    for _ in range(N_NEW - 1):
        lg, nxt, caches = step(params, nxt, caches)
        kept.append(np.asarray(lg))
        toks.append(np.asarray(nxt))
    return np.concatenate(toks, 1), np.concatenate(kept, 1), np.asarray(logits)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_moe_serving_matches_jax(carried, name):
    """Prefill logits over the whole prompt, the logits of every decode
    step and the greedy tokens of reduced granite-moe-3b-a800m at 2
    layers, against the JAX engine (TOL above; the tokens are equal)."""
    params, model, prompts = carried
    policy, jpolicy = POLICIES[name]
    toks, logits, prefill = _jax_generate(params, prompts, jpolicy, 16)
    engine = ServingEngine(model, policy, max_len=16)
    out, kept = engine.generate(torch.from_numpy(prompts), N_NEW, return_logits=True)
    np.testing.assert_array_equal(out.numpy(), toks)
    np.testing.assert_allclose(kept.numpy(), logits, **TOL)
    full, _, _ = lm_forward(model, torch.from_numpy(prompts), policy)
    np.testing.assert_allclose(full.numpy(), prefill, **TOL)


def test_moe_amsim_serves_like_amsim_torch(carried, monkeypatch):
    """On the CPU the ``amsim`` kernels run their plain versions: the whole
    engine gives the same bits under both modes, through the expert-bank
    launch and (capacity bound 0) through the batched products."""
    _, model, prompts = carried
    for max_c in (ops.MOE_FFN_MAX_C, 0):
        monkeypatch.setattr(ops, "MOE_FFN_MAX_C", max_c)
        runs = [ServingEngine(model, NumericsPolicy(mode=mode, multiplier=MULT), max_len=16)
                .generate(torch.from_numpy(prompts), N_NEW, return_logits=True)
                for mode in ("amsim", "amsim_torch")]
        assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_moe_decode_goes_through_the_moe_chain(carried, monkeypatch):
    """A decode step under ``amsim`` runs qkv, wo+norm and the expert banks
    through the chain ops, one each a layer; the prefill runs the expert
    banks only."""
    _, model, prompts = carried
    calls = {}
    for name in ("decode_qkv", "decode_wo_norm", "decode_moe_ffn", "decode_out_mlp_b"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _fn(*a, **k))[1])
    ServingEngine(model, NumericsPolicy(mode="amsim", multiplier=MULT), max_len=16).generate(
        torch.from_numpy(prompts), N_NEW)
    L, steps = CFG.n_layers, N_NEW - 1
    assert calls == {"decode_qkv": L * steps, "decode_wo_norm": L * steps,
                     "decode_moe_ffn": L * (steps + 1)}


def test_lm_params_from_jax_carries_the_moe_tree(carried):
    params, model, _ = carried
    flat = dict(model.named_parameters())
    assert sum(p.numel() for p in flat.values()) == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(params))
    for i in range(CFG.n_layers):
        np.testing.assert_array_equal(flat[f"layers.{i}.moe.router.w"].detach().numpy(),
                                      params["layers"]["moe"]["router"]["w"][i])
        for name in ("wg", "wu", "wd"):
            np.testing.assert_array_equal(
                flat[f"layers.{i}.moe.experts.{name}.w"].detach().numpy(),
                params["layers"]["moe"]["experts"][name]["w"][i])
    bad = jax.tree_util.tree_map(lambda a: a, params)
    wd = bad["layers"]["moe"]["experts"]["wd"]
    wd["w"] = wd["w"][..., :-1]
    with pytest.raises(ValueError, match="shapes differ"):
        lm_params_from_jax(bad, CFG, device="cpu")


def test_moe_arch_configs_match_jax():
    full, jfull = get_arch("granite-moe-3b-a800m"), jax_get_arch("granite-moe-3b-a800m")
    for cfg, jcfg in ((full, jfull), (CFG, JAX_CFG)):
        for field in dataclasses.fields(cfg):
            if field.name != "moe":
                assert getattr(cfg, field.name) == getattr(jcfg, field.name), field.name
        for field in dataclasses.fields(cfg.moe):
            assert getattr(cfg.moe, field.name) == getattr(jcfg.moe, field.name), field.name
    assert full.d_model == 1536 and full.moe.n_experts == 40 and full.moe.top_k == 8


def test_later_moe_variants_are_refused():
    """(dense, MoE) pairs and shared experts are ported; an interleave of 3
    is not, and a depth that is not whole pairs raises."""
    from repro_torch.configs.base import MoEConfig
    MoEConfig(n_experts=8, top_k=2, d_ff=64, interleave=2, n_shared_experts=1)
    with pytest.raises(NotImplementedError, match="interleave=3"):
        MoEConfig(n_experts=8, top_k=2, d_ff=64, interleave=3)
    paired = dataclasses.replace(CFG.moe, interleave=2)
    with pytest.raises(ValueError, match="not a multiple"):
        dataclasses.replace(CFG, n_layers=3, moe=paired)


def test_serve_cli_runs_the_moe_arch_on_the_cpu(capsys):
    from repro_torch.serve.__main__ import main
    main(["--arch", "granite-moe-3b-a800m", "--reduced", "--device", "cpu", "--numerics",
          "amsim", "--batch", "2", "--prompt-len", "4", "--new-tokens", "3", "--n-layers", "1"])
    out = capsys.readouterr().out
    assert "granite-moe-3b-a800m-smoke" in out and "ms per decode step" in out
