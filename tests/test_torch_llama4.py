"""llama4-maverick-400b-a17b against the JAX package: (dense, MoE) pairs and
the shared expert.

At ``reduced(llama4, n_layers=4)`` (d 128, two (dense, MoE) pairs, 8
experts, top-1, expert d_ff 64, one shared expert), JAX ``init_lm``
parameters are carried across with ``lm_params_from_jax`` and the same
numpy tokens go through both packages.  Held here:
* the registry: the port's config carries JAX's values; an interleave of
  3 and a depth of odd pairs raise;
* ``moe_ffn`` with the shared expert (y and aux) and ``lm_forward`` logits
  under ``native`` and ``amsim_torch`` (JAX ``amsim_jnp``): atol = rtol =
  1e-5, the limit of ``tests/test_torch_moe.py`` (the norms, silu and
  softmax round apart in torch and XLA; the LUT products are the same);
* a prefill into ring caches, then greedy steps through the decode chain
  (both layers of each pair; rings of 24 and 136, the chain's 2- and
  3-launch forms): tokens equal to JAX's, logits within 1e-5;
* ``lm_loss`` and every gradient: loss rtol 1e-5; ``native`` gradients
  rtol 1e-4 / atol 4e-6 x the leaf's largest element; ``amsim_torch``
  gradients within 1e-2 in relative norm a leaf (the zoo's documented gap,
  ``tests/test_torch_dense_zoo.py`` ``AMSIM_GRAD_REL``);
* one adafactor step (the config's optimizer) against JAX's: loss rtol
  1e-5, gradient norm rtol 1e-4, and the optimizer on JAX's clipped
  gradients: parameters rtol 1e-5 / atol 1e-7 (the adafactor limit of
  ``tests/test_torch_lm_train.py``);
* the converters' round trip, ``lm_param_shapes`` at full width against
  ``jax.eval_shape(init_lm)`` and the 18.55 G parameters of one pair;
* ``init_moe``'s in-place draw bitwise the per-expert-then-stack form;
  the plain expert bank's skipped rows and the plain batched product's
  skipped experts bitwise the forms that compute them;
* the refusal of paged caches, and the serve and train CLIs on the CPU.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch import nn  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.policy import NumericsPolicy as JaxPolicy  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import optimizers as joptim  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs.base import MoEConfig, cut, get_arch, reduced  # noqa: E402
from repro_torch.convert import (lm_opt_state_from_jax, lm_params_from_jax,  # noqa: E402
                                 lm_params_to_numpy, lm_tree_to_numpy)
from repro_torch.core import lutgen  # noqa: E402
from repro_torch.core.float_bits import np_bits  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.kernels import decode_chain, ops  # noqa: E402
from repro_torch.kernels.common import lut_tensor  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import Linear, init_linear  # noqa: E402
from repro_torch.models.mlp import init_ffn  # noqa: E402
from repro_torch.models.transformer import (PairLayer, check_paged, init_lm,  # noqa: E402
                                            init_lm_caches, lm_forward, lm_loss,
                                            lm_param_shapes, lm_stacks)
from repro_torch.serve.engine import make_serve_step  # noqa: E402

ARCH = "llama4-maverick-400b-a17b"
CFG = reduced(get_arch(ARCH), n_layers=4)
JAX_CFG = jax_reduced(jax_get_arch(ARCH), n_layers=4)
POLICIES = {
    "native": (NumericsPolicy(), JaxPolicy()),
    "amsim_torch": (NumericsPolicy(mode="amsim_torch", multiplier="afm16"),
                    JaxPolicy(mode="amsim_jnp", multiplier="afm16")),
}
TOL = dict(rtol=1e-5, atol=1e-5)
AMSIM_GRAD_REL = 1e-2
B, S, N_NEW = 2, 8, 3


@pytest.fixture(scope="module", autouse=True)
def _own_lut_dir(tmp_path_factory):
    """The JAX package caches LUTs on disk through one fixed temporary name
    per table; give this module its own directory, so that it never writes
    the shared one while another test process reads it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DIR", str(tmp_path_factory.mktemp("luts")))
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain LUT GEMMs run thousands of small ops; under several test
    workers on a shared CPU each op's thread pool waits for descheduled
    threads, so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_CARRIED = {}


def _carried():
    """(JAX params as numpy, tokens (B, S)), made once a module."""
    if not _CARRIED:
        params = jax.tree_util.tree_map(np.asarray,
                                        jtransformer.init_lm(jax.random.PRNGKey(0), JAX_CFG))
        tokens = np.random.default_rng(0).integers(0, CFG.vocab, (B, S)).astype(np.int32)
        _CARRIED.update(params=params, tokens=tokens)
    return _CARRIED["params"], _CARRIED["tokens"]


def _model():
    return lm_params_from_jax(_carried()[0], CFG, device="cpu")


def _batches(tokens):
    labels = np.concatenate([tokens[:, 1:], np.full((tokens.shape[0], 1), -1, np.int32)], axis=1)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()})


def _rel_norm(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


# ---------------------------------------------------------------- registry
def test_llama4_builds_with_jax_values_as_pairs():
    """The config carries JAX's values (its fsdp and scan_block hints
    aside: the port loops over its pairs on one card); the model holds
    n_layers / 2 ``PairLayer``s, each a dense layer then an MoE layer with
    a shared expert, under JAX's names."""
    full = get_arch(ARCH)
    assert (full.moe.n_experts, full.moe.top_k, full.moe.interleave,
            full.moe.n_shared_experts) == (128, 1, 2, 1)
    assert full.optimizer == "adafactor" and full.vocab == 202048
    model = _model()
    assert len(model.layers) == 2 and all(isinstance(p, PairLayer) for p in model.layers)
    pair = model.layers[1]
    assert pair.dense.moe is None and pair.moe_layer.ffn is None
    assert set(pair.moe_layer.moe) == {"router", "experts", "shared"}
    names = dict(model.named_parameters())
    assert tuple(names["layers.1.moe_layer.moe.shared.wg.w"].shape) == (128, 64)
    assert tuple(names["layers.1.moe_layer.moe.experts.wd.w"].shape) == (8, 64, 128)
    assert "layers.0.dense.ffn.wu.w" in names
    assert "layers.dense.attn.wq.w" in lm_stacks(CFG)


@pytest.mark.parametrize("change", ["interleave=3", "odd n_layers", "cut to odd n_layers"])
def test_unported_stacks_raise(change):
    """An interleave of 3 (JAX's (il - 1)-stacked dense block, which no
    registered config uses) raises naming it; a depth of half a pair raises
    as JAX asserts."""
    if change == "interleave=3":
        with pytest.raises(NotImplementedError, match="interleave=3"):
            MoEConfig(n_experts=8, top_k=1, d_ff=64, interleave=3)
    elif change == "odd n_layers":
        with pytest.raises(ValueError, match="not a multiple"):
            dataclasses.replace(CFG, n_layers=3)
    else:
        with pytest.raises(ValueError, match="not a multiple"):
            cut(get_arch(ARCH), n_layers=1)


def test_full_width_shapes_are_jax_s():
    """``lm_param_shapes`` at full width and depth is ``jax.eval_shape`` of
    JAX's ``init_lm`` leaf for leaf (layers stacked over the 24 pairs);
    one pair with every expert holds 18.55 G parameters (74.2 GB in
    float32), and with the experts cut to 16 4.46 G (17.84 GB)."""
    full, jfull = get_arch(ARCH), jax_get_arch(ARCH)
    jshapes = jax.eval_shape(lambda k: jtransformer.init_lm(k, jfull), jax.random.PRNGKey(0))
    want = {".".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    got = {}
    for name, shape in lm_param_shapes(full).items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            key = f"layers.{rest}"
            assert got.setdefault(key, (int(i),) + shape)[1:] == shape
            got[key] = (max(got[key][0], int(i) + 1),) + shape
        else:
            got[name] = shape
    assert got == want
    count = lambda cfg: sum(math.prod(s) for s in lm_param_shapes(cfg).values())  # noqa: E731
    assert count(cut(full, n_layers=2)) == 18_553_267_200
    assert count(cut(full, n_layers=2, n_experts=16)) == 4_459_832_320


# ----------------------------------------------------------------- moe_ffn
@pytest.mark.parametrize("name", sorted(POLICIES))
@torch.no_grad()
def test_moe_ffn_with_the_shared_expert_matches_jax(name):
    """The routed combine, then the shared expert's FFN over every token,
    as JAX sums them: y and the aux loss within TOL; the shared expert
    moves y."""
    policy, jpolicy = POLICIES[name]
    p = jax.tree_util.tree_map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(1), JAX_CFG))
    x = (np.random.default_rng(5).standard_normal((2, 8, CFG.d_model))).astype(np.float32)

    def linears(tree):
        return nn.ModuleDict({n: Linear(torch.from_numpy(np.array(v["w"])))
                              for n, v in tree.items()})

    pm = nn.ModuleDict({"router": Linear(torch.from_numpy(np.array(p["router"]["w"]))),
                        "experts": linears(p["experts"]), "shared": linears(p["shared"])})
    y, aux = moe.moe_ffn(pm, torch.from_numpy(x), CFG, policy)
    jy, jaux = jmoe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), JAX_CFG,
                            jpolicy)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    del pm["shared"]
    routed, _ = moe.moe_ffn(pm, torch.from_numpy(x), CFG, policy)
    assert not torch.allclose(routed, y)


def test_init_moe_draws_the_per_expert_then_stack_form():
    """The banks drawn expert by expert in place are bitwise the old form
    (each expert's ``init_ffn``, then ``torch.stack``), and the router and
    the shared expert follow them in the generator's order."""
    got = moe.init_moe(CFG, generator=torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    m, d = CFG.moe, CFG.d_model
    experts = [init_ffn(d, m.d_ff, CFG.act, generator=g) for _ in range(m.n_experts)]
    router = init_linear(d, m.n_experts, generator=g)
    shared = init_ffn(d, m.d_ff * m.n_shared_experts, CFG.act, generator=g)
    pairs = [(got["router"]["w"], router["w"])]
    pairs += [(got["experts"][n]["w"], torch.stack([e[n]["w"] for e in experts]))
              for n in experts[0]]
    pairs += [(got["shared"][n]["w"], shared[n]["w"]) for n in shared]
    assert set(got["experts"]) == set(got["shared"]) == {"wg", "wu", "wd"}
    for a, b in pairs:
        assert a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _bank_operands(kind, seed=3):
    """(h (E, C, d), wg, wu, wd, which rows are dead): random buffers with
    expert 1 all dead (its banks inf and NaN), dead rows between live ones
    in expert 0, and expert E-1 dead with finite banks."""
    rng = np.random.default_rng(seed)
    E, C, d, F = 6, 8, 40, 24
    h = rng.standard_normal((E, C, d)).astype(np.float32)
    w = {n: (rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for n, s in (("wg", (E, d, F)), ("wu", (E, d, F)), ("wd", (E, F, d)))}
    dead_row = {"zero": np.zeros(d, np.float32), "negative_zero": -np.zeros(d, np.float32),
                "subnormal": (rng.standard_normal(d) * 1e-39).astype(np.float32)}[kind]
    h[1] = h[E - 1] = h[0, 1::2] = dead_row
    for n in w:
        w[n][1, ::3], w[n][1, 1::3], w[n][1, 2::3] = np.inf, np.nan, -np.inf
    dead = np.zeros((E, C), bool)
    dead[1] = dead[E - 1] = dead[0, 1::2] = True
    return h, w["wg"], w["wu"], w["wd"], dead


def _every_row(fn, *ops):
    """``fn`` expert by expert on 2-D slices, every row computed: the form
    that skips nothing."""
    return torch.stack([fn(*(t.detach()[e] for t in ops)) for e in range(ops[0].shape[0])])


@pytest.mark.parametrize("group", [8, 2])
@pytest.mark.parametrize("kind", ["zero", "negative_zero", "subnormal"])
def test_plain_expert_bank_skips_dead_rows_bitwise(kind, group, monkeypatch):
    """``fused_moe_ffn_plain`` computes the experts with a live row only,
    ``PLAIN_EXPERTS`` at a time (one group of 8, three of 2), and writes
    +0.0 over the rest: bitwise the form that computes every row of every
    expert, on dead rows of zeros, -0.0 or subnormals and inf and NaN in a
    dead expert's banks."""
    from repro_torch.kernels.ref import ref_amsim_gemm
    monkeypatch.setattr(decode_chain, "PLAIN_EXPERTS", group)
    h, wg, wu, wd, dead = (torch.from_numpy(a) for a in _bank_operands(kind))
    lut, M = lut_tensor(lutgen.get_packed_lut("afm16"), "cpu"), 7
    got = decode_chain.fused_moe_ffn_plain(h, wg, wu, wd, lut, M)

    def swiglu(h, wg, wu, wd):
        act = decode_chain.silu(ref_amsim_gemm(h, wg, lut, M)) * ref_amsim_gemm(h, wu, lut, M)
        return ref_amsim_gemm(act, wd, lut, M)

    want = _every_row(swiglu, h, wg, wu, wd)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not got[dead].view(torch.int32).any() and bool(torch.isfinite(got[~dead]).all())
    assert decode_chain.live_rows(h).tolist() == (~dead).sum(1).tolist()


def test_plain_expert_bank_of_dead_experts_alone_is_positive_zero():
    """A buffer whose every expert is dead (rows of 0, -0.0 and subnormals)
    gives +0.0 everywhere, bitwise the form that computes them."""
    from repro_torch.kernels.ref import ref_amsim_gemm
    h, wg, wu, wd, _ = (torch.from_numpy(a) for a in _bank_operands("subnormal"))
    h[:, 0::3], h[:, 1::3] = 0.0, -0.0
    h[:, 2::3] = h[:, 2::3] * 1e-39
    lut, M = lut_tensor(lutgen.get_packed_lut("afm16"), "cpu"), 7
    assert not decode_chain.live_rows(h).any()
    got = decode_chain.fused_moe_ffn_plain(h, wg, wu, wd, lut, M)

    def swiglu(h, wg, wu, wd):
        act = decode_chain.silu(ref_amsim_gemm(h, wg, lut, M)) * ref_amsim_gemm(h, wu, lut, M)
        return ref_amsim_gemm(act, wd, lut, M)

    want = _every_row(swiglu, h, wg, wu, wd)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not got.view(torch.int32).any()


@pytest.mark.parametrize("kind", ["zero", "negative_zero", "subnormal"])
def test_plain_batched_product_skips_dead_experts_bitwise(kind):
    """``ref_amsim_gemm`` over stacked banks (the plain batched GEMM, which
    the expert banks' backward runs under ``amsim_torch``) writes +0.0 for
    an expert whose operand has no live element, without a product: bitwise
    each expert's 2-D product, every one computed, also with inf and NaN in
    the dead expert's bank, as the first operand's transpose (a weight
    gradient's view) and with b a view, taken without grad, of a parameter
    that an optimizer has since updated in place (a call a training step
    captured)."""
    from repro_torch.kernels.ref import ref_amsim_gemm
    h, wg, _, _, dead = (torch.from_numpy(a) for a in _bank_operands(kind))
    lut, M = lut_tensor(lutgen.get_packed_lut("afm16"), "cpu"), 7
    product = lambda a, b: ref_amsim_gemm(a, b, lut, M)  # noqa: E731
    bank = nn.Parameter(wg.transpose(1, 2).contiguous())
    with torch.no_grad():
        view = bank.transpose(1, 2)
        bank.mul_(0.5)
    for a, b in ((h, wg), (h, view), (h.transpose(1, 2), h[:, :, :24].contiguous())):
        got = product(a, b)
        assert torch.equal(got.view(torch.int32), _every_row(product, a, b).view(torch.int32))
    assert not got[dead.all(1)].view(torch.int32).any()


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_forward_matches_jax(name):
    """Logits of one uncached forward over the two pairs within TOL."""
    params, tokens = _carried()
    policy, jpolicy = POLICIES[name]
    want, _, waux = jax.jit(lambda p, t: jtransformer.lm_forward(p, t, JAX_CFG, jpolicy))(
        params, jnp.asarray(tokens))
    got, _, aux = lm_forward(_model(), torch.from_numpy(tokens), policy)
    assert got.shape == (B, S, CFG.vocab) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(waux), **TOL)


def _jax_greedy(params, tokens, jpolicy, max_len):
    caches = jtransformer.init_lm_caches(JAX_CFG, tokens.shape[0], max_len)
    fwd = jax.jit(lambda p, t, c: jtransformer.lm_forward(p, t, JAX_CFG, jpolicy, caches=c))
    step = jax.jit(jengine.make_serve_step(JAX_CFG, jpolicy))
    logits, caches, _ = fwd(params, jnp.asarray(tokens), caches)
    nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    kept, toks = [np.asarray(logits[:, -1:])], [np.asarray(nxt)]
    for _ in range(N_NEW - 1):
        lg, nxt, caches = step(params, nxt, caches)
        kept.append(np.asarray(lg))
        toks.append(np.asarray(nxt))
    return np.concatenate(toks, 1), np.concatenate(kept, 1), np.asarray(logits)


@pytest.mark.parametrize("max_len", [24, 136])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_prefill_then_chain_decode_matches_jax(name, max_len):
    """A prefill into the pairs' rings (a tuple: the dense layers', the MoE
    layers', as JAX's), then greedy steps: under ``amsim_torch`` through
    the decode chain in both layers of a pair (the 2-launch form at a ring
    of 24, 3 launches at 136; the MoE layer's shared expert per op).
    Tokens equal to JAX's, logits within TOL."""
    params, tokens = _carried()
    policy, jpolicy = POLICIES[name]
    assert ops.decode_chain_enabled(policy) == (name == "amsim_torch")
    want_toks, want_logits, want_prefill = _jax_greedy(params, tokens, jpolicy, max_len)
    model = _model()
    caches = init_lm_caches(CFG, B, max_len, "cpu")
    assert isinstance(caches, tuple) and [len(c) for c in caches] == [2, 2]
    logits, caches, _ = lm_forward(model, torch.from_numpy(tokens), policy, caches=caches)
    assert caches[0][1]["len"] == caches[1][0]["len"] == S
    np.testing.assert_allclose(logits.numpy(), want_prefill, **TOL)
    step = make_serve_step(model, policy)
    nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    toks, kept = [nxt], [logits[:, -1:]]
    for _ in range(N_NEW - 1):
        lg, nxt, caches = step(nxt, caches)
        toks.append(nxt)
        kept.append(lg)
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), want_toks)
    np.testing.assert_allclose(torch.cat(kept, 1).numpy(), want_logits, **TOL)


# ------------------------------------------------------- loss + gradients
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_loss_and_gradients_match_jax(name):
    """``lm_loss`` (remat over each pair) and every gradient leaf, the
    shared expert's too.  Limits: the module docstring."""
    params, tokens = _carried()
    policy, jpolicy = POLICIES[name]
    jbatch, batch = _batches(tokens)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtransformer.lm_loss(p, jbatch, JAX_CFG, jpolicy), has_aux=True))(params)
    model = _model()
    loss, _ = lm_loss(model, batch, policy)
    named = dict(model.named_parameters())
    grads = lm_tree_to_numpy(dict(zip(named, torch.autograd.grad(loss, list(named.values())))))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert np.abs(grads["layers"]["moe_layer"]["moe"]["shared"]["wd"]["w"]).max() > 0
    jl = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    pl = jax.tree_util.tree_leaves(grads)
    assert len(jl) == len(pl)
    for (path, b), a in zip(jl, pl):
        b = np.asarray(b)
        if name == "native":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=4e-6 * np.abs(b).max(),
                                       err_msg=jax.tree_util.keystr(path))
        else:
            assert _rel_norm(a, b) <= AMSIM_GRAD_REL, (jax.tree_util.keystr(path),
                                                       _rel_norm(a, b))


def test_one_adafactor_step_matches_jax():
    """One step of ``launch.train.make_lm_train_step`` (the config's
    adafactor over ``cosine_schedule(lr, 10, steps)``, clip 1.0) against
    JAX's ``make_train_step``, under ``native``: loss rtol 1e-5, gradient
    norm rtol 1e-4.  Then the step's optimizer and JAX's on the same
    clipped gradients: every parameter within rtol 1e-5 / atol 1e-7.  The
    factored state of a pair's expert bank spans the pairs: rows (P, E,
    d), columns (P, E, F)."""
    from repro_torch.optim.optimizers import apply_updates
    params, tokens = _carried()
    assert CFG.optimizer == JAX_CFG.optimizer == "adafactor"
    jbatch, batch = _batches(tokens)
    opt, step = launch_train.make_lm_train_step(CFG, NumericsPolicy(), lr=1e-2, steps=4)
    jopt = joptim.make_optimizer("adafactor", joptim.cosine_schedule(1e-2, 10, 4))
    jloss_fn = lambda p, b: jtransformer.lm_loss(p, b, JAX_CFG, JaxPolicy())  # noqa: E731
    _, _, jmet = jax.jit(jstep.make_train_step(jloss_fn, jopt))(params, jopt.init(params),
                                                                jbatch)
    model = _model()
    state, met = step(model, opt.init(dict(model.named_parameters())), batch)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    f = state["f"]["layers.moe_layer.moe.experts.wg.w"]
    m = CFG.moe
    assert tuple(f["r"].shape) == (2, m.n_experts, CFG.d_model)
    assert tuple(f["c"].shape) == (2, m.n_experts, m.d_ff)

    jgrads = jax.grad(lambda p: jloss_fn(p, jbatch)[0])(params)
    jgrads, _ = joptim.clip_by_global_norm(jgrads, 1.0)
    jupdates, _ = jopt.update(jgrads, jopt.init(params), params)
    jparams = jax.tree_util.tree_map(np.asarray, joptim.apply_updates(params, jupdates))
    model = _model()
    flat = dict(model.named_parameters())
    port_grads = lm_opt_state_from_jax({"step": 0, "m": jgrads}, device="cpu")["m"]
    updates, _ = opt.update(port_grads, opt.init(flat), flat)
    apply_updates(flat, updates)
    got = lm_params_to_numpy(model)
    for (path, w), a in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-7, err_msg=jax.tree_util.keystr(path))


def test_converters_round_trip():
    """``lm_params_to_numpy`` inverts ``lm_params_from_jax`` leaf for leaf
    over the pairs' ``dense`` and ``moe_layer`` stacks; a bank of the wrong
    shape is refused."""
    params, _ = _carried()
    back = lm_params_to_numpy(_model())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np_bits(a), np_bits(np.asarray(b)))
    bad = jax.tree_util.tree_map(lambda a: a, params)
    shared = bad["layers"]["moe_layer"]["moe"]["shared"]["wu"]
    shared["w"] = shared["w"][..., :-1]
    with pytest.raises(ValueError, match="shapes differ"):
        lm_params_from_jax(bad, CFG, device="cpu")


# ------------------------------------------------------------------ CLIs
def test_paged_caches_refuse_the_pairs_as_jax_does():
    """``check_paged`` refuses (dense, MoE) pairs, as JAX's
    ``init_paged_lm_caches`` does, and ``launch.serve --stream`` exits on
    llama4 before any work; granite-moe's stack still pages."""
    with pytest.raises(NotImplementedError, match="interleave"):
        jtransformer.init_paged_lm_caches(JAX_CFG, 4, 8)
    with pytest.raises(NotImplementedError, match="dense/moe"):
        check_paged(CFG)
    check_paged(reduced(get_arch("granite-moe-3b-a800m")))
    with pytest.raises(SystemExit, match="--stream"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--stream", "2"])


def test_serve_cli_serves_llama4_and_refuses_an_odd_depth(capsys):
    """``python -m repro_torch.serve`` at the reduced widths, one pair,
    through the decode chain; ``--n-layers 3`` raises."""
    from repro_torch.serve import __main__ as serve_main
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--numerics", "amsim", "--batch",
            "2", "--prompt-len", "4", "--new-tokens", "2"]
    serve_main.main(argv)
    out = capsys.readouterr().out
    assert "decode chain: fused" in out and f"{ARCH}-smoke, 2 layers" in out
    with pytest.raises(ValueError, match="not a multiple"):
        serve_main.main(argv + ["--n-layers", "3"])


def test_train_cli_trains_llama4_with_cut_experts(capsys):
    """``launch.train --arch llama4-maverick-400b-a17b`` at the reduced
    widths, two pairs, the experts cut to 4: an adafactor step."""
    state = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1",
                               "--batch", "1", "--seq", "8", "--n-layers", "4",
                               "--n-experts", "4"])
    assert state.step == 1
    assert state.model.cfg.moe.n_experts == 4 and len(state.model.layers) == 2
    with pytest.raises(ValueError, match="no experts"):
        cut(get_arch("granite-3-2b"), n_experts=4)


def test_init_lm_draws_the_pairs_on_the_generator_s_device():
    """``init_lm`` builds the pairs from a generator; the same seed gives
    the same tensors."""
    a = init_lm(CFG, generator=torch.Generator().manual_seed(1), device="cpu")
    b = init_lm(CFG, generator=torch.Generator().manual_seed(1), device="cpu")
    assert {n: tuple(p.shape) for n, p in a.named_parameters()} == lm_param_shapes(CFG)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
