"""The port's SSM families (Mamba2 SSD, the zamba2 hybrid) against the JAX
package's.

Reduced mamba2-780m and zamba2-1.2b (``configs.base.reduced``: d 128,
d_state 16, head_dim 16, chunk 8; the hybrid at 4 layers with the shared
block after every 2nd): JAX ``init_lm`` parameters are carried across with
``lm_params_from_jax`` and the same numpy inputs go through both packages
in one process.  Held here:
* ``_ssd_chunked`` (2 chunks of 8) and the Mamba2 block on both branches
  (the chunked scan, the per-token recurrence with its cache) against
  JAX, rtol 1e-5; the chunked output against the recurrence (JAX's own
  rtol 1e-3, atol 1e-4);
* the masked exponent: its values those of JAX's ``where(mask, exp, 0)``
  element for element; at Q = 256 and a log-decay of -1 a step JAX's
  gradient is not finite, the port's is, within 1e-4 of float64;
* both engines' greedy tokens against JAX's (native and amsim_torch /
  amsim_jnp), a zamba2 ring of 4 slots that wraps, ``amsim`` == ``amsim_torch``;
* ``lm_loss`` and every gradient against ``jax.grad``;
* the converters both ways (the hybrid's unstacked ``shared_attn`` too),
  adafactor on the stacked SSM leaves;
* the refusals: paged caches and ``launch.serve --stream`` for both
  families, ``launch.train`` at a ``--seq`` off the chunk.
The card's ``amsim`` == ``amsim_torch`` at full width lives in
``test_torch_cuda.py``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.policy import NumericsPolicy as JaxPolicy  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import optimizers as joptim  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs.base import get_arch, reduced  # noqa: E402
from repro_torch.convert import (lm_opt_state_from_jax, lm_opt_state_to_numpy,  # noqa: E402
                                 lm_params_from_jax, lm_params_to_numpy, lm_tree_to_numpy)
from repro_torch.core.policy import NumericsPolicy, table_from_assignments  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.transformer import (init_lm, init_lm_caches,  # noqa: E402
                                            init_paged_lm_caches, lm_forward, lm_loss,
                                            lm_param_shapes, lm_stacks)
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

ARCHS = ["mamba2-780m", "zamba2-1.2b"]
POLICIES = {
    "native": (NumericsPolicy(), JaxPolicy()),
    "amsim_torch": (NumericsPolicy(mode="amsim_torch", multiplier="afm16"),
                    JaxPolicy(mode="amsim_jnp", multiplier="afm16")),
}
N_NEW = 4


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


def _carried(arch, **changes):
    """(port cfg, JAX cfg, JAX params as numpy, port model) of a reduced
    arch, made once a module."""
    key = (arch, tuple(sorted(changes.items())))
    if key not in _CARRIED:
        cfg = reduced(get_arch(arch), **changes)
        jcfg = jax_reduced(jax_get_arch(arch), **changes)
        params = jax.tree_util.tree_map(np.asarray,
                                        jtransformer.init_lm(jax.random.PRNGKey(0), jcfg))
        _CARRIED[key] = (cfg, jcfg, params, lm_params_from_jax(params, cfg, device="cpu"))
    return _CARRIED[key]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ssd_inputs(rng, B=2, L=16, nh=4, hp=8, N=16, dA=None):
    xdt = rng.standard_normal((B, L, nh, hp)).astype(np.float32)
    Bc = rng.standard_normal((B, L, N)).astype(np.float32)
    Cc = rng.standard_normal((B, L, N)).astype(np.float32)
    if dA is None:
        dA = -rng.uniform(0.01, 0.5, (B, L, nh)).astype(np.float32)
    else:
        dA = np.full((B, L, nh), dA, np.float32)
    return xdt, Bc, Cc, dA


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


# ---------------------------------------------------------------- configs
def test_arch_configs_match_jax():
    for arch in ARCHS:
        full, jfull = get_arch(arch), jax_get_arch(arch)
        for cfg, jcfg in ((full, jfull), (reduced(full), jax_reduced(jfull))):
            for field in dataclasses.fields(cfg):
                ours, theirs = getattr(cfg, field.name), getattr(jcfg, field.name)
                if dataclasses.is_dataclass(ours):
                    ours, theirs = dataclasses.asdict(ours), dataclasses.asdict(theirs)
                assert ours == theirs, field.name
            assert cfg.head_dim == jcfg.head_dim
    z = reduced(get_arch("zamba2-1.2b"))
    assert (z.n_layers, z.attn_every, z.ssm.chunk) == (4, 2, 8)
    m = reduced(get_arch("mamba2-780m"))
    assert (m.n_heads, m.d_ff, m.d_head) == (0, 0, 0)


def test_param_shapes_and_init_follow_jax():
    """``lm_param_shapes`` is the shape of JAX's tree (layers unstacked, the
    hybrid's ``shared_attn`` alone), and ``init_lm`` draws the Mamba2
    constants JAX draws."""
    for arch in ARCHS:
        cfg, _, params, _ = _carried(arch)
        jshapes = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            name = ".".join(str(k.key) for k in path)
            if name.startswith("layers."):
                for i in range(leaf.shape[0]):
                    jshapes["layers.%d.%s" % (i, name[7:])] = leaf.shape[1:]
            else:
                jshapes[name] = leaf.shape
        assert lm_param_shapes(cfg) == jshapes
        model = init_lm(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
        named = dict(model.named_parameters())
        assert {k: tuple(v.shape) for k, v in named.items()} == jshapes
        for name in ("A_log", "D", "dt_bias", "conv_b", "norm.g"):
            want = params["layers"]["mamba"]
            for part in name.split("."):
                want = want[part]
            # log(13) and log(15) round an ulp apart in torch and XLA
            np.testing.assert_allclose(named[f"layers.1.mamba.{name}"].detach().numpy(),
                                       want[1], rtol=2e-7, atol=0)
    assert "shared_attn" not in " ".join(lm_stacks(_carried("zamba2-1.2b")[0]))


# ---------------------------------------------------------------- SSD scan
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_ssd_chunked_matches_jax(name, rng):
    """Two chunks of 8: the four einsums under the policy, the inter-chunk
    recurrence, rtol 1e-5 against JAX."""
    policy, jpolicy = POLICIES[name]
    xdt, Bc, Cc, dA = _ssd_inputs(rng)
    want = np.asarray(jax.jit(lambda *a: jssm._ssd_chunked(*a, 8, jpolicy))(
        *map(jnp.asarray, (xdt, Bc, Cc, dA))))
    got = ssm.ssd_chunked(*map(_t, (xdt, Bc, Cc, dA)), 8, policy)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _ssd_every_product(xdt, Bc, Cc, dA, Q, policy):
    """JAX's ``_ssd_chunked`` step for step in the port's ops: every chunk's
    state and the inter-chunk product of every chunk, the dead ones too."""
    from repro_torch.kernels.ops import policy_einsum
    B_, L, nh, hp = xdt.shape
    N, c = Bc.shape[-1], L // Q
    xc, Bcc, Ccc = xdt.reshape(B_, c, Q, nh, hp), Bc.reshape(B_, c, Q, N), Cc.reshape(B_, c, Q, N)
    cum = torch.cumsum(dA.reshape(B_, c, Q, nh), dim=2)
    scores = policy_einsum("bcln,bcsn->bcls", Ccc, Bcc, policy, site="ssm")
    li = torch.arange(Q)
    mask = (li[:, None] >= li[None, :])[None, None, :, :, None]
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    Tm = ssm.masked_decay(decay, mask) * scores[..., None]
    y_intra = policy_einsum("bclsh,bcshp->bclhp", Tm, xc, policy, site="ssm")
    to_end = torch.exp(cum[:, :, -1:, :] - cum)
    Sc = policy_einsum("bcsn,bcshp->bchpn", Bcc, xc * to_end[..., None], policy, site="ssm")
    seg = torch.exp(cum[:, :, -1, :])
    h, hs = torch.zeros((B_, nh, hp, N)), []
    for t in range(c):
        hs.append(h)
        h = h * seg[:, t][:, :, None, None] + Sc[:, t]
    y_inter = policy_einsum("bcln,bchpn->bclhp", Ccc, torch.stack(hs, dim=1), policy, site="ssm")
    return (y_intra + y_inter * torch.exp(cum)[..., None]).reshape(B_, L, nh, hp)


@pytest.mark.parametrize("L", [8, 24])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_ssd_chunked_skips_only_dead_products(name, L, rng, monkeypatch):
    """The scan makes no chunk state after the last chunk, and a row of one
    chunk runs the scores and intra-chunk products alone: outputs and all
    four gradients equal (as values) those of JAX's form with every product
    made; the products run are 2 at one chunk, 4 (states over c - 1 chunks)
    at more."""
    from repro_torch.kernels import ops
    policy = POLICIES[name][0]
    inputs = _ssd_inputs(rng, L=L)
    ref = [_t(a).requires_grad_() for a in inputs]
    want = _ssd_every_product(*ref, 8, policy)
    want_g = torch.autograd.grad((want * want).sum(), ref)
    calls = []
    orig = ops.policy_einsum
    monkeypatch.setattr(ssm, "policy_einsum",
                        lambda spec, a, b, *r, **k: (calls.append((spec, a.shape[1])),
                                                     orig(spec, a, b, *r, **k))[1])
    ts = [_t(a).requires_grad_() for a in inputs]
    got = ssm.ssd_chunked(*ts, 8, policy)
    got_g = torch.autograd.grad((got * got).sum(), ts)
    assert torch.equal(got, want) and all(map(torch.equal, got_g, want_g))
    c = L // 8
    spans = [("bcln,bcsn->bcls", c), ("bclsh,bcshp->bclhp", c)]
    if c > 1:
        spans += [("bcsn,bcshp->bchpn", c - 1), ("bcln,bchpn->bclhp", c)]
    assert calls == spans


def test_ssd_chunked_refuses_a_partial_chunk():
    xdt, Bc, Cc, dA = map(_t, _ssd_inputs(np.random.default_rng(0), L=12))
    with pytest.raises(ValueError, match="multiple of the chunk 8"):
        ssm.ssd_chunked(xdt, Bc, Cc, dA, 8, NumericsPolicy())


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_mamba2_block_matches_jax_on_both_branches(name, rng):
    """Layer 0's Mamba2 block (reduced mamba2 and zamba2 draw the same one):
    the chunked branch over 16 tokens, and the cache branch (the per-token
    recurrence) over the same 16 tokens then one more, with the carried
    state; outputs and states rtol = atol = 1e-5 (outputs of O(1)).  Under
    amsim the recurrence's exact einsums sum in another order in torch and
    XLA, and out_proj's LUT products can turn such an ulp into a truncation
    step: the cache branch's outputs there are held to atol 1e-3."""
    cfg, jcfg, params, model = _carried("mamba2-780m")
    policy, jpolicy = POLICIES[name]
    p = model.layers[0].mamba
    jp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["mamba"])
    u = rng.standard_normal((2, 17, cfg.d_model)).astype(np.float32)
    jblock = jax.jit(lambda jp, u, c: jssm.mamba2(jp, u, jcfg, jpolicy, cache=c))
    want, _ = jblock(jp, jnp.asarray(u[:, :16]), None)
    with torch.no_grad():
        got, cache = ssm.mamba2(p, _t(u[:, :16]), cfg, policy)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    jcache = jssm.init_ssm_cache(jcfg, 2)
    cache = ssm.init_ssm_cache(cfg, 2, "cpu")
    atol = 1e-5 if name == "native" else 1e-3
    for sl in (slice(0, 16), slice(16, 17)):
        want, jcache = jblock(jp, jnp.asarray(u[:, sl]), jcache)
        with torch.no_grad():
            got, cache = ssm.mamba2(p, _t(u[:, sl]), cfg, policy, cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=atol)
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_scan_equals_the_recurrence(arch, rng):
    """The SSD scan and the per-token recurrence are two forms of one map
    (JAX's own tolerance: rtol 1e-3, atol 1e-4)."""
    cfg, _, _, model = _carried(arch)
    u = _t(rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32))
    p, policy = model.layers[1].mamba, NumericsPolicy()
    with torch.no_grad():
        chunked, _ = ssm.mamba2(p, u, cfg, policy)
        seq, _ = ssm.mamba2(p, u, cfg, policy, cache=ssm.init_ssm_cache(cfg, 2, "cpu"))
    np.testing.assert_allclose(chunked.numpy(), seq.numpy(), rtol=1e-3, atol=1e-4)


# -------------------------------------------------------- masked exponent
def test_masked_exponent_has_the_values_of_the_where_form():
    """exp(where(mask, decay, -inf)) == where(mask, exp(decay), 0) bit for
    bit, with decays off the mask that overflow exp."""
    g = torch.Generator().manual_seed(0)
    decay = torch.randn((3, 64, 64), generator=g) * 60
    mask = torch.rand((3, 64, 64), generator=g) < 0.5
    assert bool(torch.isinf(torch.exp(decay[~mask])).any())
    got = ssm.masked_decay(decay, mask)
    want = torch.where(mask, torch.exp(decay), 0.0)
    assert _bits_equal(got, want)
    assert _bits_equal(got * -2.5, want * -2.5)


def _ssd_float64(xdt, Bc, Cc, dA):
    """y_t = sum_{s <= t} exp(cum_t - cum_s) (C_t . B_s) x_s in float64, the
    exponent masked before exp: the plain quadratic form of the scan."""
    cum = torch.cumsum(dA, dim=1)                                  # (B, L, nh)
    L = dA.shape[1]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool))[None, :, :, None]
    decay = torch.exp(torch.where(mask, cum[:, :, None, :] - cum[:, None, :, :], -math.inf))
    scores = torch.einsum("bln,bsn->bls", Cc, Bc)
    return torch.einsum("blsh,bshp->blhp", decay * scores[..., None], xdt)


def test_masked_exponent_keeps_the_gradient_finite_at_chunk_256():
    """At Q = 256 and a log-decay of -1 a step, exp overflows above the
    diagonal: JAX's ``_ssd_chunked`` gradient is not finite (its
    ``where`` sends 0 x inf = NaN back), the port's is finite and within
    1e-4 of the float64 quadratic form's; the forward values agree with
    JAX's (rtol 1e-5)."""
    inputs = _ssd_inputs(np.random.default_rng(3), B=1, L=256, nh=2, hp=4, N=8, dA=-1.0)
    jpolicy = JaxPolicy()

    def jloss(*a):
        return jnp.sum(jssm._ssd_chunked(*a, 256, jpolicy))

    jin = tuple(map(jnp.asarray, inputs))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jin)
    assert not all(bool(jnp.isfinite(g).all()) for g in jgrads)
    ts = [_t(a).requires_grad_() for a in inputs]
    y = ssm.ssd_chunked(*ts, 256, NumericsPolicy())
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jssm._ssd_chunked(*jin, 256, jpolicy)),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(y.sum(), ts)
    t64 = [_t(a).double().requires_grad_() for a in inputs]
    grads64 = torch.autograd.grad(_ssd_float64(*t64).sum(), t64)
    for g, g64 in zip(grads, grads64):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), g64.numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- serving
def _jax_generate(jcfg, params, prompts, jpolicy, max_len):
    """Prefill + greedy decode steps of the JAX engine, keeping the logits
    that choose each token."""
    caches = jtransformer.init_lm_caches(jcfg, prompts.shape[0], max_len)
    fwd = jax.jit(lambda p, t, c: jtransformer.lm_forward(p, t, jcfg, jpolicy, caches=c))
    step = jax.jit(jengine.make_serve_step(jcfg, jpolicy))
    logits, caches, _ = fwd(params, jnp.asarray(prompts), caches)
    nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    kept, toks = [np.asarray(logits[:, -1:])], [np.asarray(nxt)]
    for _ in range(N_NEW - 1):
        lg, nxt, caches = step(params, nxt, caches)
        kept.append(np.asarray(lg))
        toks.append(np.asarray(nxt))
    return np.concatenate(toks, 1), np.concatenate(kept, 1)


SERVE_CASES = [("mamba2-780m", {}), ("zamba2-1.2b", {}), ("zamba2-1.2b", {"sliding_window": 4})]


@pytest.mark.parametrize("case", range(len(SERVE_CASES)))
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_serving_matches_jax(case, name):
    """The engines' greedy tokens are JAX's; zamba2 also with a window of 4,
    so that a ring of 4 slots wraps in the prefill of 6 and again in the
    decode.  Logits: native rtol = atol = 1e-5.  Under amsim an operand an
    ulp apart (exp, softplus, cumsum round differently in torch and XLA)
    can cross a 7-bit truncation step, a 2^-7 change in that product; JAX's
    own eager and jitted runs of zamba2 differ that way, so under
    amsim_torch the logits are held to atol 5e-2 and the tokens exactly."""
    arch, changes = SERVE_CASES[case]
    cfg, jcfg, params, model = _carried(arch, **changes)
    policy, jpolicy = POLICIES[name]
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    toks, logits = _jax_generate(jcfg, params, prompts, jpolicy, 16)
    caches = init_lm_caches(cfg, 2, 16, "cpu")
    if cfg.family == "hybrid":
        assert [c["k"].shape[1] for c in caches[1]] == [min(16, cfg.sliding_window)] * 2
    out, kept = ServingEngine(model, policy, max_len=16).generate(torch.from_numpy(prompts),
                                                                  N_NEW, return_logits=True)
    np.testing.assert_array_equal(out.numpy(), toks)
    tol = 1e-5 if name == "native" else 5e-2
    np.testing.assert_allclose(kept.numpy(), logits, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", range(len(SERVE_CASES)))
def test_amsim_serves_like_amsim_torch(case):
    """On the CPU the ``amsim`` kernels run their plain versions: the same
    tokens and logits bit for bit; the hybrid's decode steps take the chain."""
    arch, changes = SERVE_CASES[case]
    _, _, _, model = _carried(arch, **changes)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 6)))
    runs = [ServingEngine(model, NumericsPolicy(mode=mode, multiplier="afm16"),
                          max_len=16).generate(prompts, N_NEW, return_logits=True)
            for mode in ("amsim", "amsim_torch")]
    assert torch.equal(runs[0][0], runs[1][0]) and _bits_equal(runs[0][1], runs[1][1])


def test_hybrid_decode_goes_through_the_chain(monkeypatch):
    """A zamba2 decode step under amsim runs the shared block as the chain
    (qkv, then attention + back half in one launch at a ring <= 128) once
    per application; its Mamba2 layers reach none of the chain's ops."""
    from repro_torch.kernels import ops
    cfg, _, _, model = _carried("zamba2-1.2b")
    calls = []
    for fn in ("decode_qkv", "decode_attn_out_mlp"):
        orig = getattr(ops, fn)
        monkeypatch.setattr(ops, fn, lambda *a, _o=orig, _n=fn, **k: (calls.append(_n),
                                                                      _o(*a, **k))[1])
    prompts = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 6)))
    ServingEngine(model, NumericsPolicy(mode="amsim", multiplier="afm16"),
                  max_len=16).generate(prompts, 2)
    n_attn = cfg.n_layers // cfg.attn_every
    assert calls == ["decode_qkv", "decode_attn_out_mlp"] * n_attn


def test_generate_matches_full_prefill_argmax():
    """Greedy decode through the caches equals the argmax of one uncached
    forward over prompt + generated (the chunked scan: 8 tokens)."""
    cfg = reduced(get_arch("mamba2-780m"), n_layers=1)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(7), device="cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 5), generator=torch.Generator().manual_seed(7))
    out = ServingEngine(model, NumericsPolicy(), max_len=16).generate(prompts, 4)
    full = torch.cat([prompts, out[:, :-1].to(prompts.dtype)], dim=1)
    logits, _, _ = lm_forward(model, full, NumericsPolicy())
    assert torch.equal(out.to(torch.int64), logits[:, prompts.shape[1] - 1:].argmax(-1))


# ---------------------------------------------------------------- training
def _batch(cfg, B=2, S=16, seed=0):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    return tokens, labels


# Under amsim the gradients pass through thousands of LUT products whose
# operands come from exp, softplus and cumsum; an ulp there can cross a
# truncation step (a 2^-7 change in one product).  JAX's own eager and
# jitted gradients of reduced zamba2 under amsim_jnp differ by up to 6.2e-3
# in a leaf's relative norm, its losses by 2.5e-5.  So amsim leaves are held
# in relative norm against JAX's jitted run, each limit just above the
# port's own gap to it: mamba2 8.8e-5 (limit 1e-3), zamba2 6.3e-3 (limit
# 1e-2); the losses 7.6e-8 and 2.5e-5 (rtol 1e-5 and 1e-4).  Wrong numerics
# read far above those limits for zamba2 (largest leaf, loss): the ssm site
# native 2.8e-1, 3.0e-3; afm10 1.1e-1, 2.3e-3; bf16 surrogate 3.0e-1,
# 8.7e-4; all native 3.0e-1, 1.1e-3 (``test_amsim_limits_fail_wrong_numerics``
# holds the first two).  Native leaves elementwise at rtol 1e-4 and atol
# 1e-6 x the leaf's largest element (at least 1): zamba2's embedding
# gradient reaches 2.3, and JAX's eager and jitted runs differ there by
# 2.2e-6.
AMSIM_GRAD_NORM = {"mamba2-780m": 1e-3, "zamba2-1.2b": 1e-2}
AMSIM_LOSS_RTOL = {"mamba2-780m": 1e-5, "zamba2-1.2b": 1e-4}
_JAX_GRADS = {}


def _jax_loss_and_grads(arch, name):
    """(loss, [(path, gradient)]) of JAX's jitted ``lm_loss`` on ``_batch``,
    made once a module."""
    if (arch, name) not in _JAX_GRADS:
        cfg, jcfg, params, _ = _carried(arch)
        tokens, labels = _batch(cfg)
        jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
        jpolicy = POLICIES[name][1]
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jtransformer.lm_loss(p, jbatch, jcfg, jpolicy), has_aux=True))(params)
        _JAX_GRADS[arch, name] = (float(jloss), [
            (jax.tree_util.keystr(path), np.asarray(b))
            for path, b in jax.tree_util.tree_flatten_with_path(jgrads)[0]])
    return _JAX_GRADS[arch, name]


def _port_loss_and_grads(arch, policy):
    """(loss, gradients in JAX's leaf order) of the port's ``lm_loss``."""
    cfg, _, _, model = _carried(arch)
    tokens, labels = _batch(cfg)
    loss, _ = lm_loss(model, {"tokens": torch.from_numpy(tokens).long(),
                              "labels": torch.from_numpy(labels).long()}, policy)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.item(), jax.tree_util.tree_leaves(lm_tree_to_numpy(dict(zip(named, grads))))


def _rel_norm(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_lm_loss_and_gradients_match_jax(arch, name):
    jloss, jleaves = _jax_loss_and_grads(arch, name)
    loss, pleaves = _port_loss_and_grads(arch, POLICIES[name][0])
    rtol = 1e-5 if name == "native" else AMSIM_LOSS_RTOL[arch]
    np.testing.assert_allclose(loss, jloss, rtol=rtol)
    assert len(jleaves) == len(pleaves)
    for (where, b), a in zip(jleaves, pleaves):
        assert np.isfinite(a).all(), where
        if name == "native":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * max(1.0, np.abs(b).max()),
                                       err_msg=where)
        else:
            err = _rel_norm(a, b)
            assert err <= AMSIM_GRAD_NORM[arch], (where, err)


@pytest.mark.parametrize("control", ["ssm=native,default=amsim_torch:afm16",
                                     "default=amsim_torch:afm10"])
def test_amsim_limits_fail_wrong_numerics(control):
    """The zamba2 amsim limits above tell afm16 from a near miss: the SSM
    site left native, or afm10 in place of afm16, puts some leaf (and the
    loss) past them."""
    jloss, jleaves = _jax_loss_and_grads("zamba2-1.2b", "amsim_torch")
    loss, pleaves = _port_loss_and_grads("zamba2-1.2b", table_from_assignments(control))
    worst = max(_rel_norm(a, b) for (_, b), a in zip(jleaves, pleaves))
    assert worst > 5 * AMSIM_GRAD_NORM["zamba2-1.2b"], worst
    assert abs(loss - jloss) > 5 * AMSIM_LOSS_RTOL["zamba2-1.2b"] * abs(jloss)


def test_remat_keeps_the_bits():
    """``cfg.remat`` recomputes each Mamba2 block in the backward: the same
    loss and gradients as without."""
    cfg, _, _, model = _carried("mamba2-780m")
    tokens, labels = _batch(cfg, S=8)
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    policy = POLICIES["amsim_torch"][0]
    runs = []
    for remat in (True, False):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        loss, _ = lm_loss(model, batch, policy)
        runs.append([loss, *torch.autograd.grad(loss, list(model.parameters()))])
    model.cfg = cfg
    assert all(_bits_equal(a, b) for a, b in zip(*runs))


def test_adafactor_matches_jax_on_the_stacked_ssm_leaves(rng):
    """Two adafactor steps on reduced zamba2 with the JAX tree's stacks:
    ``conv_w`` is one (L, K, ch) leaf, factored over (K, ch) with a row
    factor a layer; ``A_log`` one (L, nh) leaf; the shared block's leaves
    stand alone.  Parameters and factors within rtol 1e-5 of JAX."""
    cfg, _, params, _ = _carried("zamba2-1.2b")
    model = lm_params_from_jax(params, cfg, device="cpu")
    opt = optimizers.make_optimizer("adafactor", 1e-2, stacks=lm_stacks(cfg), weight_decay=0.01)
    jopt = joptim.make_optimizer("adafactor", 1e-2, weight_decay=0.01)
    flat = dict(model.named_parameters())
    state, jstate, jparams = opt.init(flat), jopt.init(params), params
    jupdate = jax.jit(jopt.update)
    for _ in range(2):
        jg = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                    params)
        upd, jstate = jupdate(jg, jstate, jparams)
        jparams = joptim.apply_updates(jparams, upd)
        grads = lm_opt_state_from_jax({"step": 0, "m": jg}, device="cpu")["m"]
        upd, state = opt.update(grads, state, flat)
        optimizers.apply_updates(flat, upd)
    f = state["f"]
    L, K, ch = params["layers"]["mamba"]["conv_w"].shape
    assert tuple(f["layers.mamba.conv_w"]["r"].shape) == (L, K)
    assert tuple(f["layers.mamba.conv_w"]["c"].shape) == (L, ch)
    assert tuple(f["layers.mamba.A_log"]["r"].shape) == (L,)
    assert set(f["shared_attn.n1.g"]) == {"v"}
    for a, b in zip(jax.tree_util.tree_leaves(lm_params_to_numpy(model)),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7)
    for a, b in zip(jax.tree_util.tree_leaves(lm_opt_state_to_numpy(state)["f"]),
                    jax.tree_util.tree_leaves(jstate["f"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_converters_round_trip(arch, rng):
    """Parameters (the hybrid's unstacked ``shared_attn`` too) and adamw and
    adafactor states come back leaf for leaf; a wrong shape is refused."""
    cfg, _, params, model = _carried(arch)
    back = lm_params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    if cfg.attn_every:
        np.testing.assert_array_equal(
            dict(model.named_parameters())["shared_attn.attn.wq.w"].detach().numpy(),
            params["shared_attn"]["attn"]["wq"]["w"])
    m, v = (jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                   params) for _ in range(2))
    jada = joptim.adafactor(1e-2)
    for state in ({"m": m, "v": v, "step": np.int32(2)},
                  jax.tree_util.tree_map(np.asarray, jax.jit(jada.update)(
                      m, jada.init(params), params)[1])):
        back = lm_opt_state_to_numpy(lm_opt_state_from_jax(state, device="cpu"))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(state)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(state)):
            np.testing.assert_array_equal(a, np.asarray(b))
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["layers"]["mamba"]["A_log"] = bad["layers"]["mamba"]["A_log"][:, :-1]
    with pytest.raises(ValueError, match="shapes differ"):
        lm_params_from_jax(bad, cfg, device="cpu")


# ---------------------------------------------------------------- refusals, CLIs
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_caches_refuse_the_ssm_families(arch):
    cfg = reduced(get_arch(arch))
    with pytest.raises(NotImplementedError, match="support dense/moe"):
        init_paged_lm_caches(cfg, 4, 8, "cpu")
    with pytest.raises(NotImplementedError, match="support dense/moe"):
        jtransformer.init_paged_lm_caches(jax_reduced(jax_get_arch(arch)), 4, 8)
    with pytest.raises(SystemExit, match="--stream: paged serving caches support dense/moe"):
        launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--stream", "2"])


def test_train_cli_refuses_a_seq_off_the_chunk(monkeypatch):
    """Before any work: no device asked for, no model drawn."""
    monkeypatch.setattr(launch_train, "init_lm", lambda *a, **k: pytest.fail("model drawn"))
    with pytest.raises(SystemExit, match="--seq 12 is not a multiple of .* SSD chunk 8"):
        launch_train.main(["--arch", "zamba2-1.2b", "--reduced", "--seq", "12"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_on_the_cpu(arch, capsys):
    state = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1",
                               "--batch", "1", "--seq", "8", "--numerics", "amsim",
                               "--multiplier", "afm16"])
    out = capsys.readouterr().out
    assert state.step == 1 and "done at step 1" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    from repro_torch.serve.__main__ import main
    main(["--arch", arch, "--reduced", "--device", "cpu", "--numerics", "amsim", "--batch", "2",
          "--prompt-len", "4", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "ms per decode step" in out
