"""The port's LM serving slice against the JAX package's.

``reduced(get_arch("granite-3-2b"), n_layers=2)``: JAX ``init_lm``
parameters are carried across with ``lm_params_from_jax``, and the same
prompts (numpy, from a seed) go through the JAX engine and the port's.
Prefill and decode logits and the greedy tokens are held against JAX
under ``native`` and ``amsim_torch`` (JAX: ``amsim_jnp``), with a ring of
at most 128 slots (the decode chain's 2-launch form) and of more (its
3-launch form).  Then the twins of ``tests/test_serve.py``, the converter
and the CLI.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.policy import NumericsPolicy as JaxPolicy  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs.base import get_arch, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import init_lm, lm_forward  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _own_lut_dir(tmp_path_factory):
    """The JAX package caches LUTs on disk through one fixed temporary name
    per table; give this module its own directory, so that it never writes
    the shared one while another test process reads it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DIR", str(tmp_path_factory.mktemp("luts")))
        yield


CFG = reduced(get_arch("granite-3-2b"), n_layers=2)
JAX_CFG = jax_reduced(jax_get_arch("granite-3-2b"), n_layers=2)
POLICIES = {
    "native": (NumericsPolicy(), JaxPolicy()),
    "amsim_torch": (NumericsPolicy(mode="amsim_torch", multiplier="afm16"),
                    JaxPolicy(mode="amsim_jnp", multiplier="afm16")),
}
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


@pytest.mark.parametrize("max_len", [16, 136])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_serving_matches_jax(carried, name, max_len):
    """Prefill logits over the whole prompt, the logits of every decode
    step and the greedy tokens.  The LUT products are the same in both
    packages; rope's cos/sin, the norms' rsqrt and the softmax and silu
    exps and sums round differently in torch and XLA on the CPU, and a LUT
    product may carry such an ulp across a truncation step.  Observed: at
    most 6e-7 (native) and 6e-8 (amsim) at logits of O(1); the tolerance
    is atol=rtol=1e-5, and the tokens are equal."""
    params, model, prompts = carried
    policy, jpolicy = POLICIES[name]
    toks, logits, prefill = _jax_generate(params, prompts, jpolicy, max_len)
    engine = ServingEngine(model, policy, max_len=max_len)
    out, kept = engine.generate(torch.from_numpy(prompts), N_NEW, return_logits=True)
    np.testing.assert_array_equal(out.numpy(), toks)
    np.testing.assert_allclose(kept.numpy(), logits, rtol=1e-5, atol=1e-5)
    full, _, _ = lm_forward(model, torch.from_numpy(prompts), policy)
    np.testing.assert_allclose(full.numpy(), prefill, rtol=1e-5, atol=1e-5)


def test_amsim_decodes_like_amsim_torch(carried):
    """On the CPU the ``amsim`` kernels run their plain versions: the whole
    engine gives the same bits under both modes, in both chain forms."""
    _, model, prompts = carried
    for max_len in (16, 136):
        runs = [ServingEngine(model, NumericsPolicy(mode=mode, multiplier="afm16"),
                              max_len=max_len).generate(torch.from_numpy(prompts), N_NEW,
                                                        return_logits=True)
                for mode in ("amsim", "amsim_torch")]
        assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_generate_matches_full_prefill_argmax(name):
    """Twin of tests/test_serve.py: greedy decode through the ring cache
    equals the argmax of one uncached prefill over prompt + generated."""
    policy = POLICIES[name][0]
    cfg = reduced(get_arch("granite-3-2b"), n_layers=1)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(7), device="cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 5), generator=torch.Generator().manual_seed(7))
    out = ServingEngine(model, policy, max_len=16).generate(prompts, max_new_tokens=4)
    assert out.shape == (2, 4)
    full = torch.cat([prompts, out[:, :-1].to(prompts.dtype)], dim=1)
    logits, _, _ = lm_forward(model, full, policy)
    pred = logits[:, prompts.shape[1] - 1:].argmax(-1)
    assert torch.equal(out.to(pred.dtype), pred)


def test_generate_rejects_ring_overflow():
    cfg = reduced(get_arch("granite-3-2b"), n_layers=1)
    engine = ServingEngine(init_lm(cfg, device="cpu"), NumericsPolicy(), max_len=16)
    prompts = torch.randint(0, cfg.vocab, (1, 10), generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="max_len"):
        engine.generate(prompts, max_new_tokens=7)
    assert engine.generate(prompts, max_new_tokens=6).shape == (1, 6)


def test_engine_threads_window_into_decode_steps():
    """Twin of tests/test_serve.py: an architecture-level window matches
    the windowed recompute oracle, and an engine-level window reaches
    every decode step."""
    cfg = reduced(get_arch("granite-3-2b"), n_layers=1)
    assert cfg.sliding_window == 0
    gen = torch.Generator().manual_seed(3)
    model = init_lm(cfg, generator=gen, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 6), generator=gen)
    W, T = 4, 6
    pol = NumericsPolicy()
    cfgw = dataclasses.replace(cfg, sliding_window=W)
    model_w = init_lm(cfgw, generator=torch.Generator().manual_seed(3), device="cpu")
    out = ServingEngine(model_w, pol, max_len=16).generate(prompts, max_new_tokens=T)
    full = torch.cat([prompts, out[:, :-1].to(prompts.dtype)], dim=1)
    logits, _, _ = lm_forward(model_w, full, pol)
    assert torch.equal(out.to(torch.int64), logits[:, prompts.shape[1] - 1:].argmax(-1))
    outw = ServingEngine(model, pol, max_len=16, window=W).generate(prompts, max_new_tokens=T)
    out0 = ServingEngine(model, pol, max_len=16).generate(prompts, max_new_tokens=T)
    assert not torch.equal(outw, out0)


def test_lm_params_from_jax_round_trip(carried):
    params, model, _ = carried
    flat = dict(model.named_parameters())
    assert sum(p.numel() for p in flat.values()) == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(params))
    np.testing.assert_array_equal(flat["embed.emb"].detach().numpy(), params["embed"]["emb"])
    for i in range(CFG.n_layers):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(flat[f"layers.{i}.attn.{name}.w"].detach().numpy(),
                                          params["layers"]["attn"][name]["w"][i])
        np.testing.assert_array_equal(flat[f"layers.{i}.ffn.wd.w"].detach().numpy(),
                                      params["layers"]["ffn"]["wd"]["w"][i])
    # The tied head's operand is the transpose, contiguous.
    assert model.embed.emb_t.is_contiguous()
    assert torch.equal(model.embed.emb_t, model.embed.emb.detach().T)
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["layers"]["n1"]["g"] = bad["layers"]["n1"]["g"][:, :-1]
    with pytest.raises(ValueError, match="shapes differ"):
        lm_params_from_jax(bad, CFG, device="cpu")


def test_arch_configs_match_jax():
    full, jfull = get_arch("granite-3-2b"), jax_get_arch("granite-3-2b")
    for cfg, jcfg in ((full, jfull), (CFG, JAX_CFG)):
        for field in dataclasses.fields(cfg):
            assert getattr(cfg, field.name) == getattr(jcfg, field.name), field.name
        assert cfg.head_dim == jcfg.head_dim


def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.serve.__main__ import main
    main(["--reduced", "--device", "cpu", "--numerics", "native", "--batch", "2",
          "--prompt-len", "4", "--new-tokens", "3", "--n-layers", "1"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "ms per decode step" in out


def test_decode_uses_the_chain_under_amsim(carried, monkeypatch):
    """A decode step under ``amsim`` goes through the chain's ops: 2 per
    layer with a ring of at most 128 slots, qkv + attention + back half
    (3) above; prefill through none of them."""
    _, model, prompts = carried
    calls = []
    for name in ("decode_qkv", "decode_out_mlp_b", "decode_attn_out_mlp", "policy_attention"):
        orig = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _o=orig, _n=name, **k: (calls.append(_n),
                                                                          _o(*a, **k))[1])
    from repro_torch.models import attention as attention_mod
    monkeypatch.setattr(attention_mod, "policy_attention", ops.policy_attention)
    policy = NumericsPolicy(mode="amsim", multiplier="afm16")
    for max_len, per_layer in ((16, ["decode_qkv", "decode_attn_out_mlp"]),
                               (136, ["decode_qkv", "policy_attention", "decode_out_mlp_b"])):
        calls.clear()
        ServingEngine(model, policy, max_len=max_len).generate(torch.from_numpy(prompts), 2)
        prefill = ["policy_attention"] * CFG.n_layers
        assert calls == prefill + per_layer * CFG.n_layers
