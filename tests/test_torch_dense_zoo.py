"""The rest of the dense registry against the JAX package.

llava-next-34b (patch embeddings before the text: ``lm_forward(embeds=)``
and ``lm_loss``'s crop), qwen2.5-32b and qwen1.5-110b (q/k/v biases;
qwen1.5 trains with adafactor) and stablelm-12b (heads of 160: run here
at ``reduced(d_head=160)``, so that a head ends on a ragged 32-dim chunk
of the kernels' 64).  Each at ``configs.base.reduced`` (d 128, 2 layers,
heads of 32): JAX ``init_lm`` parameters, with the biases drawn nonzero,
are carried across with ``lm_params_from_jax``, and the same numpy tokens
and patch embeddings go through both packages.  Held here:
* the registry: every JAX arch builds in the port with JAX's values,
  llama4-maverick-400b-a17b too (its own tests: ``tests/test_torch_llama4.py``);
* ``lm_forward`` logits (B, F + S, vocab) under ``native`` and
  ``amsim_torch`` (JAX ``amsim_jnp``): atol = rtol = 1e-5, the limit of
  ``tests/test_torch_serve.py`` (rope, rsqrt and the softmax round apart
  in torch and XLA; the LUT products are the same);
* ``lm_loss`` and every gradient, bias gradients and the crop included:
  loss rtol 1e-5; ``native`` gradients rtol 1e-4 / atol 4e-6 x the leaf's
  largest element (the summation orders differ: stablelm's embedding
  gradient reads 1.5e-6 x); ``amsim_torch`` gradients in relative norm,
  ``AMSIM_GRAD_REL`` a leaf (see there), and the port's crop of the hidden
  states before the head bitwise the crop of the logits after it;
* a prefill (with the patches) into ring caches, then greedy decode
  steps through the decode chain: tokens equal to JAX's, logits within
  1e-5, rings of 24 (the chain's 2-launch form) and 136 (3 launches);
* one adafactor step of qwen1.5: ``launch.train.make_lm_train_step`` against
  JAX's ``make_train_step`` (loss rtol 1e-5, gradient norm rtol 1e-4), and
  its optimizer on JAX's clipped gradients against JAX's step
  (parameters rtol 1e-5 / atol 1e-7, the adafactor limit of
  ``tests/test_torch_lm_train.py``);
* the converters with biases, ``lm_batch``'s patches and the CLIs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_REGISTRY as JAX_ARCHS  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.policy import NumericsPolicy as JaxPolicy  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import optimizers as joptim  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs.base import MoEConfig, get_arch, reduced  # noqa: E402
from repro_torch.convert import (lm_opt_state_from_jax, lm_params_from_jax,  # noqa: E402
                                 lm_params_to_numpy, lm_tree_to_numpy)
from repro_torch.core.float_bits import np_bits  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.data.pipeline import lm_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.transformer import (init_lm_caches, label_xent,  # noqa: E402
                                            lm_forward, lm_loss)
from repro_torch.serve.engine import make_serve_step  # noqa: E402

ZOO = ["llava-next-34b", "qwen2.5-32b", "qwen1.5-110b", "stablelm-12b"]
# stablelm-12b's own heads of 160 at the reduced widths (JAX's reduced
# takes the same override).
OVERRIDES = {"stablelm-12b": {"d_head": 160}}
POLICIES = {
    "native": (NumericsPolicy(), JaxPolicy()),
    "amsim_torch": (NumericsPolicy(mode="amsim_torch", multiplier="afm16"),
                    JaxPolicy(mode="amsim_jnp", multiplier="afm16")),
}
B, S, N_NEW = 2, 8, 3
# amsim_torch gradients against JAX's amsim_jnp, in relative norm a leaf.
# Each block's backward is JAX's within 1e-6 given the same cotangent
# (``test_each_block_s_backward_is_jax_s_given_the_same_cotangent``); the
# gap enters at the top, where the cross-entropy's and the final norm's
# backward round apart in torch and XLA (2.7e-6 in relative norm at the
# stack's output, qwen2.5), and grows through the blocks where such a
# difference carries an operand of a LUT product across one of afm16's
# 7-bit truncation steps.  Readings of the worst leaf: llava 1.5e-7,
# stablelm 2.1e-3, qwen2.5 and qwen1.5 3.2e-3; with wrong numerics
# (``test_amsim_limits_fail_wrong_numerics``): afm10 5.7e-2 - 6.9e-2,
# exact attention 9.9e-2 - 1.1e-1.
AMSIM_GRAD_REL = 1e-2


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


def _carried(arch):
    """(port cfg, JAX cfg, JAX params as numpy with nonzero q/k/v biases,
    tokens (B, S), patch embeddings (B, F, d) or None) of a reduced arch,
    made once a module."""
    if arch not in _CARRIED:
        cfg = reduced(get_arch(arch), **OVERRIDES.get(arch, {}))
        jcfg = jax_reduced(jax_get_arch(arch), **OVERRIDES.get(arch, {}))
        params = jax.tree_util.tree_map(np.asarray, jtransformer.init_lm(jax.random.PRNGKey(0),
                                                                         jcfg))
        rng = np.random.default_rng(0)
        if cfg.qkv_bias:
            attn = params["layers"]["attn"]
            for name in ("wq", "wk", "wv"):
                attn[name]["b"] = (0.1 * rng.standard_normal(attn[name]["b"].shape)
                                   ).astype(np.float32)
        tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        F = cfg.n_frontend_tokens
        embeds = rng.standard_normal((B, F, cfg.d_model)).astype(np.float32) if F else None
        _CARRIED[arch] = (cfg, jcfg, params, tokens, embeds)
    return _CARRIED[arch]


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _labels(tokens):
    return np.concatenate([tokens[:, 1:], np.full((tokens.shape[0], 1), -1, np.int32)], axis=1)


def _batches(tokens, embeds):
    """(JAX batch, port batch) of the same numpy arrays."""
    labels = _labels(tokens)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    if embeds is not None:
        jbatch["embeds"], batch["embeds"] = jnp.asarray(embeds), torch.from_numpy(embeds)
    return jbatch, batch


def _leaves_close(port_tree, jax_tree, rtol, atol):
    jl = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    pl = jax.tree_util.tree_leaves(port_tree)
    assert len(jl) == len(pl)
    for (path, b), a in zip(jl, pl):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _rel_norm(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def _port_grad_tree(arch, policy):
    """(loss, the JAX-layout gradient tree) of the port's ``lm_loss`` on
    the carried arch."""
    cfg, _, params, tokens, embeds = _carried(arch)
    model = lm_params_from_jax(params, cfg, device="cpu")
    loss, _ = lm_loss(model, _batches(tokens, embeds)[1], policy)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), lm_tree_to_numpy(dict(zip(named, grads)))


def _worst_rel(port_tree, jax_tree):
    return max(_rel_norm(a, b) for a, b in zip(jax.tree_util.tree_leaves(port_tree),
                                               jax.tree_util.tree_leaves(jax_tree)))


# ---------------------------------------------------------------- registry
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_every_jax_arch_but_llama4_builds_with_jax_values(arch):
    """The port's config carries JAX's value in each of its fields, at full
    width and at ``reduced``; its head is JAX's."""
    def value(v):   # the MoE and SSM sub-configs are each package's own type
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v

    full, jfull = get_arch(arch), jax_get_arch(arch)
    for cfg, jcfg in ((full, jfull), (reduced(full), jax_reduced(jfull))):
        for field in dataclasses.fields(cfg):
            assert value(getattr(cfg, field.name)) == value(getattr(jcfg, field.name)), field.name
        assert cfg.head_dim == jcfg.head_dim


def test_llama4_still_raises():
    """llama4's interleaved MoE stack and shared expert are ported (the name
    is the one this test had while they raised): the registry holds it, and
    its MoE config, built from JAX's values, is the port's."""
    name = "llama4-maverick-400b-a17b"
    m = jax_get_arch(name).moe
    moe = MoEConfig(n_experts=m.n_experts, top_k=m.top_k, d_ff=m.d_ff, interleave=m.interleave,
                    n_shared_experts=m.n_shared_experts)
    assert get_arch(name).moe == moe and (moe.interleave, moe.n_shared_experts) == (2, 1)


def test_the_zoo_s_shapes():
    """Heads of 128 (llava 7168/56, qwen2.5 5120/40, qwen1.5 8192/64) and of
    160 (stablelm 5120/32); biases on the qwens; adafactor on qwen1.5; 2880
    patches before llava's text."""
    heads = {a: get_arch(a).head_dim for a in ZOO}
    assert heads == {"llava-next-34b": 128, "qwen2.5-32b": 128, "qwen1.5-110b": 128,
                     "stablelm-12b": 160}
    assert [a for a in ZOO if get_arch(a).qkv_bias] == ["qwen2.5-32b", "qwen1.5-110b"]
    assert [a for a in ZOO if get_arch(a).optimizer != "adamw"] == ["qwen1.5-110b"]
    assert get_arch("llava-next-34b").n_frontend_tokens == 2880
    assert reduced(get_arch("llava-next-34b")).n_frontend_tokens == 8


# ----------------------------------------------------------------- forward
@pytest.mark.parametrize("name", sorted(POLICIES))
@pytest.mark.parametrize("arch", ZOO)
def test_forward_matches_jax(arch, name):
    """Logits (B, F + S, vocab) of one uncached forward, llava's patches
    first (F = 8 at reduced)."""
    cfg, jcfg, params, tokens, embeds = _carried(arch)
    policy, jpolicy = POLICIES[name]
    want, _, _ = jax.jit(lambda p, t, e: jtransformer.lm_forward(p, t, jcfg, jpolicy, embeds=e)
                         )(params, jnp.asarray(tokens), _j(embeds))
    model = lm_params_from_jax(params, cfg, device="cpu")
    got, _, _ = lm_forward(model, torch.from_numpy(tokens), policy, embeds=_t(embeds))
    assert got.shape == (B, cfg.n_frontend_tokens + S, cfg.vocab) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- loss + gradients
_JAX_GRADS = {}


def _jax_loss_grads(arch, name):
    """JAX's loss, metrics and gradients of the carried arch, once a
    module."""
    if (arch, name) not in _JAX_GRADS:
        _, jcfg, params, tokens, embeds = _carried(arch)
        jbatch, _ = _batches(tokens, embeds)
        jpolicy = POLICIES[name][1]
        _JAX_GRADS[arch, name] = jax.jit(jax.value_and_grad(
            lambda p: jtransformer.lm_loss(p, jbatch, jcfg, jpolicy), has_aux=True))(params)
    return _JAX_GRADS[arch, name]


@pytest.mark.parametrize("name", sorted(POLICIES))
@pytest.mark.parametrize("arch", ZOO)
def test_loss_and_gradients_match_jax(arch, name):
    """``lm_loss`` and every gradient leaf (the q/k/v biases' too); llava's
    frontend positions carry no loss.  Limits: the module docstring."""
    cfg, _, params, _, _ = _carried(arch)
    (jloss, _), jgrads = _jax_loss_grads(arch, name)
    loss, grads = _port_grad_tree(arch, POLICIES[name][0])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    if cfg.qkv_bias:
        biases = grads["layers"]["attn"]
        assert all(np.abs(biases[n]["b"]).max() > 0 for n in ("wq", "wk", "wv"))
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


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "stablelm-12b"])
def test_amsim_limits_fail_wrong_numerics(arch):
    """The amsim limit tells numerics apart: afm10 for every product, or
    exact attention products, read far past ``AMSIM_GRAD_REL`` against
    JAX's afm16 gradients."""
    from repro_torch.core.policy import table_from_assignments
    (_, _), jgrads = _jax_loss_grads(arch, "amsim_torch")
    for policy in (NumericsPolicy(mode="amsim_torch", multiplier="afm10"),
                   table_from_assignments("attn_score=native,attn_value=native,"
                                          "default=amsim_torch:afm16")):
        _, grads = _port_grad_tree(arch, policy)
        assert _worst_rel(grads, jgrads) > 4 * AMSIM_GRAD_REL


def test_each_block_s_backward_is_jax_s_given_the_same_cotangent():
    """Where the amsim gradients part (qwen2.5, 3.2e-3 at the worst leaf),
    each dense block's backward is JAX's: on the port's forward states and
    JAX's cotangent at the block's output, the input gradient and every
    parameter gradient of the block agree within 1e-6 in relative norm.
    The cotangents the stack hands down part by 2.7e-6 at its top and by
    more below (``AMSIM_GRAD_REL``)."""
    from repro_torch.models import transformer as ptransformer
    arch = "qwen2.5-32b"
    cfg, jcfg, params, tokens, _ = _carried(arch)
    policy, jpolicy = POLICIES["amsim_torch"]
    model = lm_params_from_jax(params, cfg, device="cpu")
    layers = [jax.tree_util.tree_map(lambda a, i=i: a[i], params["layers"])
              for i in range(cfg.n_layers)]

    def jblock(i):
        return lambda p, x: jtransformer._dense_block(p, x, jcfg, jpolicy, None, 0)[0]

    def jtail(x, start):     # JAX's loss from the output of block start - 1
        for i in range(start, cfg.n_layers):
            x = jblock(i)(layers[i], x)
        logits = jtransformer.linear(params["head"], jtransformer.rmsnorm(
            params["final_norm"], x, jcfg.norm_eps), jpolicy, kind="column", site="head")
        return _xent(logits, tokens)

    xs = [model.embed.emb.detach()[torch.from_numpy(tokens).long()]]
    with torch.no_grad():
        for layer in model.layers:
            xs.append(ptransformer._dense_block(layer, xs[-1], cfg, policy, None, 0)[0])
    for i, layer in enumerate(model.layers):
        cot = jax.grad(jtail)(jnp.asarray(xs[i + 1].numpy()), i + 1)
        _, vjp = jax.vjp(jblock(i), layers[i], jnp.asarray(xs[i].numpy()))
        jp, jx = vjp(cot)
        x = xs[i].clone().requires_grad_(True)
        out, _, _ = ptransformer._dense_block(layer, x, cfg, policy, None, 0)
        names = [n for n, _ in layer.named_parameters()]
        got = torch.autograd.grad(out, [x, *layer.parameters()], torch.from_numpy(np.asarray(cot)))
        assert _rel_norm(got[0].numpy(), jx) < 1e-6
        want = {".".join(str(k.key) for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
        for n, g in zip(names, got[1:]):
            assert _rel_norm(g.numpy(), want[n]) < 1e-6, (i, n)


def _xent(logits, tokens):
    """JAX ``lm_loss``'s cross-entropy of logits at the shifted tokens."""
    labels = jnp.asarray(_labels(tokens))
    valid = labels >= 0
    lse = jax.nn.logsumexp(logits, axis=-1)
    iota = jax.lax.broadcasted_iota(jnp.int32, logits.shape, 2)
    ll = jnp.sum(jnp.where(iota == jnp.maximum(labels, 0)[..., None], logits, 0.0), axis=-1)
    return jnp.sum(jnp.where(valid, lse - ll, 0.0)) / jnp.maximum(jnp.sum(valid), 1)


def test_cropping_before_the_head_keeps_every_bit():
    """``lm_loss`` crops llava's hidden states to the text before the head;
    JAX crops the logits after it.  Under ``amsim_torch`` (the LUT products
    of ``amsim``) the loss and every gradient are bitwise the crop-after
    form: the head's rows are independent, and its dw folds the cropped
    rows' zero gradients in order from +0.0, which adds nothing."""
    cfg, _, params, tokens, embeds = _carried("llava-next-34b")
    _, batch = _batches(tokens, embeds)
    policy = POLICIES["amsim_torch"][0]
    model = lm_params_from_jax(params, cfg, device="cpu")
    loss, _ = lm_loss(model, batch, policy)
    got = [loss, *torch.autograd.grad(loss, list(model.parameters()))]
    logits, _, _ = lm_forward(model, batch["tokens"], policy, embeds=batch["embeds"], train=True)
    assert logits.shape[1] == cfg.n_frontend_tokens + S
    after = label_xent(logits[:, cfg.n_frontend_tokens:], batch["labels"])
    want = [after, *torch.autograd.grad(after, list(model.parameters()))]
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# -------------------------------------------------- prefill + chain decode
def _jax_greedy(jcfg, params, tokens, embeds, jpolicy, max_len):
    """JAX's prefill (with the patches) into ring caches, then greedy
    steps of ``make_serve_step``: (tokens, the logits choosing each, the
    prefill's logits)."""
    caches = jtransformer.init_lm_caches(jcfg, tokens.shape[0], max_len)
    fwd = jax.jit(lambda p, t, e, c: jtransformer.lm_forward(p, t, jcfg, jpolicy, embeds=e,
                                                             caches=c))
    step = jax.jit(jengine.make_serve_step(jcfg, jpolicy))
    logits, caches, _ = fwd(params, jnp.asarray(tokens), _j(embeds), caches)
    nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    kept, toks = [np.asarray(logits[:, -1:])], [np.asarray(nxt)]
    for _ in range(N_NEW - 1):
        lg, nxt, caches = step(params, nxt, caches)
        kept.append(np.asarray(lg))
        toks.append(np.asarray(nxt))
    return np.concatenate(toks, 1), np.concatenate(kept, 1), np.asarray(logits)


GREEDY_CASES = [(a, r) for a in ZOO for r in (24, 136)
                if r == 24 or a in ("qwen2.5-32b", "stablelm-12b")]


@pytest.mark.parametrize("name", sorted(POLICIES))
@pytest.mark.parametrize("arch,max_len", GREEDY_CASES)
def test_prefill_then_chain_decode_matches_jax(arch, max_len, name):
    """``lm_forward(embeds=, caches=)`` writes F + S positions into the
    rings; the decode steps then run one text token each, through the
    decode chain under ``amsim_torch`` (the biases added after its q/k/v
    products; the attention over heads of 160 at stablelm), with the
    2-launch (ring 24) and 3-launch (ring 136) forms.  Tokens equal to
    JAX's, logits within 1e-5."""
    cfg, jcfg, params, tokens, embeds = _carried(arch)
    policy, jpolicy = POLICIES[name]
    assert ops.decode_chain_enabled(policy) == (name == "amsim_torch")
    want_toks, want_logits, want_prefill = _jax_greedy(jcfg, params, tokens, embeds, jpolicy,
                                                       max_len)
    model = lm_params_from_jax(params, cfg, device="cpu")
    caches = init_lm_caches(cfg, B, max_len, "cpu")
    logits, caches, _ = lm_forward(model, torch.from_numpy(tokens), policy, embeds=_t(embeds),
                                   caches=caches)
    assert caches[0]["len"] == cfg.n_frontend_tokens + S
    np.testing.assert_allclose(logits.numpy(), want_prefill, rtol=1e-5, atol=1e-5)
    step = make_serve_step(model, policy)
    nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    toks, kept = [nxt], [logits[:, -1:]]
    for _ in range(N_NEW - 1):
        lg, nxt, caches = step(nxt, caches)
        toks.append(nxt)
        kept.append(lg)
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), want_toks)
    np.testing.assert_allclose(torch.cat(kept, 1).numpy(), want_logits, rtol=1e-5, atol=1e-5)


def test_llava_prefill_with_patches_decodes_like_one_long_forward():
    """Greedy decoding after a prefill with the patches equals the argmax of
    one uncached forward over the patches, the prompt and the generated
    tokens (the ring holds F + S + new positions)."""
    cfg, _, params, tokens, embeds = _carried("llava-next-34b")
    policy = POLICIES["amsim_torch"][0]
    model = lm_params_from_jax(params, cfg, device="cpu")
    caches = init_lm_caches(cfg, B, 24, "cpu")
    logits, caches, _ = lm_forward(model, torch.from_numpy(tokens), policy,
                                   embeds=torch.from_numpy(embeds), caches=caches)
    step = make_serve_step(model, policy)
    nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out = [nxt]
    for _ in range(N_NEW - 1):
        _, nxt, caches = step(nxt, caches)
        out.append(nxt)
    out = torch.cat(out, 1)
    full = torch.cat([torch.from_numpy(tokens).long(), out[:, :-1].long()], dim=1)
    logits, _, _ = lm_forward(model, full, NumericsPolicy(mode="amsim_torch", multiplier="afm16"),
                              embeds=torch.from_numpy(embeds))
    F = cfg.n_frontend_tokens
    assert torch.equal(logits[:, F + S - 1:].argmax(-1), out.long())


# ------------------------------------------------------------- training
def test_qwen1_5_takes_one_adafactor_step_like_jax():
    """One step of ``launch.train.make_lm_train_step`` (the config's
    adafactor over ``cosine_schedule(lr, 10, steps)``, clip 1.0) against
    JAX's ``make_train_step`` with the same optimizer, under ``native``: the
    loss within rtol 1e-5 and the gradient norm within 1e-4.  Then the
    step's optimizer and JAX's on the same clipped gradients: every
    parameter, the biases too, within rtol 1e-5 / atol 1e-7 (adafactor
    normalises each update, so gradients that differ in their last bits
    would move the smallest entries apart).  The factored state holds a row
    and a column factor for each matrix."""
    from repro_torch.optim.optimizers import apply_updates
    arch = "qwen1.5-110b"
    cfg, jcfg, params, tokens, _ = _carried(arch)
    assert cfg.optimizer == jcfg.optimizer == "adafactor"
    jbatch, batch = _batches(tokens, None)
    opt, step = launch_train.make_lm_train_step(cfg, NumericsPolicy(), lr=1e-2, steps=4)
    jopt = joptim.make_optimizer("adafactor", joptim.cosine_schedule(1e-2, 10, 4))
    jloss_fn = lambda p, b: jtransformer.lm_loss(p, b, jcfg, JaxPolicy())  # noqa: E731
    jparams, _, jmet = jax.jit(jstep.make_train_step(jloss_fn, jopt))(params, jopt.init(params),
                                                                      jbatch)
    model = lm_params_from_jax(params, cfg, device="cpu")
    state, met = step(model, opt.init(dict(model.named_parameters())), batch)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    f = state["f"]["layers.attn.wq.w"]
    assert tuple(f["r"].shape) == (cfg.n_layers, cfg.d_model)
    assert tuple(f["c"].shape) == (cfg.n_layers, cfg.n_heads * cfg.head_dim)

    jgrads = jax.grad(lambda p: jloss_fn(p, jbatch)[0])(params)
    jgrads, _ = joptim.clip_by_global_norm(jgrads, 1.0)
    jupdates, _ = jopt.update(jgrads, jopt.init(params), params)
    jparams = joptim.apply_updates(params, jupdates)
    model = lm_params_from_jax(params, cfg, device="cpu")
    flat = dict(model.named_parameters())
    port_grads = lm_opt_state_from_jax({"step": 0, "m": jgrads}, device="cpu")["m"]
    updates, _ = opt.update(port_grads, opt.init(flat), flat)
    apply_updates(flat, updates)
    _leaves_close(lm_params_to_numpy(model), jax.tree_util.tree_map(np.asarray, jparams),
                  rtol=1e-5, atol=1e-7)
    moved = lm_params_to_numpy(model)["layers"]["attn"]["wq"]["b"]
    assert not np.array_equal(moved, params["layers"]["attn"]["wq"]["b"])


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "qwen1.5-110b"])
def test_converters_carry_the_biases_both_ways(arch):
    """The q/k/v biases ``b`` land on their ``Linear``s and come back leaf
    for leaf; ``wo`` has none."""
    cfg, _, params, _, _ = _carried(arch)
    model = lm_params_from_jax(params, cfg, device="cpu")
    assert model.layers[1].attn["wv"].b is not None and model.layers[1].attn["wo"].b is None
    np.testing.assert_array_equal(model.layers[1].attn["wk"].b.detach().numpy(),
                                  params["layers"]["attn"]["wk"]["b"][1])
    back = lm_params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np_bits(a), np_bits(np.asarray(b)))


def test_lm_batch_puts_llava_s_patches_before_its_text():
    """A decoder-only frontend's batch: (B, F, d) patches and S - F text
    tokens with their labels, as JAX's ``lm_batch`` shapes them."""
    cfg = reduced(get_arch("llava-next-34b"))
    batch = lm_batch(cfg, (2, 20), 0)
    assert batch["embeds"].shape == (2, cfg.n_frontend_tokens, cfg.d_model)
    assert batch["tokens"].shape == batch["labels"].shape == (2, 20 - cfg.n_frontend_tokens)
    loss, _ = lm_loss(lm_params_from_jax(_carried("llava-next-34b")[2], cfg, device="cpu"),
                      batch, NumericsPolicy())
    assert bool(torch.isfinite(loss))


def test_train_cli_trains_llava_and_refuses_a_seq_without_text(capsys):
    """``launch.train --arch llava-next-34b``: a step over 8 patches and 4
    text tokens; ``--seq`` not past the patches exits before any work."""
    argv = ["--arch", "llava-next-34b", "--reduced", "--device", "cpu", "--steps", "1",
            "--batch", "1"]
    state = launch_train.main(argv + ["--seq", "12"])
    assert state.step == 1
    with pytest.raises(SystemExit, match="must exceed 8"):
        launch_train.main(argv + ["--seq", "8"])


def test_serve_cli_serves_the_new_archs(capsys):
    """``python -m repro_torch.serve`` on llava (text tokens only) and on
    qwen1.5 (biases) at the reduced widths."""
    from repro_torch.serve import __main__ as serve_main
    for arch in ("llava-next-34b", "qwen1.5-110b"):
        serve_main.main(["--arch", arch, "--reduced", "--device", "cpu", "--numerics",
                         "amsim", "--batch", "2", "--prompt-len", "4", "--new-tokens", "2"])
        out = capsys.readouterr().out
        assert "decode chain: fused" in out and f"{arch}-smoke" in out
