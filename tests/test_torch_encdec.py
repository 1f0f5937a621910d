"""The port's encoder-decoder family (whisper-style) against the JAX
package's.

Reduced whisper-base (``configs.base.reduced``: 2 encoder + 2 decoder
layers, d 128, 4 heads over 2 KV heads of 32, 8 frames): JAX
``init_encdec`` parameters are carried across with
``encdec_params_from_jax`` and the same numpy inputs go through both
packages in one process.  Held here:
* ``attention`` with ``kv_src`` (cross-attention, S != T, no rope) and
  bidirectional self-attention, under native and amsim_torch / amsim_jnp,
  and ``amsim`` (the kernel's plain version here) == ``amsim_torch``;
* ``encode`` and ``decode`` (rtol 1e-5), greedy tokens of ``serve_step``
  through ring caches equal to JAX's decode cell's;
* ``encdec_loss`` and every gradient against ``jax.grad``, remat keeping
  the bits;
* the converters both ways, adamw bitwise and adafactor on the stacked
  ``enc_layers`` / ``dec_layers`` leaves;
* ``lm_batch``'s frames, the serving entry points' refusal and the
  ``launch.train`` CLI.
The card's ``amsim`` == ``amsim_torch`` at full width lives in
``test_torch_cuda.py``; the attention kernel's bidirectional cases in
``test_torch_attention.py`` and ``test_torch_attention_plan.py``.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.policy import NumericsPolicy as JaxPolicy  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.optim import optimizers as joptim  # noqa: E402
from repro_torch.configs.base import ArchConfig, get_arch, reduced  # noqa: E402
from repro_torch.convert import (encdec_params_from_jax, encdec_params_to_numpy,  # noqa: E402
                                 lm_opt_state_from_jax, lm_opt_state_to_numpy, lm_tree_to_numpy)
from repro_torch.core.float_bits import np_bits  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.data.pipeline import lm_batch  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402

ARCH = "whisper-base"
POLICIES = {
    "native": (NumericsPolicy(), JaxPolicy()),
    "amsim_torch": (NumericsPolicy(mode="amsim_torch", multiplier="afm16"),
                    JaxPolicy(mode="amsim_jnp", multiplier="afm16")),
}
AMSIM = NumericsPolicy(mode="amsim", multiplier="afm16")
B, P, N_NEW = 2, 5, 4
# Under amsim an operand an ulp apart can cross one of afm16's 7-bit
# truncation steps: a 2^-8 relative change in that product.  torch's and
# XLA's gelu differ by an ulp on about a third of their outputs, rmsnorm and
# softmax on a few, and at these widths a LUT GEMM truncates ~10^5 such
# operands, so the two packages part by a few truncation steps a layer,
# which the next layers carry on.  With XLA's gelu values swapped in, the
# reduced decoder's logits on ``_jax_forward``'s input are JAX's within
# 1e-5 (``test_the_amsim_gap_is_gelus_last_bit``); on other inputs
# rmsnorm's ulps can still cross a step.  So amsim outputs and gradients
# are held in relative norm (||port - JAX|| / ||JAX||) against JAX's
# jitted run, each limit a few times the port's own gap (measured: encoder
# states 7.7e-8, logits 7.1e-4, greedy logits 6.0e-9, the loss 2.1e-5, the
# worst gradient leaf 9.1e-3, enc_layers.attn.wk), and the tokens exactly;
# ``test_amsim_limits_fail_wrong_numerics`` shows afm10 and a native site
# reading far past them.  Native: rtol = atol = 1e-5 (forward), rtol 1e-4
# and atol 1e-6 (gradients).
AMSIM_FWD_REL = 4e-3
AMSIM_LOSS_RTOL = 1e-4
AMSIM_GRAD_REL = 2e-2


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
    """(port cfg, JAX cfg, JAX params as numpy, port model), made once a
    module."""
    if not _CARRIED:
        cfg, jcfg = reduced(get_arch(ARCH)), jax_reduced(jax_get_arch(ARCH))
        params = jax.tree_util.tree_map(np.asarray,
                                        jencdec.init_encdec(jax.random.PRNGKey(0), jcfg))
        _CARRIED["v"] = (cfg, jcfg, params, encdec_params_from_jax(params, cfg, device="cpu"))
    return _CARRIED["v"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _frames(cfg, seed=0, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _rel_norm(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _forward_close(got, want, name, what):
    """A forward output against JAX's: rtol = atol = 1e-5 under native, in
    relative norm under amsim (see ``AMSIM_FWD_REL``)."""
    got, want = np.asarray(got), np.asarray(want)
    if name == "native":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=what)
    else:
        assert _rel_norm(got, want) <= AMSIM_FWD_REL, (what, _rel_norm(got, want))


# ---------------------------------------------------------------- configs
def test_arch_config_matches_jax():
    full, jfull = get_arch(ARCH), jax_get_arch(ARCH)
    for cfg, jcfg in ((full, jfull), (reduced(full), jax_reduced(jfull))):
        for field in dataclasses.fields(cfg):
            assert getattr(cfg, field.name) == getattr(jcfg, field.name), field.name
        assert cfg.head_dim == jcfg.head_dim
    r = reduced(full)
    assert (r.n_enc_layers, r.n_layers, r.n_frontend_tokens, r.d_model) == (2, 2, 8, 128)
    assert (full.n_enc_layers, full.n_frontend_tokens, full.act) == (6, 1500, "gelu")


def test_decoder_only_frontends_wait_for_their_slice():
    """A decoder-only LM with frontend tokens (llava) builds now that its
    slice is ported (``tests/test_torch_dense_zoo.py`` holds it against
    JAX); an encdec without an encoder raises."""
    vlm = ArchConfig(name="vlm", family="dense", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=4, d_ff=128, vocab=64, n_frontend_tokens=16, frontend="vision")
    assert (vlm.family, vlm.n_enc_layers, vlm.n_frontend_tokens) == ("dense", 0, 16)
    with pytest.raises(ValueError, match="n_enc_layers"):
        dataclasses.replace(get_arch(ARCH), n_enc_layers=0)


def test_param_shapes_and_names_follow_jax():
    """``encdec_param_shapes`` is the shape of JAX's tree with the
    ``enc_layers`` / ``dec_layers`` stacks unstacked; ``init_encdec`` draws
    those tensors; ``encdec_stacks`` groups them into JAX's leaves."""
    cfg, _, params, _ = _carried()
    jshapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = ".".join(str(k.key) for k in path)
        top, _, rest = name.partition(".")
        if top in ("enc_layers", "dec_layers"):
            for i in range(leaf.shape[0]):
                jshapes[f"{top}.{i}.{rest}"] = leaf.shape[1:]
        else:
            jshapes[name] = leaf.shape
    assert encdec.encdec_param_shapes(cfg) == jshapes
    model = encdec.init_encdec(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == jshapes
    stacks = encdec.encdec_stacks(cfg)
    jleaves = {".".join(str(k.key) for k in path) for path, _ in
               jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(stacks) == {n for n in jleaves if n.split(".")[0].endswith("_layers")}
    assert stacks["dec_layers.cross.wk.w"] == [f"dec_layers.{i}.cross.wk.w" for i in range(2)]


# ---------------------------------------------------------------- attention
# (S query tokens, kv_src frames or None, causal, use_rope)
ATTN_CASES = {
    "bidirectional_self": (8, None, False, True),
    "bidirectional_self_no_rope": (8, None, False, False),
    "cross_S5_T8": (5, 8, False, False),
    "cross_decode_T8": (1, 8, False, False),
}


def _attention_pair(case, policy_name, seed=0):
    cfg, jcfg, params, model = _carried()
    S, T, causal, use_rope = ATTN_CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    src = None if T is None else rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    top, name = ("enc_layers", "attn") if T is None else ("dec_layers", "cross")
    jp = jax.tree_util.tree_map(lambda a: a[0], params[top][name])
    kw = dict(causal=causal, use_rope=use_rope)
    return cfg, jcfg, getattr(model, top)[0][name], jp, x, src, kw


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_cross_and_bidirectional_attention_match_jax(case, name):
    """Outputs within rtol = atol = 1e-5 of JAX's (its softmax sums and the
    LUT products' operands differ by ulps at most)."""
    cfg, jcfg, p, jp, x, src, kw = _attention_pair(case, name)
    policy, jpolicy = POLICIES[name]
    jsrc = None if src is None else jnp.asarray(src)
    want, _ = jax.jit(lambda jp, x, src: jattention.attention(jp, x, jcfg, jpolicy, kv_src=src,
                                                              **kw))(jp, jnp.asarray(x), jsrc)
    with torch.no_grad():
        got, _ = attention_mod.attention(p, _t(x), cfg, policy,
                                         kv_src=None if src is None else _t(src), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_amsim_attention_is_amsim_torch(case):
    """Under ``amsim`` the kernel (its plain version on the CPU) with
    ``causal=False``: the bits of the einsum lowering under amsim_torch,
    outputs and the recompute's dq, dk, dv (dk, dv of the frames when S !=
    T)."""
    cfg, _, p, _, x, src, kw = _attention_pair(case, "amsim_torch", seed=1)
    out, grads = [], []
    for policy in (AMSIM, POLICIES["amsim_torch"][0]):
        xs = [_t(x).requires_grad_()] + ([] if src is None else [_t(src).requires_grad_()])
        with torch.enable_grad():
            y, _ = attention_mod.attention(p, xs[0], cfg, policy,
                                           kv_src=xs[1] if src is not None else None, **kw)
            out.append(y)
            grads.append(torch.autograd.grad(y.square().sum(), xs))
    assert _bits_equal(out[0], out[1])
    for a, b in zip(*grads):
        assert _bits_equal(a, b)


def test_attention_refuses_kv_src_with_qkv_or_a_paged_cache():
    cfg, _, _, model = _carried()
    p = model.dec_layers[0]["cross"]
    x = torch.zeros((1, 1, cfg.d_model))
    src = torch.zeros((1, 3, cfg.d_model))
    q = torch.zeros((1, 1, cfg.n_heads, cfg.head_dim))
    kv = torch.zeros((1, 1, cfg.n_kv_heads, cfg.head_dim))
    with pytest.raises(ValueError, match="qkv= is decoder self-attention only"):
        attention_mod.attention(p, x, cfg, NumericsPolicy(), kv_src=src, qkv=(q, kv, kv))
    paged = {"ptab": torch.ones((1, 1), dtype=torch.int32), "start": torch.zeros(1,
                                                                                 dtype=torch.int32)}
    with pytest.raises(ValueError, match="paged KV caches are decoder-self-attention only"):
        attention_mod.attention(p, x, cfg, NumericsPolicy(), kv_src=src, cache=paged)


# ---------------------------------------------------------------- forward
_JAX_FORWARD = {}


def _jax_forward(name):
    """JAX's encoder states and uncached decoder logits on ``_frames`` and
    the prompt tokens, made once a module."""
    if name not in _JAX_FORWARD:
        cfg, jcfg, params, _ = _carried()
        jpolicy = POLICIES[name][1]
        tokens = np.random.default_rng(2).integers(0, cfg.vocab, (B, 8)).astype(np.int32)
        enc = jax.jit(lambda p, f: jencdec.encode(p, f, jcfg, jpolicy))(params,
                                                                         jnp.asarray(_frames(cfg)))
        logits, _ = jax.jit(lambda p, t, e: jencdec.decode(p, t, e, jcfg, jpolicy))(
            params, jnp.asarray(tokens), enc)
        _JAX_FORWARD[name] = (tokens, np.asarray(enc), np.asarray(logits))
    return _JAX_FORWARD[name]


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_encode_and_decode_match_jax(name):
    cfg, _, _, model = _carried()
    policy = POLICIES[name][0]
    tokens, jenc, jlogits = _jax_forward(name)
    enc = encdec.encode(model, _t(_frames(cfg)), policy)
    _forward_close(enc.numpy(), jenc, name, "encoder states")
    logits, caches = encdec.decode(model, _t(tokens).long(), _t(jenc), policy)
    assert caches is None
    _forward_close(logits.numpy(), jlogits, name, "logits")


def test_the_amsim_gap_is_gelus_last_bit(monkeypatch):
    """torch's and XLA's tanh gelu differ in the last bit on many outputs;
    with XLA's gelu values in the port's FFN, the amsim decoder's logits are
    JAX's within rtol = atol = 1e-5, where with torch's they part by a
    truncation step (more than 1e-3)."""
    from repro_torch.models import mlp
    tokens, jenc, jlogits = _jax_forward("amsim_torch")
    x = np.random.default_rng(9).standard_normal(4096).astype(np.float32) * 3
    xla = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x)))
    ours = mlp.F.gelu(_t(x), approximate="tanh").numpy()
    assert (xla.view(np.int32) != ours.view(np.int32)).mean() > 0.1
    policy, model = POLICIES["amsim_torch"][0], _carried()[3]
    logits, _ = encdec.decode(model, _t(tokens).long(), _t(jenc), policy)
    assert np.abs(logits.numpy() - jlogits).max() > 1e-3
    xla_gelu = jax.jit(jax.nn.gelu)
    monkeypatch.setattr(mlp.F, "gelu", lambda v, approximate: _t(xla_gelu(
        jnp.asarray(v.detach().numpy()))).clone())
    logits, _ = encdec.decode(model, _t(tokens).long(), _t(jenc), policy)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-5, atol=1e-5)


def _jax_greedy(jcfg, params, frames, prompts, jpolicy):
    """The JAX decode cell driven greedily: encode, the prompt through
    ``decode`` with caches, then one token a step; (tokens, logits kept)."""
    enc = jencdec.encode(params, jnp.asarray(frames), jcfg, jpolicy)
    caches = jencdec.init_encdec_caches(jcfg, prompts.shape[0], prompts.shape[1] + N_NEW)
    dec = jax.jit(lambda p, t, e, c: jencdec.decode(p, t, e, jcfg, jpolicy, caches=c))
    logits, caches = dec(params, jnp.asarray(prompts), enc, caches)
    toks, kept = [], []
    for _ in range(N_NEW):
        last = logits[:, -1:]
        nxt = jnp.argmax(last, -1).astype(jnp.int32)
        toks.append(np.asarray(nxt))
        kept.append(np.asarray(last))
        if len(toks) < N_NEW:
            logits, caches = dec(params, nxt, enc, caches)
    return np.concatenate(toks, 1), np.concatenate(kept, 1)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_greedy_tokens_match_jax(name):
    """``greedy`` (encode once, ``serve_step`` over the prompt and each new
    token through rings of prompt + new slots): JAX's tokens exactly, the
    logits that chose them as ``_forward_close`` holds them."""
    cfg, jcfg, params, model = _carried()
    policy, jpolicy = POLICIES[name]
    frames = _frames(cfg, seed=3)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (B, P)).astype(np.int32)
    jtoks, jlogits = _jax_greedy(jcfg, params, frames, prompts, jpolicy)
    _, toks, logits = encdec.greedy(model, _t(frames), _t(prompts).long(), N_NEW, policy)
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    _forward_close(logits.numpy(), jlogits, name, "greedy logits")


def test_amsim_greedy_is_amsim_torch():
    """On the CPU the ``amsim`` kernels run their plain versions: the
    encoder states, every step's logits and the tokens bit for bit."""
    cfg, _, _, model = _carried()
    frames = _t(_frames(cfg, seed=4))
    prompts = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (B, P)))
    runs = [encdec.greedy(model, frames, prompts, N_NEW, pol)
            for pol in (AMSIM, POLICIES["amsim_torch"][0])]
    assert all(_bits_equal(a, b) for a, b in zip(runs[0], runs[1]))


def test_greedy_equals_the_uncached_argmax():
    """Greedy decoding through the rings equals the argmax of one uncached
    decode over prompt + generated."""
    cfg, _, _, model = _carried()
    frames = _t(_frames(cfg, seed=5))
    prompts = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (B, P)))
    enc, toks, _ = encdec.greedy(model, frames, prompts, N_NEW, NumericsPolicy())
    full = torch.cat([prompts, toks[:, :-1].long()], dim=1)
    logits, _ = encdec.decode(model, full, enc, NumericsPolicy())
    assert torch.equal(toks.long(), logits[:, P - 1:].argmax(-1))


# ---------------------------------------------------------------- training
def _batch(cfg, seed=6):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, 8)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    return {"embeds": _frames(cfg, seed=seed), "tokens": tokens, "labels": labels}


def _port_batch(batch):
    return {k: _t(v).long() if k != "embeds" else _t(v) for k, v in batch.items()}


_JAX_GRADS = {}


def _jax_loss_and_grads(name):
    """(loss, [(path, gradient)]) of JAX's jitted ``encdec_loss`` on
    ``_batch``, made once a module."""
    if name not in _JAX_GRADS:
        _, jcfg, params, _ = _carried()
        jbatch = {k: jnp.asarray(v) for k, v in _batch(_carried()[0]).items()}
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jencdec.encdec_loss(p, jbatch, jcfg, POLICIES[name][1]),
            has_aux=True))(params)
        _JAX_GRADS[name] = (float(jloss), [
            (jax.tree_util.keystr(path), np.asarray(g))
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]])
    return _JAX_GRADS[name]


def _port_loss_and_grads(policy):
    """(loss, metrics, gradients in JAX's leaf order) of ``encdec_loss``."""
    cfg, _, _, model = _carried()
    loss, met = encdec.encdec_loss(model, _port_batch(_batch(cfg)), policy)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss, met, jax.tree_util.tree_leaves(lm_tree_to_numpy(dict(zip(named, grads))))


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_encdec_loss_and_gradients_match_jax(name):
    """One loss and every gradient leaf, ``enc_layers``' included, against
    ``jax.grad`` of JAX's jitted ``encdec_loss``: native loss rtol 1e-5 and
    leaves rtol 1e-4, atol 1e-6; amsim loss rtol ``AMSIM_LOSS_RTOL`` and
    leaves in relative norm (``AMSIM_GRAD_REL``)."""
    jloss, jleaves = _jax_loss_and_grads(name)
    loss, met, pleaves = _port_loss_and_grads(POLICIES[name][0])
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5 if name == "native"
                               else AMSIM_LOSS_RTOL)
    assert torch.equal(met["xent"], loss)
    assert len(jleaves) == len(pleaves)
    for (where, b), a in zip(jleaves, pleaves):
        assert np.isfinite(a).all() and np.abs(b).max() > 0, where
        if name == "native":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=where)
        else:
            assert _rel_norm(a, b) <= AMSIM_GRAD_REL, (where, _rel_norm(a, b))


@pytest.mark.parametrize("control", ["default=amsim_torch:afm10",
                                     "attn_score=native,default=amsim_torch:afm16"])
def test_amsim_limits_fail_wrong_numerics(control):
    """The amsim limits tell afm16 from a near miss: afm10 in its place, or
    the attention scores left exact, puts the logits, the loss and some
    gradient leaf past them."""
    from repro_torch.core.policy import table_from_assignments
    policy = table_from_assignments(control)
    tokens, jenc, jlogits = _jax_forward("amsim_torch")
    logits, _ = encdec.decode(_carried()[3], _t(tokens).long(), _t(jenc), policy)
    assert _rel_norm(logits.numpy(), jlogits) > 3 * AMSIM_FWD_REL
    jloss, jleaves = _jax_loss_and_grads("amsim_torch")
    loss, _, pleaves = _port_loss_and_grads(policy)
    assert abs(loss.item() - jloss) > 3 * AMSIM_LOSS_RTOL * abs(jloss)
    assert max(_rel_norm(a, b) for (_, b), a in zip(jleaves, pleaves)) > 3 * AMSIM_GRAD_REL


def test_remat_keeps_the_bits():
    """``cfg.remat`` recomputes each encoder and decoder block in the
    backward: the same loss and gradients under amsim as without."""
    cfg, _, params, _ = _carried()
    batch = _port_batch(_batch(cfg, seed=7))
    out = []
    for remat in (True, False):
        model = encdec_params_from_jax(params, dataclasses.replace(cfg, remat=remat),
                                       device="cpu")
        loss, _ = encdec.encdec_loss(model, batch, AMSIM)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    (l1, g1), (l2, g2) = out
    assert _bits_equal(l1, l2)
    assert all(_bits_equal(a, b) for a, b in zip(g1, g2))


def test_amsim_trains_like_amsim_torch_when_the_backward_chunks(monkeypatch):
    """64 frames with the attention backward's query chunk cut to 32 (as
    1500 frames split into 2 x 750 at full size): the encoder's dk and dv
    sum two chunks' folds under ``amsim`` (the kernel's recompute) and under
    ``amsim_torch`` (its plain version in the same structure), so loss and
    every gradient are bitwise alike."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "_BWD_Q_CHUNK", 32)
    cfg, _, params, _ = _carried()
    cfg = dataclasses.replace(cfg, n_frontend_tokens=64)
    model = encdec_params_from_jax(params, cfg, device="cpu")
    batch = lm_batch(cfg, (1, 8), 0)
    assert batch["embeds"].shape == (1, 64, cfg.d_model)
    calls = []
    recompute = ops.attend_einsum
    monkeypatch.setattr(ops, "attend_einsum", lambda q, *a, **kw: calls.append(q.shape[1])
                        or recompute(q, *a, **kw))
    out = []
    for policy in (AMSIM, POLICIES["amsim_torch"][0]):
        calls.clear()
        loss, _ = encdec.encdec_loss(model, batch, policy)
        out.append([loss, *torch.autograd.grad(loss, list(model.parameters()))])
        assert calls.count(32) == 2 * cfg.n_enc_layers      # the encoder's two chunks
    assert all(_bits_equal(a, b) for a, b in zip(*out))


# ---------------------------------------------------------------- optimizers
def _grad_trees(params, rng, steps):
    return [jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params) for _ in range(steps)]


def _port_grads(jax_grads):
    return lm_opt_state_from_jax({"step": 0, "m": jax_grads}, device="cpu")["m"]


def test_converters_round_trip(rng):
    """encdec_params_to_numpy inverts encdec_params_from_jax leaf for leaf;
    the optimizer-state converters invert each other for adamw and
    adafactor states of the encdec tree; a tree of another shape raises."""
    cfg, _, params, model = _carried()
    back = encdec_params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    m, v = _grad_trees(params, rng, 2)
    jadafactor = jax.jit(joptim.adafactor(1e-2).update)(m, joptim.adafactor(1e-2).init(params),
                                                        params)[1]
    for state in ({"m": m, "v": v, "step": np.int32(2)},
                  jax.tree_util.tree_map(np.asarray, jadafactor)):
        back = lm_opt_state_to_numpy(lm_opt_state_from_jax(state, device="cpu"))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(state)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(state)):
            np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="does not fit whisper-base-smoke"):
        encdec_params_from_jax(params, dataclasses.replace(cfg, n_enc_layers=1), device="cpu")


def test_adamw_bitwise_vs_jax(rng):
    """Three adamw steps on the carried model: parameters and both moments
    bitwise JAX's."""
    cfg, _, params, _ = _carried()
    sched, jsched = optimizers.cosine_schedule(1e-2, 2, 10), joptim.cosine_schedule(1e-2, 2, 10)
    opt = optimizers.make_optimizer("adamw", sched, weight_decay=0.01)
    jopt = joptim.make_optimizer("adamw", jsched, weight_decay=0.01)
    model = encdec_params_from_jax(params, cfg, device="cpu")
    flat = dict(model.named_parameters())
    state, jstate, jparams = opt.init(flat), jopt.init(params), params
    for jg in _grad_trees(params, rng, 3):
        upd, jstate = jopt.update(jg, jstate, jparams)
        jparams = joptim.apply_updates(jparams, upd)
        upd, state = opt.update(_port_grads(jg), state, flat)
        optimizers.apply_updates(flat, upd)
    got = {"params": encdec_params_to_numpy(model), **lm_opt_state_to_numpy(state)}
    want = {"params": jparams, "m": jstate["m"], "v": jstate["v"], "step": jstate["step"]}
    for (path, w), a in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np_bits(np.asarray(a)), np_bits(np.asarray(w)),
                                      err_msg=jax.tree_util.keystr(path))


def test_adafactor_matches_jax_on_the_stacked_leaves(rng):
    """Three adafactor steps with ``encdec_stacks``: each ``enc_layers`` /
    ``dec_layers`` leaf is one stacked tensor, as in JAX's tree (a gain of
    every layer one (L, d) leaf, factored; the clip RMS over every layer).
    Parameters and factors within rtol 1e-5 of JAX."""
    cfg, _, params, _ = _carried()
    opt = optimizers.make_optimizer("adafactor", 1e-2, stacks=encdec.encdec_stacks(cfg),
                                    weight_decay=0.01)
    jopt = joptim.make_optimizer("adafactor", 1e-2, weight_decay=0.01)
    model = encdec_params_from_jax(params, cfg, device="cpu")
    flat = dict(model.named_parameters())
    state, jstate, jparams = opt.init(flat), jopt.init(params), params
    grads = _grad_trees(params, rng, 3)
    grads[1]["dec_layers"]["n3"]["g"][0] *= 1e3      # the clip fires over the stacked leaf
    jupdate = jax.jit(jopt.update)
    for jg in grads:
        upd, jstate = jupdate(jg, jstate, jparams)
        jparams = joptim.apply_updates(jparams, upd)
        upd, state = opt.update(_port_grads(jg), state, flat)
        optimizers.apply_updates(flat, upd)
    f = state["f"]
    assert tuple(f["enc_layers.n1.g"]["r"].shape) == (cfg.n_enc_layers,)
    assert tuple(f["dec_layers.cross.wq.w"]["r"].shape) == (cfg.n_layers, cfg.d_model)
    assert set(f["enc_norm.g"]) == {"v"}
    for tree, jtree, atol in ((encdec_params_to_numpy(model), jparams, 1e-7),
                              (lm_opt_state_to_numpy(state)["f"], jstate["f"], 1e-30)):
        jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
        pl = jax.tree_util.tree_leaves(tree)
        assert len(jl) == len(pl)
        for (path, b), a in zip(jl, pl):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=atol,
                                       err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------- data, CLIs
def test_lm_batch_draws_the_frames():
    """An encdec batch keeps all S decoder tokens and adds (B, F, d) frames
    from the step's generator (the same for the same step); a decoder-only
    frontend takes F of the S positions."""
    cfg = reduced(get_arch(ARCH))
    a, b, c = (lm_batch(cfg, (2, 16), s) for s in (3, 3, 4))
    assert a["tokens"].shape == a["labels"].shape == (2, 16)
    assert a["embeds"].shape == (2, 8, 128) and a["embeds"].dtype == torch.float32
    assert torch.equal(a["embeds"], b["embeds"]) and not torch.equal(a["embeds"], c["embeds"])
    vlm = types.SimpleNamespace(family="dense", vocab=64, n_frontend_tokens=6, d_model=32)
    batch = lm_batch(vlm, (2, 16), 0)
    assert batch["tokens"].shape == (2, 10) and batch["embeds"].shape == (2, 6, 32)
    assert set(lm_batch(get_arch("granite-3-2b"), (1, 4), 0)) == {"tokens", "labels"}


def test_serving_entry_points_refuse_whisper(monkeypatch):
    """Before any work (no device asked for, no model drawn), with the JAX
    package's message."""
    from repro_torch.serve import __main__ as serve_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: pytest.fail("device asked for"))
    for main in (serve_main.main, launch_serve.main):
        with pytest.raises(SystemExit, match="use examples/whisper-style driver for encdec"):
            main(["--arch", ARCH])
        with pytest.raises(SystemExit, match="whisper-style"):
            main(["--arch", ARCH, "--reduced", "--device", "cpu"])


def test_train_cli_runs_whisper_on_the_cpu(capsys):
    """``--arch whisper-base --reduced --device cpu``: two adamw steps of
    ``encdec_loss`` over 8 frames through the trainer; ``--help`` names the
    arch."""
    state = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                               "--batch", "2", "--seq", "8", "--numerics", "amsim",
                               "--multiplier", "afm16"])
    out = capsys.readouterr().out
    assert state.step == 2 and "done at step 2" in out
    assert isinstance(state.model, encdec.EncDec)
    with pytest.raises(SystemExit):
        launch_train.main(["--help"])
    assert "whisper-base(encoder-decoder)" in "".join(capsys.readouterr().out.split())
