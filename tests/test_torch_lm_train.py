"""The port's LM training slice against the JAX package's.

Reduced granite-3-2b and granite-moe-3b-a800m (``configs.base.reduced``):
JAX ``init_lm`` parameters are carried across with ``lm_params_from_jax``
and the same numpy batch goes through both packages.  Held here:
* one ``lm_loss`` and its gradients, port ``amsim_torch`` against JAX
  ``amsim_jnp`` and ``native`` against ``native``;
* the batched product's db: under the dw leaf at the expert-bank sites,
  under the dx leaf elsewhere;
* adamw bitwise against JAX over 3 steps, adafactor against JAX on the
  layer-stacked leaves (factored gains, the clip RMS over every layer);
* the converters both ways, for parameters and optimizer states;
* ``lm_batch``, the checkpoint store, the trainer's supervisor and ladder,
  a bitwise resume, and the ``launch.train`` CLI.
The attention and decode-chain gradients are held in
``test_torch_attention.py``, ``test_torch_decode_chain.py`` and
``test_torch_moe.py``; the card's ``amsim`` steps against ``amsim_torch``
in ``test_torch_cuda.py``.
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
from repro.optim import optimizers as joptim  # noqa: E402
from repro_torch.checkpoint.store import (CheckpointCorruptError,  # noqa: E402
                                          CheckpointManager, load_tree, save_tree)
from repro_torch.configs.base import get_arch, reduced  # noqa: E402
from repro_torch.convert import (lm_opt_state_from_jax, lm_opt_state_to_numpy,  # noqa: E402
                                 lm_params_from_jax, lm_params_to_numpy, lm_tree_to_numpy)
from repro_torch.core.float_bits import np_bits  # noqa: E402
from repro_torch.core.policy import NumericsPolicy, demote_numerics  # noqa: E402
from repro_torch.data.pipeline import lm_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.transformer import init_lm, lm_loss, lm_stacks  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.train.trainer import (DivergenceError, Trainer, TrainerConfig,  # noqa: E402
                                       TrainerState)

ARCHS = ["granite-3-2b", "granite-moe-3b-a800m"]
POLICIES = {
    "native": (NumericsPolicy(), JaxPolicy()),
    "amsim_torch": (NumericsPolicy(mode="amsim_torch", multiplier="afm16"),
                    JaxPolicy(mode="amsim_jnp", multiplier="afm16")),
}
AMSIM_TORCH = POLICIES["amsim_torch"][0]


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


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(port cfg, JAX cfg, JAX params as numpy) of a reduced arch."""
    cfg = reduced(get_arch(request.param))
    jcfg = jax_reduced(jax_get_arch(request.param))
    params = jax.tree_util.tree_map(np.asarray, jtransformer.init_lm(jax.random.PRNGKey(0),
                                                                     jcfg))
    return cfg, jcfg, params


def _small(arch, n_layers=2):
    """``reduced`` narrowed further (d 32, vocab 64) for the tests that
    hold the port to itself."""
    cfg = reduced(get_arch(arch), n_layers=n_layers, d_model=32, d_ff=64, vocab=64, d_head=8)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, d_ff=16))
    return cfg


def _batch(cfg, B=2, S=8, seed=0):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    return tokens, labels


def _port_batch(tokens, labels):
    return {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}


def _leaves_close(port_tree, jax_tree, rtol, atol):
    jl = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    pl = jax.tree_util.tree_leaves(port_tree)
    assert len(jl) == len(pl)
    for (path, b), a in zip(jl, pl):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------- loss + grads
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_lm_loss_and_gradients_match_jax(carried, name):
    """One loss and every gradient leaf: loss to rtol 1e-5, gradients
    rtol 1e-4, atol 1e-6 (JAX reduces its sums in one op, the port's LUT
    GEMMs fold k in order)."""
    cfg, jcfg, params = carried
    policy, jpolicy = POLICIES[name]
    tokens, labels = _batch(cfg)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtransformer.lm_loss(p, jbatch, jcfg, jpolicy), has_aux=True))(params)
    model = lm_params_from_jax(params, cfg, device="cpu")
    loss, met = lm_loss(model, _port_batch(tokens, labels), policy)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), rtol=1e-5, atol=1e-7)
    if cfg.moe is not None:
        assert float(met["aux"]) > 0
    _leaves_close(lm_tree_to_numpy(dict(zip(named, grads))), jgrads, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_keeps_the_bits(arch):
    """``cfg.remat`` recomputes each block in the backward (under ``amsim``
    the fused attention and expert banks recompute inside the recompute):
    loss and gradients bitwise the same as without it."""
    cfg = _small(arch)
    batch = _port_batch(*_batch(cfg))
    out = []
    for remat in (True, False):
        model = init_lm(dataclasses.replace(cfg, remat=remat), device="cpu")
        loss, _ = lm_loss(model, batch, NumericsPolicy(mode="amsim", multiplier="afm16"))
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_q_chunked_einsum_attention_keeps_the_bits():
    """The einsum lowering a query chunk (``cfg.q_chunk``) at a time: the
    same logits and gradients, bit for bit, as in one piece.  The score and
    value sites take two multipliers, so that the einsum lowering runs (one
    LUT for both takes ``policy_attention``, under ``amsim_torch`` too)."""
    from repro_torch.core.policy import table_from_assignments
    policy = table_from_assignments("attn_value=amsim_torch:mitchell8,default=amsim_torch:afm16")
    assert not ops.one_call_attention_enabled(policy)
    cfg = _small("granite-3-2b")
    batch = _port_batch(*_batch(cfg, S=16))
    out = []
    for q_chunk in (4, 1024):
        model = init_lm(dataclasses.replace(cfg, q_chunk=q_chunk), device="cpu")
        loss, _ = lm_loss(model, batch, policy)
        out.append([loss, *torch.autograd.grad(loss, list(model.parameters()))])
    for a, b in zip(*out):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ----------------------------------------------------- batched product db
class _SplitPolicy(NumericsPolicy):
    """dx under amsim_torch/mitchell8, dw native: the pass each gradient
    product takes shows in its bits."""

    def resolve(self, site=None, family=None, pass_="fwd"):
        if pass_ == "dw":
            return NumericsPolicy()
        return NumericsPolicy(mode="amsim_torch", multiplier="mitchell8")


@pytest.mark.parametrize("site", ["wg", "wu", "wd", "attn_score", "attn_value", None])
def test_batched_db_takes_the_dw_leaf_at_the_expert_bank_sites(site, rng):
    a = torch.from_numpy(rng.standard_normal((3, 5, 7)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 7, 4)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 5, 4)).astype(np.float32))
    a.requires_grad_(True)
    b.requires_grad_(True)
    policy = _SplitPolicy(mode="amsim_torch", multiplier="mitchell8")
    da, db = torch.autograd.grad(ops.policy_matmul(a, b, policy, site), (a, b), g)
    dx = NumericsPolicy(mode="amsim_torch", multiplier="mitchell8")
    at, bt = a.detach().transpose(1, 2), b.detach().transpose(1, 2)
    assert torch.equal(da, ops._matmul_nograd(g, bt, dx))
    want = ops._matmul_nograd(at, g, NumericsPolicy() if site in ("wg", "wu", "wd") else dx)
    assert torch.equal(db, want)
    assert not torch.equal(ops._matmul_nograd(at, g, NumericsPolicy()),
                           ops._matmul_nograd(at, g, dx))


def test_broadcast_batched_gradients_sum_over_the_broadcast_dims(rng):
    """(2, 1, m, k) @ (1, 3, k, n): da and db summed over the dims each
    operand broadcast, as JAX ``_mm_bwd`` sums them."""
    a = torch.from_numpy(rng.standard_normal((2, 1, 4, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, 3, 5, 6)).astype(np.float32))
    a.requires_grad_(True)
    b.requires_grad_(True)
    out = ops.policy_matmul(a, b, NumericsPolicy(), "attn_score")
    da, db = torch.autograd.grad(out.sum(), (a, b))
    ra, rb = a.detach().clone().requires_grad_(True), b.detach().clone().requires_grad_(True)
    wa, wb = torch.autograd.grad(torch.matmul(ra, rb).sum(), (ra, rb))
    np.testing.assert_allclose(da.numpy(), wa.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(db.numpy(), wb.numpy(), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- optimizers
def _grad_trees(params, rng, steps):
    return [jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params) for _ in range(steps)]


def _port_flat(model):
    return dict(model.named_parameters())


def _port_grads(jax_grads):
    """{port name: tensor} of a JAX layer-stacked gradient tree."""
    return lm_opt_state_from_jax({"step": 0, "m": jax_grads}, device="cpu")["m"]


def test_adamw_bitwise_vs_jax(carried, rng):
    """Three adamw steps (cosine schedule, weight decay) on the carried LM:
    parameters and both moments bitwise equal to JAX; the step counts
    alike."""
    cfg, _, params = carried
    sched = optimizers.cosine_schedule(1e-2, 2, 10)
    jsched = joptim.cosine_schedule(1e-2, 2, 10)
    opt = optimizers.make_optimizer("adamw", sched, weight_decay=0.01)
    jopt = joptim.make_optimizer("adamw", jsched, weight_decay=0.01)
    model = lm_params_from_jax(params, cfg, device="cpu")
    flat = _port_flat(model)
    state, jstate, jparams = opt.init(flat), jopt.init(params), params
    for jg in _grad_trees(params, rng, 3):
        upd, jstate = jopt.update(jg, jstate, jparams)
        jparams = joptim.apply_updates(jparams, upd)
        upd, state = opt.update(_port_grads(jg), state, flat)
        optimizers.apply_updates(flat, upd)
    got = {"params": lm_params_to_numpy(model), **lm_opt_state_to_numpy(state)}
    want = {"params": jparams, "m": jstate["m"], "v": jstate["v"], "step": jstate["step"]}
    for (path, w), a in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np_bits(np.asarray(a)), np_bits(np.asarray(w)),
                                      err_msg=jax.tree_util.keystr(path))
    assert state["step"] == int(jstate["step"]) == 3


def test_adafactor_matches_jax_on_the_stacked_leaves(carried, rng):
    """Three adafactor steps on the carried LM with the JAX tree's stacks:
    parameters and factors within rtol 1e-5 of JAX (means reduce in another
    order).  A per-layer gain is one (L, d) leaf there: factored, with a
    column factor shared by every layer; the update clip's RMS spans every
    layer, so a large gradient in one layer scales the others' updates."""
    cfg, _, params = carried
    stacks = lm_stacks(cfg)
    opt = optimizers.make_optimizer("adafactor", 1e-2, stacks=stacks, weight_decay=0.01)
    jopt = joptim.make_optimizer("adafactor", 1e-2, weight_decay=0.01)
    model = lm_params_from_jax(params, cfg, device="cpu")
    flat = _port_flat(model)
    state, jstate, jparams = opt.init(flat), jopt.init(params), params
    grads = _grad_trees(params, rng, 3)
    grads[1]["layers"]["n1"]["g"][0] *= 1e3      # clip fires over the stacked leaf
    for jg in grads:
        upd, jstate = jopt.update(jg, jstate, jparams)
        jparams = joptim.apply_updates(jparams, upd)
        upd, state = opt.update(_port_grads(jg), state, flat)
        optimizers.apply_updates(flat, upd)
    f = state["f"]["layers.n1.g"]
    assert tuple(f["r"].shape) == (cfg.n_layers,) and tuple(f["c"].shape) == (cfg.d_model,)
    assert set(state["f"]["final_norm.g"]) == {"v"}
    _leaves_close(lm_params_to_numpy(model), jparams, rtol=1e-5, atol=1e-7)
    _leaves_close(lm_opt_state_to_numpy(state)["f"], jstate["f"], rtol=1e-5, atol=1e-30)
    assert state["step"] == int(jstate["step"]) == 3


def test_converters_round_trip(carried, rng):
    """lm_params_to_numpy inverts lm_params_from_jax leaf for leaf, and
    the optimizer-state converters invert each other for sgdm, adamw and
    adafactor states."""
    cfg, _, params = carried
    back = lm_params_to_numpy(lm_params_from_jax(params, cfg, device="cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    m, v = _grad_trees(params, rng, 2)
    jadafactor = joptim.adafactor(1e-2).update(m, joptim.adafactor(1e-2).init(params),
                                               params)[1]
    for state in ({"mu": m, "step": np.int32(4)}, {"m": m, "v": v, "step": np.int32(2)},
                  jax.tree_util.tree_map(np.asarray, jadafactor)):
        back = lm_opt_state_to_numpy(lm_opt_state_from_jax(state, device="cpu"))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(state)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(state)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_make_optimizer_names():
    for name in ("sgdm", "adamw", "adafactor"):
        assert isinstance(optimizers.make_optimizer(name, 1e-3), optimizers.Optimizer)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.make_optimizer("lion", 1e-3)


# ------------------------------------------------------------------- data
def test_lm_batch_is_step_indexed():
    cfg = reduced(get_arch("granite-3-2b"))
    a, b, c = (lm_batch(cfg, (3, 16), s) for s in (5, 5, 6))
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (3, 16) and int(a["tokens"].max()) < cfg.vocab
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert bool((a["labels"][:, -1] == -1).all())


# ----------------------------------------------------------- checkpoints
def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((3, 4), generator=g), "b": torch.randn(4, generator=g)},
            "opt": {"m": [torch.randn(2, generator=g)], "step": seed}}


def test_checkpoint_round_trip(tmp_path):
    tree = _tree(1)
    save_tree(tmp_path / "a.npz", tree, extra={"note": "x"})
    got, meta = load_tree(tmp_path / "a.npz", _tree(2))
    assert meta == {"note": "x"}
    assert got["opt"]["step"] == 1 and isinstance(got["opt"]["step"], int)
    for a, b in zip(optimizers.tree_leaves(got["params"]), optimizers.tree_leaves(tree["params"])):
        assert torch.equal(a, b)
    assert torch.equal(got["opt"]["m"][0], tree["opt"]["m"][0])
    assert not list(tmp_path.glob("*.tmp.npz"))


def _corrupt(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


def test_checkpoint_manager_walks_back_past_a_corrupt_newest_file_and_keeps_k(tmp_path):
    logs = []
    mgr = CheckpointManager(tmp_path, keep=2, log_fn=logs.append)
    for step in (1, 2, 3):
        mgr.save(step, _tree(step))
    assert mgr._steps() == [2, 3]
    _corrupt(mgr.path(3))
    got, meta = mgr.restore_latest(_tree(0))
    assert meta["step"] == 2 and got["opt"]["step"] == 2
    assert any("falling back" in line for line in logs)
    _corrupt(mgr.path(2))
    with pytest.raises(CheckpointCorruptError, match="all 2 checkpoints"):
        mgr.restore_latest(_tree(0))
    assert CheckpointManager(tmp_path / "empty").restore_latest(_tree(0)) == (None, None)


# ----------------------------------------------------------------- trainer
SMALL = _small("granite-3-2b", n_layers=1)


def _lm_run(policy, tmp_path=None, steps=3, **kw):
    model = init_lm(SMALL, device="cpu")
    opt, step = launch_train.make_lm_train_step(SMALL, policy, lr=1e-2, steps=steps)
    cfg = TrainerConfig(total_steps=steps, ckpt_dir=None if tmp_path is None else str(tmp_path),
                        ckpt_every=1, log_every=1, log_fn=lambda s: None, **kw)
    return model, opt, step, cfg


def test_a_nan_step_raises_divergence_and_restores(tmp_path):
    model, opt, step, cfg = _lm_run(NumericsPolicy(), tmp_path, max_retries=2)
    poisoned = {"left": 1}

    def flaky(m, s, batch):
        s, metrics = step(m, s, batch)
        if poisoned["left"] and int(s["step"]) == 2:
            poisoned["left"] -= 1
            with torch.no_grad():
                next(m.parameters()).fill_(float("nan"))
            return s, dict(metrics, loss=torch.tensor(float("nan")))
        return s, metrics

    trainer = Trainer(flaky, lambda s: lm_batch(SMALL, (2, 8), s), cfg)
    with pytest.raises(DivergenceError, match="non-finite"):
        trainer._check_divergence(2, {"loss": float("nan")}, None)
    trainer.divergences.clear()
    state = trainer.run(TrainerState(model, opt.init(dict(model.named_parameters()))))
    assert state.step == 3 and [(s, r) for s, r, _ in trainer.divergences] == [(2, "non-finite")]
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    # The supervisor's rollback gives the uninterrupted run's bits.
    ref, ropt, rstep, rcfg = _lm_run(NumericsPolicy())
    rstate = Trainer(rstep, lambda s: lm_batch(SMALL, (2, 8), s), rcfg).run(
        TrainerState(ref, ropt.init(dict(ref.named_parameters()))))
    assert rstate.step == 3
    for a, b in zip(model.parameters(), ref.parameters()):
        assert torch.equal(a, b)


def test_a_loss_spike_past_the_ema_raises():
    trainer = Trainer(None, None, TrainerConfig(total_steps=1, spike_factor=2.0, spike_warmup=1))
    ema = trainer._check_divergence(2, {"loss": 1.0}, None)
    assert trainer._check_divergence(3, {"loss": 1.5}, ema) == pytest.approx(1.05)
    with pytest.raises(DivergenceError, match="loss-spike"):
        trainer._check_divergence(4, {"loss": 5.0}, 1.05)


def test_the_ladder_demotes_afm16_to_exact7_to_native(tmp_path):
    """A step that diverges under every approximate multiplier: the
    retries spent, the ladder takes exact7 (still diverging: a stuck
    datapath), then native, which trains to the end."""
    start = NumericsPolicy(mode="amsim_torch", multiplier="afm16")
    model, opt, _, cfg = _lm_run(start, tmp_path, steps=2, max_retries=1)
    seen = []

    def step_under(policy):
        _, step = launch_train.make_lm_train_step(SMALL, policy, lr=1e-2, steps=2)

        def run(m, s, batch):
            seen.append((policy.mode, policy.multiplier))
            s, metrics = step(m, s, batch)
            if not policy.is_native:
                metrics = dict(metrics, loss=torch.tensor(float("inf")))
            return s, metrics
        return run

    def degrade(level):
        policy = start
        for _ in range(level):
            policy = policy and demote_numerics(policy)
        return None if policy is None else step_under(policy)

    cfg = dataclasses.replace(cfg, degrade_fn=degrade)
    trainer = Trainer(step_under(start), lambda s: lm_batch(SMALL, (2, 8), s), cfg)
    state = trainer.run(TrainerState(model, opt.init(dict(model.named_parameters()))))
    assert state.step == 2 and trainer.ladder_level == 2
    assert [p for p in dict.fromkeys(seen)] == [("amsim_torch", "afm16"),
                                                ("amsim_torch", "exact7"), ("native", "fp32")]
    assert demote_numerics(NumericsPolicy()) is None


def test_the_ladder_exhausted_reraises(tmp_path):
    model, opt, step, cfg = _lm_run(NumericsPolicy(), tmp_path, max_retries=0,
                                    degrade_fn=lambda level: None)

    def broken(m, s, batch):
        raise RuntimeError("lost the device")

    trainer = Trainer(broken, lambda s: lm_batch(SMALL, (2, 8), s), cfg)
    with pytest.raises(RuntimeError, match="lost the device"):
        trainer.run(TrainerState(model, opt.init(dict(model.named_parameters()))))


def test_resume_from_a_checkpoint_is_bitwise(tmp_path):
    """Three amsim_torch steps straight against two, a checkpoint, a
    restore into a fresh model and one more: parameters and adamw state
    bitwise equal."""
    straight, opt, step, cfg = _lm_run(AMSIM_TORCH)
    Trainer(step, lambda s: lm_batch(SMALL, (2, 8), s), cfg).run(
        TrainerState(straight, opt.init(dict(straight.named_parameters()))))
    first, opt, step, cfg = _lm_run(AMSIM_TORCH, tmp_path)
    cut = dataclasses.replace(cfg, total_steps=2)
    Trainer(step, lambda s: lm_batch(SMALL, (2, 8), s), cut).run(
        TrainerState(first, opt.init(dict(first.named_parameters()))))
    fresh = init_lm(SMALL, generator=torch.Generator().manual_seed(7), device="cpu")
    state = Trainer(step, lambda s: lm_batch(SMALL, (2, 8), s), cfg).run(
        TrainerState(fresh, opt.init(dict(fresh.named_parameters()))))
    assert state.step == 3
    for a, b in zip(fresh.parameters(), straight.parameters()):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# --------------------------------------------------------------------- CLI
def test_train_cli_runs_on_the_cpu(capsys):
    state = launch_train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                               "--seq", "8", "--numerics", "amsim", "--multiplier", "afm16"])
    out = capsys.readouterr().out
    assert state.step == 2
    assert "numerics=amsim/afm16: the kernels' plain versions on the CPU" in out
    assert "step 2: " in out and "done at step 2" in out


def test_train_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        launch_train.main(["--reduced", "--device", "cpu", "--assign", "dw=native",
                           "--numerics-table", "table.json"])
