"""A reduced granite-3-2b on a 2x2 (data, model) mesh of four gloo ranks on
the CPU, against the port's single-device runs and the JAX package's
single-device ``lm_loss``: the loss and every gradient (native: loss rel
1e-6, each leaf rel L2 1e-5 of JAX's; amsim/afm16: each leaf within 1e-2
of the single-device run in relative norm, which a row sum missing one
shard exceeds), greedy tokens of ``ServingEngine(mesh=)``
equal to the single-device engine's (mitchell8 and afm16, as JAX's
``tests/test_sharded_fused.py``), the kill switch's replicated dispatch
bitwise the single-device decode (the chain on), and the two CLIs with
``--mesh``, whose checkpoint a single-device run resumes bitwise and a
mesh run resumes bitwise a straight run.  The mesh's loss and gradients
are also bitwise the k-split oracle's (``distributed.oracle``), native
and afm16, which a row sum missing a shard is not.

Each file's ranks are spawned once (``launch.mesh.spawn``, a deadline);
the checks compare in the parent process.
"""
import numpy as np
import pytest
import torch

BATCH, SEQ = 4, 8
PROMPT, NEW = 6, 4
AMSIM_GRAD_RTOL = 1e-2


def _cfg():
    """Reduced granite without remat (the same bits; its checkpoint would
    import torch._dynamo, ~4 s, in every rank)."""
    from repro_torch.configs.base import get_arch, reduced
    return reduced(get_arch("granite-3-2b"), remat=False)


def _policy(name):
    from repro_torch.core.policy import NumericsPolicy
    return NumericsPolicy() if name == "native" else NumericsPolicy(mode="amsim", multiplier=name)


def _prompts(cfg):
    return torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=torch.Generator().manual_seed(1))


def _loss_and_grads(model, batch, pol, mesh=None):
    from repro_torch.distributed.sharding import gather_tensor
    from repro_torch.models.transformer import lm_loss
    loss, _ = lm_loss(model, batch, pol)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    if mesh is not None:
        grads = [gather_tensor(g, getattr(p, "spec", ()), mesh)
                 for g, p in zip(grads, params.values())]
    return loss.detach(), dict(zip(params, grads))


def _resume_runs(mesh, ckpt_root):
    """Per optimizer: a straight 3-step ``launch.train --mesh 2x2`` run, and
    a 2-step run whose checkpoint a 3-step run on the mesh resumes (the
    restore cut again by ``shard_tree``, adafactor's factors by
    ``opt_state_specs``) -> {optimizer: (straight, resumed)} gathered
    parameters, on rank 0."""
    import os

    import torch.distributed as dist

    from repro_torch.launch import train
    out = {}
    for opt, arch in (("adamw", "granite-3-2b"), ("adafactor", "qwen1.5-110b")):
        common = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "4", "--seq", "8",
                  "--mesh", "2x2"]
        straight = train._train_rank(mesh, train.arg_parser().parse_args(common + ["--steps", "3"]))
        ckpt = ["--ckpt-dir", os.path.join(ckpt_root, opt)]
        train._train_rank(mesh, train.arg_parser().parse_args(common + ckpt + ["--steps", "2"]))
        dist.barrier()
        resumed = train._train_rank(mesh, train.arg_parser().parse_args(common + ckpt
                                                                         + ["--steps", "3"]))
        out[opt] = None if mesh.rank else (straight, resumed)
    return out


def _mesh_runs(mesh, tree, ckpt_root):
    import os

    from repro_torch.convert import lm_params_from_jax
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import ServingEngine
    cfg = _cfg()
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu", mesh=mesh)
    converted = lm_params_from_jax(tree, cfg, "cpu", mesh=mesh)
    blocks_equal = all(torch.equal(a, b) and a.spec == b.spec for a, b in
                       zip(model.parameters(), converted.parameters()))
    rows = {k: mesh.block(v, mesh.data_axes, 0) for k, v in lm_batch(cfg, (BATCH, SEQ), 0).items()}
    out = {name: _loss_and_grads(model, rows, _policy(name), mesh)
           for name in ("native", "afm16")}
    whole = mesh.all_gather   # the wrong variant: each row sum keeps shard 0 alone
    mesh.ordered_sum = lambda t, axes: whole(t, axes)[0] if axes == "model" else \
        type(mesh).ordered_sum(mesh, t, axes)
    out["missing shard"] = _loss_and_grads(model, rows, _policy("afm16"), mesh)
    del mesh.ordered_sum
    for mult in ("mitchell8", "afm16"):
        eng = ServingEngine(model, _policy(mult), max_len=PROMPT + NEW, mesh=mesh)
        out[f"serve {mult}"] = eng.generate(_prompts(cfg), NEW, return_logits=True)
    os.environ["REPRO_SHARD_FUSED"] = "0"
    try:
        eng = ServingEngine(model, _policy("afm16"), max_len=PROMPT + NEW, mesh=mesh)
        out["serve afm16 killed"] = eng.generate(_prompts(cfg), NEW, return_logits=True)
    finally:
        del os.environ["REPRO_SHARD_FUSED"]
    out["converted blocks"] = blocks_equal
    out["resume"] = _resume_runs(mesh, ckpt_root)
    return out if mesh.rank == 0 else None


@pytest.fixture(scope="module")
def mesh_out(single, tmp_path_factory):
    from repro_torch.convert import lm_params_to_numpy
    from repro_torch.launch.mesh import spawn
    return spawn(_mesh_runs, (2, 2), device="cpu", timeout=600,
                 args=(lm_params_to_numpy(single[0]), str(tmp_path_factory.mktemp("ckpt"))))[0]


@pytest.fixture(scope="module")
def single():
    """The model, its single-device loss and gradients, and the k-split
    oracle's of the 2x2 mesh (``distributed.oracle``), per numerics."""
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.distributed.oracle import ksplit_loss_and_grads
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.transformer import init_lm
    cfg = _cfg()
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = lm_batch(cfg, (BATCH, SEQ), 0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # small products: threads only contend with the other workers
    try:
        runs = {name: _loss_and_grads(model, batch, _policy(name)) for name in ("native", "afm16")}
        runs.update({f"{name} oracle": ksplit_loss_and_grads(model, batch, _policy(name),
                                                             MeshShape((2, 2)))
                     for name in ("native", "afm16")})
    finally:
        torch.set_num_threads(threads)
    return model, runs


def test_init_and_conversion_give_the_same_blocks(mesh_out):
    """init_lm(mesh=) (each part cut as drawn) and lm_params_from_jax(mesh=)
    of the single-device model's tree hold the same blocks and specs."""
    assert mesh_out["converted blocks"] is True


def _rel(a, b):
    return float((a - b).norm() / max(b.norm(), 1e-30))


def test_native_loss_and_gradients_match_jax(mesh_out, single):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch, reduced
    from repro.core.policy import NumericsPolicy
    from repro.models.transformer import lm_loss

    from repro_torch.convert import lm_params_to_numpy, lm_tree_to_numpy
    from repro_torch.data.pipeline import lm_batch
    model, _ = single
    jcfg = reduced(get_arch("granite-3-2b"))
    batch = {k: jnp.asarray(v.numpy()) for k, v in lm_batch(_cfg(), (BATCH, SEQ), 0).items()}
    tree = jax.tree.map(jnp.asarray, lm_params_to_numpy(model))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: lm_loss(p, batch, jcfg, NumericsPolicy()), has_aux=True))(tree)
    loss, grads = mesh_out["native"]
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    mine = lm_tree_to_numpy(grads)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(mine)[0], jax.tree.leaves(jg)):
        b = np.asarray(b)
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), path


@pytest.mark.parametrize("name", ["native", "afm16"])
def test_loss_and_gradients_match_single_device(mesh_out, single, name):
    """native within 1e-6 / 1e-5; amsim within AMSIM_GRAD_RTOL a leaf, a
    tolerance that a wrong variant's reading exceeds (next test)."""
    loss, grads = mesh_out[name]
    ref_loss, ref_grads = single[1][name]
    assert abs(float(loss) - float(ref_loss)) <= 1e-6 * abs(float(ref_loss))
    tol = 1e-5 if name == "native" else AMSIM_GRAD_RTOL
    worst = max((_rel(grads[n], g), n) for n, g in ref_grads.items())
    assert worst[0] <= tol, worst


@pytest.mark.parametrize("name", ["native", "afm16"])
def test_loss_and_gradients_bitwise_the_ksplit_oracle(mesh_out, single, name):
    """The mesh's loss and every gathered gradient leaf are bitwise the
    k-split oracle's (``distributed.oracle``): the row sums, the column
    dx and every data-rank sum as the mesh orders them."""
    loss, grads = mesh_out[name]
    ref_loss, ref_grads = single[1][f"{name} oracle"]
    assert torch.equal(loss, ref_loss), (float(loss), float(ref_loss))
    differ = [n for n, g in ref_grads.items() if not torch.equal(grads[n], g)]
    assert not differ and set(grads) == set(ref_grads), differ


def test_a_wrong_variant_misses_the_ksplit_oracle(mesh_out, single):
    """A row sum missing one shard is not the oracle's (the bitwise check
    above can fail)."""
    _, grads = mesh_out["missing shard"]
    _, ref_grads = single[1]["afm16 oracle"]
    assert not all(torch.equal(grads[n], g) for n, g in ref_grads.items())


def test_a_wrong_variant_reads_beyond_the_tolerance(mesh_out, single):
    """A row sum missing one shard moves some leaf by more than
    AMSIM_GRAD_RTOL against the afm16 single-device run."""
    _, grads = mesh_out["missing shard"]
    _, ref_grads = single[1]["afm16"]
    worst = max(_rel(grads[n], g) for n, g in ref_grads.items())
    assert worst > AMSIM_GRAD_RTOL, worst


@pytest.mark.parametrize("mult", ["mitchell8", "afm16"])
def test_mesh_serving_tokens_equal_single_device(mesh_out, single, mult):
    from repro_torch.serve.engine import ServingEngine
    model, _ = single
    toks, logits = ServingEngine(model, _policy(mult), max_len=PROMPT + NEW).generate(
        _prompts(_cfg()), NEW, return_logits=True)
    mtoks, mlogits = mesh_out[f"serve {mult}"]
    assert torch.equal(mtoks, toks)
    assert _rel(mlogits, logits) < 1e-5


@pytest.mark.parametrize("mult", ["mitchell8", "afm16"])
def test_mesh_serving_bitwise_the_ksplit_oracle(mesh_out, single, mult):
    """``ServingEngine(mesh=)``'s tokens and logits are bitwise the
    single-device engine's under ``distributed.oracle.ksplit`` (the row
    sums split as the mesh splits them, the chain off)."""
    from repro_torch.distributed.oracle import ksplit
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.serve.engine import ServingEngine
    model, _ = single
    with ksplit(model, MeshShape((2, 2))):
        toks, logits = ServingEngine(model, _policy(mult), max_len=PROMPT + NEW).generate(
            _prompts(_cfg()), NEW, return_logits=True)
    mtoks, mlogits = mesh_out[f"serve {mult}"]
    assert torch.equal(mtoks, toks) and torch.equal(mlogits, logits)


def test_kill_switch_decode_is_bitwise_single_device(mesh_out, single):
    """REPRO_SHARD_FUSED=0: the replicated dispatch, the chain on the
    gathered weights; logits and tokens bitwise the single-device run."""
    from repro_torch.serve.engine import ServingEngine
    model, _ = single
    toks, logits = ServingEngine(model, _policy("afm16"), max_len=PROMPT + NEW).generate(
        _prompts(_cfg()), NEW, return_logits=True)
    mtoks, mlogits = mesh_out["serve afm16 killed"]
    assert torch.equal(mtoks, toks) and torch.equal(mlogits, logits)


def test_train_cli_mesh_checkpoint_resumes_single_device_bitwise(tmp_path, capfd):
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_lm, lm_loss
    from repro_torch.optim.optimizers import cosine_schedule, make_optimizer
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig, TrainerState
    out = train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq",
                      "8", "--mesh", "2x2", "--ckpt-dir", str(tmp_path)])
    text = capfd.readouterr().out
    assert "backend gloo" in text and "mesh dispatch:" in text and "done at step 2" in text
    cfg = _cfg()
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    opt = make_optimizer(cfg.optimizer, cosine_schedule(3e-4, 10, 2))
    step = make_train_step(lambda m, b: lm_loss(m, b, _policy("native")), opt)
    trainer = Trainer(step, lambda s: lm_batch(cfg, (4, 8), s),
                      TrainerConfig(total_steps=2, ckpt_dir=str(tmp_path)))
    state = trainer.run(TrainerState(model, opt.init(dict(model.named_parameters()))))
    assert state.step == 2
    from repro_torch.convert import lm_params_to_numpy
    got, want = lm_params_to_numpy(model), out["params"]
    import jax
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_train_cli_mesh_resume_is_bitwise_the_straight_run(mesh_out, opt):
    """``launch.train --mesh 2x2`` resumed from its own step-2 checkpoint
    ends at step 3 bitwise where a straight 3-step mesh run ends (granite's
    adamw, qwen1.5's adafactor with its factors cut by opt_state_specs)."""
    import jax
    straight, resumed = mesh_out["resume"][opt]
    assert [step for step, _ in resumed["history"]] == [3]
    pairs = list(zip(jax.tree.leaves(straight["params"]), jax.tree.leaves(resumed["params"])))
    assert pairs and all(np.array_equal(a, b) for a, b in pairs)


def test_serve_cli_mesh(capfd):
    from repro_torch.launch import serve
    toks = serve.main(["--reduced", "--device", "cpu", "--mesh", "--batch", "4", "--prompt-len",
                       "5", "--new-tokens", "3"])
    text = capfd.readouterr().out
    assert "backend gloo" in text and "generated (4, 3)" in text
    assert tuple(toks.shape) == (4, 3)
