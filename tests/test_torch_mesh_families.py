"""The MoE, SSM, hybrid and encoder-decoder families on a 2x2 (data, model)
mesh of four gloo ranks on the CPU, at reduced widths: granite-moe-3b-a800m
(8 experts, top-2), mamba2-780m, zamba2-1.2b (its shared block applied
twice) and whisper-base.

For each family:
  * under ``native`` the mesh's greedy tokens and logits are bitwise the
    single-device run's, and its loss and every gradient leaf (gathered)
    bitwise the k-split oracle's (``distributed.oracle``: the single-device
    step one data block at a time, an MoE layer's routing the whole
    batch's), which is the single-device step with the data split;
  * under ``amsim``/afm16 tokens, logits, loss and every leaf bitwise the
    k-split oracle's, and a row sum missing one shard is not;
  * the native mesh's loss and gradients are held against the JAX
    package's single-device ``lm_loss`` / ``encdec_loss``: loss rel 1e-6,
    each leaf rel L2 1e-5 (the worst leaf reads 1.0e-6 to 2.4e-6).
Reduced qwen2.5-32b's loss and leaves, its q/k/v biases' too, are bitwise
the oracle's under both numerics.  The MoE routing is the whole batch's: a layer whose router sends every
token to one expert drops data rank 1's tokens only because data rank 0's
fill the capacity of the whole batch, and the mesh's layer output and aux
loss are bitwise the single-device layer's.  ``launch.train --arch
whisper-base --mesh 2x2`` exits 0 on the CPU.

The ranks are spawned once (``launch.mesh.spawn``); the checks compare in
the parent process.
"""
import numpy as np
import pytest
import torch

BATCH, SEQ = 4, 8
PROMPT, NEW = 8, 3
FAMILIES = ("granite-moe-3b-a800m", "mamba2-780m", "zamba2-1.2b", "whisper-base")
BIASED = "qwen2.5-32b"      # q/k/v biases: a column-split bias's gradient


def _cfg(arch):
    """The reduced arch without remat (the same bits; its checkpoint would
    import torch._dynamo in every rank)."""
    from repro_torch.configs.base import get_arch, reduced
    return reduced(get_arch(arch), remat=False)


def _policy(name):
    from repro_torch.core.policy import NumericsPolicy
    return NumericsPolicy() if name == "native" else NumericsPolicy(mode="amsim", multiplier=name)


def _init(cfg, mesh=None):
    from repro_torch.models.encdec import init_encdec
    from repro_torch.models.transformer import init_lm
    init = init_encdec if cfg.family == "encdec" else init_lm
    return init(cfg, generator=torch.Generator().manual_seed(0), device="cpu", mesh=mesh)


def _batch(cfg):
    from repro_torch.data.pipeline import lm_batch
    return lm_batch(cfg, (BATCH, SEQ), 0)


def _prompts(cfg):
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=g)
    frames = torch.randn((BATCH, cfg.n_frontend_tokens or 1, cfg.d_model), generator=g)
    return prompts, frames


def _loss_and_grads(model, batch, pol, mesh=None):
    from repro_torch.distributed.sharding import gather_tensor
    from repro_torch.models.encdec import encdec_loss
    from repro_torch.models.transformer import lm_loss
    loss_fn = encdec_loss if model.cfg.family == "encdec" else lm_loss
    loss, _ = loss_fn(model, batch, pol)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    if mesh is not None:
        grads = [gather_tensor(g, getattr(p, "spec", ()), mesh)
                 for g, p in zip(grads, params.values())]
    return loss.detach(), dict(zip(params, grads))


def _serve(model, pol, mesh=None):
    """(tokens, logits) of NEW greedy tokens after the prompts: every row,
    gathered over the data axes under a mesh."""
    from repro_torch.models.encdec import greedy
    from repro_torch.serve.engine import ServingEngine
    prompts, frames = _prompts(model.cfg)
    if model.cfg.family != "encdec":
        return ServingEngine(model, pol, max_len=PROMPT + NEW, mesh=mesh).generate(
            prompts, NEW, return_logits=True)
    if mesh is None:
        return greedy(model, frames, prompts, NEW, pol)[1:]
    rows = lambda t: mesh.block(t, mesh.data_axes, 0)  # noqa: E731
    _, toks, logits = greedy(model, rows(frames), rows(prompts), NEW, pol)
    return tuple(mesh.all_gather(t.contiguous(), mesh.data_axes, dim=0) for t in (toks, logits))


def _one_expert_layer(mesh=None):
    """An MoE layer whose router sends every token's first choice to expert
    0, over a batch of 4 x 8 tokens: (y, aux) of this rank's rows (every row
    without a mesh)."""
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.transformer import init_lm
    cfg = _cfg("granite-moe-3b-a800m")
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu", mesh=mesh)
    layer = model.layers[0].moe
    with torch.no_grad():
        layer["router"].w[:, 0] += 4.0
    x = torch.randn((BATCH, SEQ, cfg.d_model), generator=torch.Generator().manual_seed(3)).abs()
    if mesh is not None:
        x = mesh.block(x, mesh.data_axes, 0)
    with torch.no_grad():
        return moe_ffn(layer, x, cfg, _policy("native"))


def _mesh_runs(mesh):
    out = {}
    for arch in FAMILIES:
        cfg = _cfg(arch)
        model = _init(cfg, mesh)
        rows = {k: mesh.block(v, mesh.data_axes, 0) for k, v in _batch(cfg).items()}
        got = {name: _loss_and_grads(model, rows, _policy(name), mesh)
               for name in ("native", "afm16")}
        whole = mesh.all_gather   # the wrong variant: each row sum keeps shard 0 alone
        mesh.ordered_sum = lambda t, axes: whole(t, axes)[0] if axes == "model" else \
            type(mesh).ordered_sum(mesh, t, axes)
        got["missing shard"] = _loss_and_grads(model, rows, _policy("afm16"), mesh)
        del mesh.ordered_sum
        for name in ("native", "afm16"):
            got[f"serve {name}"] = _serve(model, _policy(name), mesh)
        out[arch] = got
    cfg = _cfg(BIASED)
    model = _init(cfg, mesh)
    rows = {k: mesh.block(v, mesh.data_axes, 0) for k, v in _batch(cfg).items()}
    out[BIASED] = {name: _loss_and_grads(model, rows, _policy(name), mesh)
                   for name in ("native", "afm16")}
    y, aux = _one_expert_layer(mesh)
    out["one expert"] = (mesh.all_gather(y, mesh.data_axes, dim=0), aux)
    from repro_torch.launch import train
    args = train.arg_parser().parse_args(
        ["--arch", "whisper-base", "--reduced", "--device", "cpu", "--batch", "4", "--seq", "8",
         "--steps", "2", "--mesh", "2x2", "--numerics", "amsim", "--multiplier", "afm16"])
    out["train whisper"] = train._train_rank(mesh, args)
    return out if mesh.rank == 0 else None


@pytest.fixture(scope="module")
def mesh_job():
    """The ranks' run, started in a thread of its own so that ``single``
    computes beside it; ``mesh_out`` joins it."""
    import threading

    from repro_torch.launch.mesh import spawn
    job = {}

    def run():
        try:
            job["out"] = spawn(_mesh_runs, (2, 2), device="cpu", timeout=600)[0]
        except BaseException as e:      # noqa: BLE001 - raised in mesh_out
            job["error"] = e
    thread = threading.Thread(target=run)
    thread.start()
    yield job, thread
    thread.join()


@pytest.fixture(scope="module")
def mesh_out(mesh_job, single):
    job, thread = mesh_job
    thread.join()
    if "error" in job:
        raise job["error"]
    return job["out"]


@pytest.fixture(scope="module")
def single(mesh_job):
    """Per family: the model, its single-device serving runs and the k-split
    oracle's loss and gradients of the 2x2 mesh, per numerics."""
    from repro_torch.distributed.oracle import ksplit, ksplit_loss_and_grads
    from repro_torch.launch.mesh import MeshShape
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # small products: threads only contend with the other workers
    runs = {}
    try:
        for arch in FAMILIES:
            cfg = _cfg(arch)
            model, batch = _init(cfg), _batch(cfg)
            r = {"model": model, "batch": batch,
                 "serve native": _serve(model, _policy("native"))}
            with ksplit(model, MeshShape((2, 2))):
                r["serve afm16 oracle"] = _serve(model, _policy("afm16"))
            for name in ("native", "afm16"):
                r[f"{name} oracle"] = ksplit_loss_and_grads(model, batch, _policy(name),
                                                            MeshShape((2, 2)))
            runs[arch] = r
        cfg = _cfg(BIASED)
        model, batch = _init(cfg), _batch(cfg)
        runs[BIASED] = {f"{name} oracle": ksplit_loss_and_grads(model, batch, _policy(name),
                                                                MeshShape((2, 2)))
                        for name in ("native", "afm16")}
    finally:
        torch.set_num_threads(threads)
    return runs


def _bitwise(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _rel(a, b):
    return float((a - b).norm() / max(b.norm(), 1e-30))


@pytest.mark.parametrize("arch", FAMILIES)
def test_native_serving_is_bitwise_single_device(mesh_out, single, arch):
    toks, logits = mesh_out[arch]["serve native"]
    rtoks, rlogits = single[arch]["serve native"]
    assert torch.equal(toks, rtoks) and _bitwise(logits, rlogits)


@pytest.mark.parametrize("arch", FAMILIES)
def test_amsim_serving_is_bitwise_the_ksplit_oracle(mesh_out, single, arch):
    toks, logits = mesh_out[arch]["serve afm16"]
    otoks, ologits = single[arch]["serve afm16 oracle"]
    assert torch.equal(toks, otoks) and _bitwise(logits, ologits)


@pytest.mark.parametrize("name", ["native", "afm16"])
@pytest.mark.parametrize("arch", FAMILIES + (BIASED,))
def test_loss_and_gradients_bitwise_the_ksplit_oracle(mesh_out, single, arch, name):
    """The mesh's loss and every gathered gradient leaf are bitwise the
    k-split oracle's: the row sums, the column dx, each MoE layer's
    whole-batch routing, a column-split bias's reduction (qwen2.5) and
    every data-rank sum as the mesh orders them."""
    loss, grads = mesh_out[arch][name]
    ref_loss, ref_grads = single[arch][f"{name} oracle"]
    assert _bitwise(loss, ref_loss), (float(loss), float(ref_loss))
    differ = [n for n, g in ref_grads.items() if not _bitwise(grads[n], g)]
    assert not differ and set(grads) == set(ref_grads), differ


@pytest.mark.parametrize("arch", FAMILIES)
def test_a_wrong_variant_misses_the_ksplit_oracle(mesh_out, single, arch):
    """A row sum missing one shard is not the oracle's (the bitwise check
    above can fail)."""
    _, grads = mesh_out[arch]["missing shard"]
    _, ref_grads = single[arch]["afm16 oracle"]
    assert not all(_bitwise(grads[n], g) for n, g in ref_grads.items())


@pytest.mark.parametrize("arch", FAMILIES)
def test_native_loss_and_gradients_match_jax(mesh_out, single, arch):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch, reduced
    from repro.core.policy import NumericsPolicy
    from repro.models.encdec import encdec_loss
    from repro.models.transformer import lm_loss

    from repro_torch.convert import lm_params_to_numpy, lm_tree_to_numpy
    model, batch = single[arch]["model"], single[arch]["batch"]
    jcfg = reduced(get_arch(arch))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    tree = jax.tree.map(jnp.asarray, lm_params_to_numpy(model))
    loss_fn = encdec_loss if jcfg.family == "encdec" else lm_loss
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, jbatch, jcfg, NumericsPolicy()), has_aux=True))(tree)
    loss, grads = mesh_out[arch]["native"]
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    mine = lm_tree_to_numpy(grads)
    flat = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert len(flat) == len(jax.tree.leaves(jg))
    for (path, a), b in zip(flat, jax.tree.leaves(jg)):
        b = np.asarray(b)
        assert np.linalg.norm(a - b) <= 1e-5 * max(np.linalg.norm(b), 1e-30), path


def test_moe_drops_follow_the_whole_batch(mesh_out):
    """Every token's first choice is expert 0: with the whole batch's
    capacity (16 slots for 32 tokens) data rank 0's 16 tokens fill it and
    data rank 1's drop, which a per-rank routing (8 slots for 16 tokens)
    would not do.  The mesh's output and aux loss are bitwise the
    single-device layer's."""
    from repro_torch.models.moe import capacity
    y, aux = mesh_out["one expert"]
    ry, raux = _one_expert_layer()
    cfg = _cfg("granite-moe-3b-a800m")
    T = BATCH * SEQ
    assert capacity(cfg, T) == 16 and capacity(cfg, T // 2) == 8
    assert _bitwise(y, ry) and _bitwise(aux, raux)


def test_moe_per_rank_routing_would_differ():
    """The layer above on data rank 1's rows alone (its own capacity and
    slots) differs from those rows of the whole batch's layer: the test
    above can fail."""
    ry, _ = _one_expert_layer()
    cfg = _cfg("granite-moe-3b-a800m")
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.transformer import init_lm
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    layer = model.layers[0].moe
    with torch.no_grad():
        layer["router"].w[:, 0] += 4.0
    x = torch.randn((BATCH, SEQ, cfg.d_model), generator=torch.Generator().manual_seed(3)).abs()
    with torch.no_grad():
        own, _ = moe_ffn(layer, x[BATCH // 2:], cfg, _policy("native"))
    assert not torch.equal(own, ry[BATCH // 2:])


def test_moe_aux_loss_is_the_whole_batchs(mesh_out, single):
    """The training step's aux loss (the loss's MoE term) is the whole
    batch's: the mesh's loss is bitwise the oracle's, whose aux takes its
    means over every block's rows, and a per-block aux would differ."""
    from repro_torch.launch.mesh import single_device
    from repro_torch.models.transformer import lm_loss
    model, batch = single["granite-moe-3b-a800m"]["model"], single["granite-moe-3b-a800m"]["batch"]
    with single_device(), torch.no_grad():
        _, whole = lm_loss(model, batch, _policy("native"))
        _, half = lm_loss(model, {k: v[:BATCH // 2] for k, v in batch.items()}, _policy("native"))
    loss, _ = mesh_out["granite-moe-3b-a800m"]["native"]
    ref_loss, _ = single["granite-moe-3b-a800m"]["native oracle"]
    assert _bitwise(loss, ref_loss)
    assert float(whole["aux"].detach()) != float(half["aux"].detach())


def test_train_cli_whisper_on_the_mesh(mesh_out):
    """``launch.train --arch whisper-base --mesh 2x2`` (reduced, amsim), a
    rank's run of its arguments (``_train_rank``; ``main``'s spawn of it is
    ``tests/test_torch_mesh_lm.py``'s): two steps, finite losses, the
    gathered parameters."""
    out = mesh_out["train whisper"]
    assert [s for s, _ in out["history"]] == [1, 2]
    assert all(np.isfinite(float(m["loss"])) for _, m in out["history"])
    assert "dec_layers" in out["params"] and "enc_layers" in out["params"]


def test_llama4_pairs_are_refused_on_a_mesh():
    """llama4's (dense, MoE) pairs wait for a slice that holds them against
    the k-split oracle: placing them, a forward under a mesh and both
    launchers' ``--mesh`` refuse them before any rank starts."""
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.transformer import check_mesh_family, init_lm
    cfg = _cfg("llama4-maverick-400b-a17b")
    with pytest.raises(NotImplementedError, match="pairs"):
        check_mesh_family(cfg, MeshShape((2, 2)))
    with pytest.raises(NotImplementedError, match="pairs"):
        init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                mesh=MeshShape((2, 2)))
    with pytest.raises(NotImplementedError, match="pairs"):      # data-parallel alone too
        check_mesh_family(cfg, MeshShape((4, 1)))
    with pytest.raises(SystemExit, match="pairs"):
        train.main(["--arch", "llama4-maverick-400b-a17b", "--reduced", "--device", "cpu",
                    "--mesh", "2x2", "--steps", "1"])
    with pytest.raises(SystemExit, match="pairs"):
        serve.main(["--arch", "llama4-maverick-400b-a17b", "--reduced", "--device", "cpu",
                    "--mesh"])
