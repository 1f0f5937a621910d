"""The paged scheduler on a 2x2 (data, model) mesh of four gloo ranks on the
CPU (``ContinuousBatchingEngine(mesh=)``), the twin of JAX's
``tests/test_distributed.py::test_paged_pool_sharding_token_parity``:
reduced granite-3-2b (dense) and granite-moe-3b-a800m streams of six
requests, four slots (two a data rank), pages of four tokens, so that
admissions (a B = 1 prefill on its owner's "model" group beside decoding
slots), page faults and retirements all happen.

  * the pools' specs are (None, None, "model", None): KV heads over
    "model", every page on every data rank; the engine places a model
    whose parameters are whole (granite-3-2b's here);
  * under ``native`` the sharded stream's tokens and logits are bitwise
    the unsharded stream's, and the k-split oracle's native stream
    (``distributed.oracle.ksplit``: each data rank's slots in turn, the
    banks in the mesh's blocks of experts, the shapes of the mesh's calls
    that the card's test holds it to);
  * under ``amsim``/afm16 they are bitwise the k-split oracle's stream
    (the row sums split as the mesh splits them), and the MoE ticks route
    the whole tick's batch;
  * with three slots (the data axes do not divide them) every data rank
    runs every slot inside its "model" group: tokens as above;
  * under ``REPRO_SHARD_FUSED=0`` the decode chain runs on the gathered
    weights and pools: bitwise the single-device stream with the chain on;
  * ``launch.serve --stream --mesh`` exits 0.

The logits are read where the lane steps compute them: every forward of
the scheduler (``_tapped``), a prefill's on its owner's ranks, a tick's
rows of this rank's data block.
"""
import contextlib

import numpy as np
import pytest
import torch

ARCHS = ("granite-3-2b", "granite-moe-3b-a800m")
STREAM = [(0, [3, 1, 4, 1, 5, 9, 2, 6], 5, "default"),
          (0, [2, 7, 1], 6, "default"),
          (1, [8, 2, 8, 1, 8, 2, 8, 4, 5, 9, 0, 4], 4, "default"),
          (2, [1, 6, 1, 8], 6, "default"),
          (3, [3, 3, 2, 7, 9, 5], 3, "default"),
          (6, [5, 7, 7, 2, 1], 5, "default")]
MAX_LEN, PAGE = 24, 4


def _cfg(arch):
    from repro_torch.configs.base import get_arch, reduced
    return reduced(get_arch(arch), remat=False)


def _policy(name):
    from repro_torch.core.policy import NumericsPolicy
    return NumericsPolicy() if name == "native" else NumericsPolicy(mode="amsim", multiplier=name)


def _model(arch, mesh=None):
    from repro_torch.models.transformer import init_lm
    return init_lm(_cfg(arch), generator=torch.Generator().manual_seed(0), device="cpu",
                   mesh=mesh)


@contextlib.contextmanager
def _tapped():
    """Every forward of the scheduler's lane steps, in turn: [(tokens,
    logits)] on the host."""
    from repro_torch.serve import scheduler
    calls, forward = [], scheduler.lm_forward

    def tap(model, tokens, policy, **kw):
        out = forward(model, tokens, policy, **kw)
        calls.append((tokens.cpu(), out[0].cpu()))
        return out
    scheduler.lm_forward = tap
    try:
        yield calls
    finally:
        scheduler.lm_forward = forward


def _stream(model, name, capacity=4, mesh=None):
    """({rid: tokens}, [(tokens, logits)] of every forward) of the stream."""
    from repro_torch.serve.scheduler import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, {"default": _policy(name)}, max_len=MAX_LEN,
                                   capacity=capacity, page_size=PAGE, mesh=mesh)
    with _tapped() as calls:
        eng.run(STREAM)
    return {rid: list(r.out) for rid, r in eng.finished.items()}, calls


def _mesh_runs(mesh):
    import os

    from repro_torch.serve.scheduler import ContinuousBatchingEngine
    out = {}
    for arch in ARCHS:
        # granite-3-2b's parameters whole: the first engine places them
        model = _model(arch, None if arch == ARCHS[0] else mesh)
        for name in ("native", "afm16"):
            out[arch, name] = _stream(model, name, mesh=mesh)
        out[arch, "native", 3] = _stream(model, "native", capacity=3, mesh=mesh)
        os.environ["REPRO_SHARD_FUSED"] = "0"
        try:
            out[arch, "afm16 killed"] = _stream(model, "afm16", mesh=mesh)
        finally:
            del os.environ["REPRO_SHARD_FUSED"]
    eng = ContinuousBatchingEngine(model, {"default": _policy("native")}, max_len=MAX_LEN,
                                   capacity=4, page_size=PAGE, mesh=mesh)
    lane = eng._lanes["default"]
    out["pool specs"] = lane.cache_specs
    out["pool shape"] = tuple(lane.caches[0]["pool_k"].shape)
    out["data rank"] = mesh.index(mesh.data_axes)
    return out


@pytest.fixture(scope="module")
def mesh_job():
    """The ranks' run, started in a thread of its own so that ``single``
    computes beside it; ``mesh_out`` joins it."""
    import threading

    from repro_torch.launch.mesh import spawn
    job = {}

    def run():
        try:
            job["out"] = spawn(_mesh_runs, (2, 2), device="cpu", timeout=600)
        except BaseException as e:      # noqa: BLE001 - raised in mesh_out
            job["error"] = e
    thread = threading.Thread(target=run)
    thread.start()
    yield job, thread
    thread.join()


@pytest.fixture(scope="module")
def single(mesh_job):
    """Per arch: the single-device streams (native; afm16 with the chain on)
    and the k-split oracle's native and afm16 streams."""
    from repro_torch.distributed.oracle import ksplit
    from repro_torch.launch.mesh import MeshShape
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs = {}
    try:
        for arch in ARCHS:
            model = _model(arch)
            runs[arch, "native"] = _stream(model, "native")
            runs[arch, "afm16"] = _stream(model, "afm16")
            with ksplit(model, MeshShape((2, 2))):
                runs[arch, "native oracle"] = _stream(model, "native")
                runs[arch, "afm16 oracle"] = _stream(model, "afm16")
    finally:
        torch.set_num_threads(threads)
    return runs


@pytest.fixture(scope="module")
def mesh_out(mesh_job, single):
    job, thread = mesh_job
    thread.join()
    if "error" in job:
        raise job["error"]
    return job["out"]


def _bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _ticks(calls, capacity: int) -> list:
    """Each decode tick's (tokens, logits) of a single-device run, a tick
    that ran in data blocks (the oracle's) put back together."""
    out, part = [], []
    for c in calls:
        if c[0].shape[1] == 1:
            part.append(c)
            if sum(t.shape[0] for t, _ in part) == capacity:
                out.append(tuple(torch.cat(x) for x in zip(*part)))
                part = []
    return out


def _same(ranks, key, want, split=True) -> bool:
    """The mesh's stream ``key`` (every rank's) against the single-device
    run ``want``: every request's tokens equal; each decode tick's logits
    on a rank bitwise its data block of the tick's rows (every row when
    the slots do not split); each prefill bitwise the single-device
    prefill of the same tokens, in turn, the data ranks' prefills together
    the single-device ones (each data rank all of them when not split)."""
    toks, calls = want
    ticks = _ticks(calls, 4 if split else 3)
    prefills = [c for c in calls if c[0].shape[1] > 1]
    D, owned = 2, {}
    for r in ranks:
        got_toks, got_calls = r[key]
        if got_toks != toks or len(toks) != len(STREAM):
            return False
        d = r["data rank"]
        got_ticks = [c for c in got_calls if c[0].shape[1] == 1]
        if len(got_ticks) != len(ticks):
            return False
        for (tg, lg), (tw, lw) in zip(got_ticks, ticks):
            n = tw.shape[0] // D
            rows = slice(d * n, (d + 1) * n) if split else slice(None)
            if not (torch.equal(tg, tw[rows]) and _bits(lg, lw[rows])):
                return False
        left = iter(prefills)
        got_prefills = [c for c in got_calls if c[0].shape[1] > 1]
        for tg, lg in got_prefills:
            lw = next((lw for tw, lw in left if torch.equal(tg, tw)), None)
            if lw is None or not _bits(lg, lw):
                return False
        owned[d] = len(got_prefills)
    return (sum(owned.values()) if split else min(owned.values())) == len(prefills)


def test_pools_shard_kv_heads_over_model(mesh_out):
    """(n_pages, page_size, KV, dh): KV over "model", every page on every
    data rank (reduced granite-moe: 2 KV heads, one a rank)."""
    specs = mesh_out[0]["pool specs"]
    assert all(s["pool_k"] == s["pool_v"] == (None, None, "model", None) for s in specs)
    cfg = _cfg(ARCHS[-1])
    assert mesh_out[0]["pool shape"][2:] == (cfg.n_kv_heads // 2, cfg.head_dim)


@pytest.mark.parametrize("arch", ARCHS)
def test_native_sharded_stream_is_the_unsharded_stream(mesh_out, single, arch):
    want = single[arch, "native"]
    assert len(want[0]) == len(STREAM) and all(len(t) > 0 for t in want[0].values())
    assert _same(mesh_out, (arch, "native"), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_native_sharded_stream_is_bitwise_the_split_oracle(mesh_out, single, arch):
    """The oracle that the card holds the native stream to (there a
    product's bits depend on the rows and batch of its call): on the CPU
    it is the unsharded stream too."""
    assert _same(mesh_out, (arch, "native"), single[arch, "native oracle"])
    assert _same(mesh_out, (arch, "native"), single[arch, "native"])


@pytest.mark.parametrize("arch", ARCHS)
def test_amsim_sharded_stream_is_bitwise_the_ksplit_oracle(mesh_out, single, arch):
    assert _same(mesh_out, (arch, "afm16"), single[arch, "afm16 oracle"])


@pytest.mark.parametrize("arch", ARCHS)
def test_slots_the_data_axes_do_not_divide(mesh_out, single, arch):
    """Three slots: every data rank runs every slot inside its "model"
    group; the tokens are the unsharded stream's of three slots."""
    from repro_torch.launch.mesh import single_device
    with single_device():
        want = _stream(_model(arch), "native", capacity=3)
    assert _same(mesh_out, (arch, "native", 3), want, split=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_kill_switch_stream_is_bitwise_single_device(mesh_out, single, arch):
    """REPRO_SHARD_FUSED=0: the chain on each layer's gathered weights and
    pools, bitwise the single-device stream with the chain on."""
    assert _same(mesh_out, (arch, "afm16 killed"), single[arch, "afm16"])


def test_serve_cli_stream_on_the_mesh(capfd):
    from repro_torch.launch import serve
    rep = serve.main(["--arch", "granite-moe-3b-a800m", "--reduced", "--device", "cpu",
                      "--mesh", "--stream", "5", "--prompt-len", "9", "--new-tokens", "3",
                      "--capacity", "4", "--page-size", "4", "--tiers",
                      "exact=native,cheap=amsim:afm16"])
    text = capfd.readouterr().out
    assert "backend gloo" in text and "stream: 5 requests, 15 tokens" in text
    assert "collectives on rank 0" in text
    assert len(rep["tokens"]) == 5 and all(len(t) == 3 for t in rep["tokens"].values())
    assert np.isfinite(rep["stream"]["tokens_per_s"])
