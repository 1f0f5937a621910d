"""Int8 gradient compression with error feedback
(``repro_torch.distributed.compression``) against the JAX package's
``repro.distributed.compression``: the block quantiser bitwise in one
process; ``compressed_all_reduce`` over a (4, 1) mesh of four gloo ranks
on the CPU bitwise the composition of JAX's ``quantize_int8`` /
``dequantize_int8`` with the shared (MAX) scale, and JAX's error-feedback
property (``tests/test_distributed.py``: one-shot error < 0.05, the mean
of 20 steps within half of it).  Also the mesh launcher's failure paths:
a rank that raises, and a deadline that passes, fail the run and name
the ranks.
"""
import time

import numpy as np
import pytest
import torch

N_RANKS, WIDTH, STEPS = 4, 1000, 20      # 1000: the last block is padded


def _grads() -> np.ndarray:
    return (np.random.default_rng(0).standard_normal((N_RANKS, WIDTH)) * 0.1).astype(np.float32)


def _reduce(mesh):
    """Rank r's gradient is row r: one reduce from zero error feedback,
    then ``STEPS`` reduces carrying it."""
    from repro_torch.distributed.compression import compressed_all_reduce, init_ef_state

    g = {"g": torch.from_numpy(_grads()[mesh.rank])}
    ef = init_ef_state(g)
    one, ef1 = compressed_all_reduce(g, ef, mesh, "data")
    acc = torch.zeros(WIDTH)
    for _ in range(STEPS):
        mean, ef = compressed_all_reduce(g, ef, mesh, "data")
        acc = acc + mean["g"]
    return {"one": one["g"], "ef1": ef1["g"], "avg": acc / STEPS}


@pytest.fixture(scope="module")
def ranks():
    from repro_torch.launch.mesh import spawn
    return spawn(_reduce, (N_RANKS, 1), device="cpu", timeout=120)


def test_quantize_dequantize_bitwise_jax():
    import jax.numpy as jnp
    from repro.distributed.compression import dequantize_int8 as jdeq
    from repro.distributed.compression import quantize_int8 as jq

    from repro_torch.distributed.compression import dequantize_int8, quantize_int8
    x = (np.random.default_rng(1).standard_normal(1000) * 5).astype(np.float32)
    x[:7] = 0.0
    q, scale, pad = quantize_int8(torch.from_numpy(x))
    jqv, jscale, jpad = jq(jnp.asarray(x))
    assert pad == jpad == 24
    assert np.array_equal(q.numpy(), np.asarray(jqv))
    assert np.array_equal(scale.numpy(), np.asarray(jscale))
    back = dequantize_int8(q, scale, pad, x.shape)
    assert np.array_equal(back.numpy(), np.asarray(jdeq(jqv, jscale, jpad, x.shape)))


def test_compressed_all_reduce_bitwise_jax_composition(ranks):
    """Every rank's mean, and its new error feedback, are the JAX
    composition's: the scales' MAX, each rank's int8 payload under it, the
    int32 sum dequantised and divided by the ranks."""
    import jax.numpy as jnp
    from repro.distributed.compression import _blockify, dequantize_int8, quantize_int8
    g = _grads()
    scales = [jnp.maximum(jnp.max(jnp.abs(_blockify(jnp.asarray(r))[0]), axis=1, keepdims=True)
                          / 127.0, 1e-12) for r in g]
    shared = scales[0]
    for s in scales[1:]:
        shared = jnp.maximum(shared, s)
    qs = [quantize_int8(jnp.asarray(r), shared) for r in g]
    summed = sum(q.astype(jnp.int32) for q, _, _ in qs)
    mean = np.asarray(dequantize_int8(summed, shared, qs[0][2], (WIDTH,)) / N_RANKS)
    for r, out in enumerate(ranks):
        assert np.array_equal(out["one"].numpy(), mean), r
        ef = np.asarray(jnp.asarray(g[r]) - dequantize_int8(qs[r][0], shared, qs[r][2], (WIDTH,)))
        assert np.array_equal(out["ef1"].numpy(), ef), r


def test_error_feedback_property(ranks):
    true = _grads().mean(0)
    err1 = float(np.abs(ranks[0]["one"].numpy() - true).max())
    err_avg = float(np.abs(ranks[0]["avg"].numpy() - true).max())
    assert err1 < 0.05, err1
    assert err_avg < err1 * 0.5 + 1e-4, (err_avg, err1)


def _raise_on_rank_2(mesh):
    if mesh.rank == 2:
        raise ValueError("rank 2 fails on purpose")
    mesh.ordered_sum(torch.ones(3), "data")     # the others wait in a collective


def _sleep(mesh):
    time.sleep(60)


@pytest.mark.parametrize("fn, timeout, text", [
    (_raise_on_rank_2, 60, r"rank 2 of 4 exited with code 1:(.|\n)*rank 2 fails on purpose"),
    (_sleep, 2, r"ranks \[0, 1, 2, 3\] of 4 still running after the 2 s deadline")])
def test_a_failing_rank_fails_the_run(fn, timeout, text):
    from repro_torch.launch.mesh import RankFailed, spawn
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match=text):
        spawn(fn, (2, 2), device="cpu", timeout=timeout)
    assert time.monotonic() - t0 < 30
