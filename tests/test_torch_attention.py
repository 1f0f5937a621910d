"""The port's attention against the JAX package's.

Same numpy inputs, made from a seed, through both packages on the CPU:
* the fused kernel's plain version (``approx_attention_plain``, and the
  wrapper ``approx_attention``, which runs it for CPU tensors) against JAX
  ``ops.attend_einsum`` under ``amsim_jnp`` and against the JAX kernel
  ``approx_attention_fused(..., chunk=1, interpret=True)``;
* ``ops.attend_einsum`` under ``amsim_torch`` against the plain version,
  bit for bit (so ``amsim`` and ``amsim_torch`` attention agree on the
  card), and under ``native`` against JAX ``native``;
covering causal prefill, a sliding window, G = 1 and G > 1 heads per KV
head, decode over a ring with wrapped and unwritten slots, and the
bidirectional (``causal=False``) attention of an encoder and of
cross-attention: S = T, S != T, one query over T keys.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lutgen as jlutgen  # noqa: E402
from repro.core.policy import NumericsPolicy as JaxPolicy  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.approx_attention import approx_attention_fused  # noqa: E402
from repro.kernels.common import attention_mask as jax_attention_mask  # noqa: E402
from repro_torch.core import lutgen  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.approx_attention import (approx_attention,  # noqa: E402
                                                  approx_attention_plain)
from repro_torch.kernels.common import POS_PAD, attention_mask, lane_sum, lut_tensor  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _own_lut_dir(tmp_path_factory):
    """The JAX package caches LUTs on disk through one fixed temporary name
    per table; give this module its own directory, so that it never writes
    the shared one while another test process reads it.  The JAX kernel's
    tiling comes from its autotune cache: pin that to an empty path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DIR", str(tmp_path_factory.mktemp("luts")))
        mp.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path_factory.mktemp("tune") / "none.json"))
        jautotune.reload_cache()
        yield
    jautotune.reload_cache()


MULT = "afm16"
# Ring of 16 slots after 20 tokens: slot i holds position p with p % 16 == i.
RING_WRAPPED = [16, 17, 18, 19] + list(range(4, 16))
# Ring of 16 slots after 10 tokens: six slots unwritten.
RING_PARTIAL = list(range(10)) + [POS_PAD] * 6
# name: (B, S, H, KV, dh, T, q_pos, k_pos, causal, window)
CASES = {
    "prefill_causal_G2": (2, 8, 4, 2, 32, 8, range(8), range(8), True, 0),
    "prefill_causal_G1": (2, 8, 2, 2, 32, 8, range(8), range(8), True, 0),
    "prefill_window3": (2, 8, 4, 2, 32, 8, range(8), range(8), True, 3),
    "decode_ring_wrapped": (2, 1, 4, 2, 32, 16, [19], RING_WRAPPED, True, 0),
    "decode_ring_unwritten": (2, 1, 4, 2, 32, 16, [9], RING_PARTIAL, True, 0),
    "bidirectional_G2": (2, 8, 4, 2, 32, 8, range(8), range(8), False, 0),
    "cross_S6_T11_G1": (2, 6, 2, 2, 32, 11, range(6), range(11), False, 0),
    "cross_decode_T11": (2, 1, 4, 2, 32, 11, [0], range(11), False, 0),
}


def _inputs(case, seed=0):
    B, S, H, KV, dh, T, q_pos, k_pos, causal, window = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, dh)).astype(np.float32)
    pos = (np.asarray(list(q_pos), np.int32), np.asarray(list(k_pos), np.int32))
    return (q, k, v, *pos), dict(causal=causal, window=window)


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _lut(packed):
    table = lutgen.get_packed_lut(MULT) if packed else lutgen.get_lut(MULT)
    return lut_tensor(table, "cpu"), lutgen.get_multiplier(MULT).mantissa_bits


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_attention_matches_jax(case):
    """Scores fold dh products in order in both packages and the value
    GEMM folds T products in order; the softmax denominator is summed in
    the warp order here and in XLA's order there, so probabilities may
    differ by an ulp, which a LUT product can carry across a mantissa
    truncation step.  Observed: equal, or 3e-8 apart at outputs of O(1);
    the tolerance is atol=rtol=1e-5."""
    arrays, kw = _inputs(case)
    lut, M = _lut(False)
    plain = approx_attention_plain(*_torch(arrays), lut, M, **kw).numpy()
    j = [jnp.asarray(a) for a in arrays]
    ref = np.asarray(jops.attend_einsum(*j, JaxPolicy(mode="amsim_jnp", multiplier=MULT), **kw))
    np.testing.assert_allclose(plain, ref, rtol=1e-5, atol=1e-5)
    fused = np.asarray(approx_attention_fused(*j, jnp.asarray(jlutgen.get_packed_lut(MULT)), M,
                                              chunk=1, interpret=True, **kw))
    np.testing.assert_allclose(plain, fused, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_and_einsum_lowering_equal_the_plain_version(case):
    """For CPU tensors the wrapper runs the plain version (here with the
    packed LUT, which gives the canonical table's products); the einsum
    lowering under ``amsim_torch`` is the same arithmetic.  Bitwise."""
    arrays, kw = _inputs(case, seed=1)
    lut, M = _lut(False)
    packed, _ = _lut(True)
    plain = approx_attention_plain(*_torch(arrays), lut, M, **kw)
    assert torch.equal(approx_attention(*_torch(arrays), packed, M, **kw), plain)
    policy = NumericsPolicy(mode="amsim_torch", multiplier=MULT)
    assert torch.equal(ops.attend_einsum(*_torch(arrays), policy, **kw), plain)


@pytest.mark.parametrize("case", ["prefill_window3", "decode_ring_wrapped"])
def test_native_attention_matches_jax(case):
    """Exact float32 on both sides; einsum and softmax sums differ in
    order only: rtol=atol=1e-5."""
    arrays, kw = _inputs(case, seed=2)
    out = ops.attend_einsum(*_torch(arrays), NumericsPolicy(), **kw).numpy()
    ref = np.asarray(jops.attend_einsum(*[jnp.asarray(a) for a in arrays], JaxPolicy(), **kw))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_mask_matches_jax(case):
    arrays, kw = _inputs(case)
    mask = attention_mask(*_torch(arrays[3:]), **kw).numpy()
    ref = np.asarray(jax_attention_mask(*[jnp.asarray(a) for a in arrays[3:]], **kw))
    np.testing.assert_array_equal(mask, ref)


def test_row_without_a_valid_key_averages_v():
    """A query whose keys are all masked gets a uniform softmax, as the JAX
    einsum lowering gives it: the output is the mean of V through the LUT
    (the JAX kernel returns zeros there instead)."""
    arrays, kw = _inputs("decode_ring_unwritten", seed=3)
    q, k, v, _, _ = arrays
    k_pos = np.full(k.shape[1], POS_PAD, np.int32)
    lut, M = _lut(False)
    out = approx_attention_plain(*_torch([q, k, v, np.asarray([0], np.int32), k_pos]), lut, M,
                                 **kw)
    ref = np.asarray(jops.attend_einsum(
        *[jnp.asarray(a) for a in (q, k, v, np.asarray([0], np.int32), k_pos)],
        JaxPolicy(mode="amsim_jnp", multiplier=MULT), **kw))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert np.abs(out.numpy()).max() > 0


def _lane_sum_loop(x):
    """The warp's order spelt out one addition at a time."""
    lanes = [np.float32(0)] * 32
    for i, value in enumerate(x):
        lanes[i % 32] = np.float32(lanes[i % 32] + value)
    off = 16
    while off:
        lanes = [np.float32(lanes[i] + lanes[i + off]) for i in range(off)]
        off //= 2
    return lanes[0]


@pytest.mark.parametrize("n", [1, 31, 32, 33, 130, 2048])
def test_lane_sum_is_the_warp_order(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = lane_sum(torch.from_numpy(x)[None])[0].item()
    assert np.float32(got) == _lane_sum_loop(x)


def test_batched_products_need_the_batched_kernel_under_amsim():
    """Under amsim an equal-batch product runs the batched kernel (on CPU
    tensors its plain version): the bits of amsim_torch."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 4, 5)).astype(np.float32))
    out = ops.policy_matmul(a, b, NumericsPolicy(mode="amsim", multiplier=MULT))
    ref = ops.policy_matmul(a, b, NumericsPolicy(mode="amsim_torch", multiplier=MULT))
    assert out.shape == (2, 3, 5) and torch.equal(out, ref)


@pytest.mark.parametrize("spec,sa,sb", [("bqkgd,btkd->bkgqt", (2, 3, 2, 2, 4), (2, 5, 2, 4)),
                                        ("bkgqt,btkd->bqkgd", (2, 2, 2, 3, 5), (2, 5, 2, 4))])
def test_policy_einsum_matches_jax(spec, sa, sb):
    rng = np.random.default_rng(4)
    a = rng.standard_normal(sa).astype(np.float32)
    b = rng.standard_normal(sb).astype(np.float32)
    out = ops.policy_einsum(spec, torch.from_numpy(a), torch.from_numpy(b),
                            NumericsPolicy(mode="amsim_torch", multiplier=MULT), "attn_score")
    ref = jops.policy_einsum(spec, jnp.asarray(a), jnp.asarray(b),
                             JaxPolicy(mode="amsim_jnp", multiplier=MULT), "attn_score")
    # k <= 5 products: JAX sums them in one reduction, the port in order;
    # a few ulps of reassociation at outputs of O(1).
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    native = ops.policy_einsum(spec, torch.from_numpy(a), torch.from_numpy(b), NumericsPolicy())
    np.testing.assert_allclose(native.numpy(), np.einsum(spec, a, b), rtol=1e-5, atol=1e-5)


def _attention_grads(fn, q, k, v, g):
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    return torch.autograd.grad(fn(q, k, v), (q, k, v), g)


@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_attention_gradient_is_the_einsum_lowerings(case):
    """The fused attention's backward recomputes ``attend_einsum``: under
    ``amsim`` (the kernels' plain versions here) dq, dk and dv are bitwise
    the gradients of the einsum lowering under ``amsim_torch``, and within
    rtol 1e-4, atol 1e-5 of JAX's ``attend_einsum`` VJP under
    ``amsim_jnp`` (its softmax sums and exps differ by ulps)."""
    arrays, kw = _inputs(case)
    q, k, v, qp, kp = _torch(arrays)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(q.shape).astype(np.float32))
    amsim = NumericsPolicy(mode="amsim", multiplier=MULT)
    got = _attention_grads(lambda q, k, v: ops.policy_attention(
        q, k, v, qp, kp, amsim, kw["causal"], kw["window"]), q, k, v, g)
    want = _attention_grads(lambda q, k, v: ops.attend_einsum(
        q, k, v, qp, kp, NumericsPolicy(mode="amsim_torch", multiplier=MULT), **kw), q, k, v, g)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    j = [jnp.asarray(a) for a in arrays]

    @jax.jit
    def jax_grads(q_, k_, v_, g_):
        return jax.vjp(lambda *t: jops.attend_einsum(
            *t, j[3], j[4], JaxPolicy(mode="amsim_jnp", multiplier=MULT), **kw), q_, k_, v_)[1](g_)

    for a, b in zip(got, jax_grads(*j[:3], jnp.asarray(g.numpy()))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_attention_backward_chunked_matches_unchunked(monkeypatch):
    """A 64-query prefill with the backward's query chunk forced to 32: dq
    splits by chunk, bitwise the unchunked recompute's; dk and dv sum two
    chunks' folds, within rtol 1e-5, atol 1e-6 of the one fold."""
    rng = np.random.default_rng(3)
    B, S, H, KV, dh = 2, 64, 4, 2, 16
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in
                  ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh), (B, S, H, dh)))
    pos = torch.arange(S, dtype=torch.int32)
    amsim = NumericsPolicy(mode="amsim", multiplier=MULT)
    calls = []
    recompute = ops.attend_einsum
    monkeypatch.setattr(ops, "attend_einsum", lambda q, *a, **kw: calls.append(q.shape[1])
                        or recompute(q, *a, **kw))
    out = {}
    for chunk in (1024, 32):
        monkeypatch.setattr(ops, "_BWD_Q_CHUNK", chunk)
        calls.clear()
        out[chunk] = _attention_grads(lambda q, k, v: ops.policy_attention(
            q, k, v, pos, pos, amsim, True, 0), q, k, v, g)
        assert calls == ([S] if chunk == 1024 else [32, 32])
    (dq, dk, dv), (cq, ck, cv) = out[1024], out[32]
    assert torch.equal(dq.view(torch.int32), cq.view(torch.int32))
    np.testing.assert_allclose(ck.numpy(), dk.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cv.numpy(), dv.numpy(), rtol=1e-5, atol=1e-6)


def test_attention_backward_chunked_bidirectional_cross(monkeypatch):
    """Cross-attention of 64 queries over 40 keys, ``causal=False``, the
    backward's query chunk forced to 32: dq splits by chunk, bitwise the
    unchunked recompute's; dk and dv, of the 40 keys, sum two chunks' folds
    in order (JAX ``_pattn_bwd``'s sum over its two chunks), within rtol
    1e-5, atol 1e-6 of the one fold.  The unchunked gradients are held to
    JAX's in ``test_policy_attention_gradient_is_the_einsum_lowerings``."""
    rng = np.random.default_rng(8)
    B, S, T, H, KV, dh = 2, 64, 40, 4, 2, 16
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in
                  ((B, S, H, dh), (B, T, KV, dh), (B, T, KV, dh), (B, S, H, dh)))
    qp, kp = np.arange(S, dtype=np.int32), np.arange(T, dtype=np.int32)
    amsim = NumericsPolicy(mode="amsim", multiplier=MULT)
    out = {}
    for chunk in (1024, 32):
        monkeypatch.setattr(ops, "_BWD_Q_CHUNK", chunk)
        out[chunk] = _attention_grads(lambda q, k, v: ops.policy_attention(
            q, k, v, _torch([qp])[0], _torch([kp])[0], amsim, False, 0),
            *_torch([q, k, v, g]))
    (dq, dk, dv), (cq, ck, cv) = out[1024], out[32]
    assert ck.shape == (B, T, KV, dh) and cv.shape == (B, T, KV, dh)
    assert torch.equal(dq.view(torch.int32), cq.view(torch.int32))
    np.testing.assert_allclose(ck.numpy(), dk.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cv.numpy(), dv.numpy(), rtol=1e-5, atol=1e-6)
