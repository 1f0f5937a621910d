"""The port's dense decode chain against the JAX package's.

At the widths of ``reduced(get_arch("granite-3-2b"), n_layers=2)`` (rows
2, d 128, H*dh 128, KV*dh 64, d_ff 256), the same numpy inputs go through
the chain kernels' plain versions (``fused_qkv_norm_plain``,
``fused_out_mlp_plain`` with and without biases,
``fused_attn_out_mlp_plain``) and through the JAX package's per-op
oracles (``ops.decode_qkv_oracle`` / ``decode_out_mlp_oracle`` under
``amsim_jnp``) and its chain kernels in interpret mode, with the autotune
cache pinned empty as ``tests/test_decode_chain.py`` pins it.  The port's
own wrappers and its ``ops.decode_*`` dispatch are held to the plain
versions bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lutgen as jlutgen  # noqa: E402
from repro.core.policy import NumericsPolicy as JaxPolicy  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import decode_chain as jchain  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs.base import get_arch, reduced  # noqa: E402
from repro_torch.core import lutgen  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.kernels import decode_chain, ops  # noqa: E402
from repro_torch.kernels.common import POS_PAD, lut_tensor  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _own_lut_dir(tmp_path_factory):
    """The JAX package caches LUTs on disk through one fixed temporary name
    per table; give this module its own directory, so that it never writes
    the shared one while another test process reads it.  Pin the JAX
    chain's tiling to its defaults with an empty autotune cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DIR", str(tmp_path_factory.mktemp("luts")))
        mp.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path_factory.mktemp("tune") / "none.json"))
        jautotune.reload_cache()
        yield
    jautotune.reload_cache()


MULT = "afm16"
EPS = 1e-5
CFG = reduced(get_arch("granite-3-2b"), n_layers=2)
ROWS = 2
# Every product meets the same LUT in both packages; the rmsnorm rsqrt,
# silu exp and softmax exp and the norm/softmax sums differ between torch
# and XLA on the CPU by an ulp or so, and a LUT product may carry such an
# ulp across a mantissa truncation step.  Observed at most 2.4e-7 at
# outputs of O(1); the tolerance is atol=rtol=1e-5.
TOL = dict(rtol=1e-5, atol=1e-5)


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    d, F = CFG.d_model, CFG.d_ff
    hq, hkv = CFG.n_heads * CFG.head_dim, CFG.n_kv_heads * CFG.head_dim

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=r(ROWS, d), g1=1 + r(d, scale=0.1), g2=1 + r(d, scale=0.1),
                wq=r(d, hq, scale=d ** -0.5), wk=r(d, hkv, scale=d ** -0.5),
                wv=r(d, hkv, scale=d ** -0.5), attn=r(ROWS, hq), wo=r(hq, d, scale=hq ** -0.5),
                wg=r(d, F, scale=d ** -0.5), wu=r(d, F, scale=d ** -0.5),
                wd=r(F, d, scale=F ** -0.5), bo=r(d, scale=0.1), bd=r(d, scale=0.1))


def _decode_attention(seed=1):
    rng = np.random.default_rng(seed)
    B, H, KV, dh, T = ROWS, CFG.n_heads, CFG.n_kv_heads, CFG.head_dim, 16
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, dh)).astype(np.float32)
    return q, k, v, np.asarray([9], np.int32), np.asarray(list(range(10)) + [POS_PAD] * 6,
                                                           np.int32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _luts():
    M = lutgen.get_multiplier(MULT).mantissa_bits
    return (lut_tensor(lutgen.get_lut(MULT), "cpu"), lut_tensor(lutgen.get_packed_lut(MULT), "cpu"),
            jnp.asarray(jlutgen.get_packed_lut(MULT)), M)


JAX_AMSIM = JaxPolicy(mode="amsim_jnp", multiplier=MULT)


def test_qkv_plain_matches_jax():
    o = _operands()
    lut, _, jlut, M = _luts()
    names = ("x", "g1", "wq", "wk", "wv")
    plain = decode_chain.fused_qkv_norm_plain(*_t(*(o[n] for n in names)), lut, M, eps=EPS)
    oracle = jops.decode_qkv_oracle(*_j(*(o[n] for n in names)), JAX_AMSIM, EPS)
    fused = jchain.fused_qkv_norm(*_j(*(o[n] for n in names)), jlut, M, eps=EPS, interpret=True)
    for p, a, b in zip(plain, oracle, fused):
        np.testing.assert_allclose(p.numpy(), np.asarray(a), **TOL)
        np.testing.assert_allclose(p.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("biases", [False, True])
def test_out_mlp_plain_matches_jax(biases):
    o = _operands(seed=2)
    lut, _, jlut, M = _luts()
    names = ("x", "attn", "g2", "wo", "wg", "wu", "wd")
    bias = {"bo": o["bo"], "bd": o["bd"]} if biases else {}
    plain = decode_chain.fused_out_mlp_plain(*_t(*(o[n] for n in names)), lut, M, eps=EPS,
                                             **{k: torch.from_numpy(v) for k, v in bias.items()})
    jbias = {k: jnp.asarray(v) for k, v in bias.items()}
    oracle = jops.decode_out_mlp_oracle(*_j(*(o[n] for n in names)), JAX_AMSIM, EPS, **jbias)
    fused = jchain.fused_out_mlp(*_j(*(o[n] for n in names)), jlut, M, eps=EPS, interpret=True,
                                 **jbias)
    np.testing.assert_allclose(plain.numpy(), np.asarray(oracle), **TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(fused), **TOL)


def test_attn_out_mlp_plain_matches_jax():
    o = _operands(seed=3)
    lut, _, jlut, M = _luts()
    att = _decode_attention()
    back = ("g2", "wo", "wg", "wu", "wd")
    plain = decode_chain.fused_attn_out_mlp_plain(
        *_t(o["x"], *att, *(o[n] for n in back)), lut, M, eps=EPS, causal=True, window=0)
    fused = jchain.fused_attn_out_mlp(*_j(o["x"], *att, *(o[n] for n in back)), jlut, M,
                                      eps=EPS, interpret=True)
    np.testing.assert_allclose(plain.numpy(), np.asarray(fused), **TOL)
    # The per-op composition of the JAX package: einsum attention + oracle.
    q, k, v, qp, kp = _j(*att)
    a = jops.attend_einsum(q, k, v, qp, kp, JAX_AMSIM, causal=True, window=0)
    oracle = jops.decode_out_mlp_oracle(jnp.asarray(o["x"]), a.reshape(ROWS, -1),
                                        *_j(*(o[n] for n in back)), JAX_AMSIM, EPS)
    np.testing.assert_allclose(plain.numpy(), np.asarray(oracle), **TOL)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors each wrapper runs its plain version; with the packed
    LUT it gives the canonical table's bits."""
    o = _operands(seed=4)
    lut, packed, _, M = _luts()
    qkv = ("x", "g1", "wq", "wk", "wv")
    for a, b in zip(decode_chain.fused_qkv_norm(*_t(*(o[n] for n in qkv)), packed, M, eps=EPS),
                    decode_chain.fused_qkv_norm_plain(*_t(*(o[n] for n in qkv)), lut, M,
                                                      eps=EPS)):
        assert torch.equal(a, b)
    back = ("x", "attn", "g2", "wo", "wg", "wu", "wd")
    bias = dict(zip(("bo", "bd"), _t(o["bo"], o["bd"])))
    assert torch.equal(
        decode_chain.fused_out_mlp(*_t(*(o[n] for n in back)), packed, M, eps=EPS, **bias),
        decode_chain.fused_out_mlp_plain(*_t(*(o[n] for n in back)), lut, M, eps=EPS, **bias))
    att = _t(*_decode_attention())
    tail = _t(*(o[n] for n in ("g2", "wo", "wg", "wu", "wd")))
    x = torch.from_numpy(o["x"])
    assert torch.equal(
        decode_chain.fused_attn_out_mlp(x, *att, *tail, packed, M, eps=EPS),
        decode_chain.fused_attn_out_mlp_plain(x, *att, *tail, lut, M, eps=EPS, causal=True,
                                              window=0))


@pytest.mark.parametrize("mode", ["amsim", "amsim_torch"])
def test_ops_chain_dispatch_is_bitwise_across_modes(mode):
    """``amsim`` (the wrappers; on the CPU, their plain versions) and
    ``amsim_torch`` (the plain versions) give the same bits."""
    o = _operands(seed=5)
    lut, _, _, M = _luts()
    policy = NumericsPolicy(mode=mode, multiplier=MULT)
    assert ops.decode_chain_enabled(policy)
    qkv = ops.decode_qkv(*_t(*(o[n] for n in ("x", "g1", "wq", "wk", "wv"))), policy, EPS)
    ref = decode_chain.fused_qkv_norm_plain(*_t(*(o[n] for n in ("x", "g1", "wq", "wk", "wv"))),
                                            lut, M, eps=EPS)
    assert all(torch.equal(a, b) for a, b in zip(qkv, ref))
    back = _t(*(o[n] for n in ("x", "attn", "g2", "wo", "wg", "wu", "wd")))
    assert torch.equal(ops.decode_out_mlp_b(*back, None, None, policy, EPS),
                       decode_chain.fused_out_mlp_plain(*back, lut, M, eps=EPS))
    att = _t(*_decode_attention())
    tail = _t(*(o[n] for n in ("g2", "wo", "wg", "wu", "wd")))
    x = torch.from_numpy(o["x"])
    assert torch.equal(
        ops.decode_attn_out_mlp(x, *att, *tail, None, None, policy, EPS, True, 0),
        decode_chain.fused_attn_out_mlp_plain(x, *att, *tail, lut, M, eps=EPS, causal=True,
                                              window=0))


def test_chain_guard():
    amsim = NumericsPolicy(mode="amsim", multiplier=MULT)
    assert ops.decode_fuse_attn_enabled(amsim, 128)
    assert not ops.decode_fuse_attn_enabled(amsim, 129)
    assert ops.decode_chain_enabled(amsim)
    # Native attention under an approximate policy splits the leaves.
    assert not ops.decode_chain_enabled(
        NumericsPolicy(mode="amsim", multiplier=MULT, approx_attention=False))
    for policy in (NumericsPolicy(), NumericsPolicy(mode="direct", multiplier=MULT),
                   NumericsPolicy(mode="amsim", multiplier="fp32")):
        assert not ops.decode_chain_enabled(policy)


def test_rmsnorm_lanes_matches_jax_rmsnorm():
    from repro.models.layers import rmsnorm as jax_rmsnorm
    o = _operands(seed=6)
    out = decode_chain.rmsnorm_lanes(*_t(o["x"], o["g1"]), EPS)
    ref = jax_rmsnorm({"g": jnp.asarray(o["g1"])}, jnp.asarray(o["x"]), EPS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _biases(t):
    """(bo, bd) of an out-mlp entry's operands: the last two when given."""
    return (t[7], t[8]) if len(t) == 9 else (None, None)


def _attn_out_mlp_oracle(attend, oracle, pol, x, q, k, v, qp, kp, *tail):
    B, S, H, dh = q.shape
    a = attend(q, k, v, qp, kp, pol, causal=True, window=0).reshape(B * S, H * dh)
    return oracle(x, a, *tail[:5], pol, EPS, bo=tail[5], bd=tail[6])


BACK = ("x", "attn", "g2", "wo", "wg", "wu", "wd")
# entry: (operand names, the port's entry, the port's oracle, JAX's oracle)
CHAIN_GRADS = {
    "qkv": (("x", "g1", "wq", "wk", "wv"),
            lambda pol, *t: ops.decode_qkv(*t, pol, EPS),
            lambda pol, *t: ops.decode_qkv_oracle(*t, pol, EPS),
            lambda *t: jops.decode_qkv_oracle(*t, JAX_AMSIM, EPS)),
    "out_mlp": (BACK,
                lambda pol, *t: ops.decode_out_mlp_b(*t[:7], *_biases(t), pol, EPS),
                lambda pol, *t: ops.decode_out_mlp_oracle(*t[:7], pol, EPS),
                lambda *t: (jops.decode_out_mlp_oracle(*t[:7], JAX_AMSIM, EPS),)),
    "out_mlp_biased": (BACK + ("bo", "bd"),
                       lambda pol, *t: ops.decode_out_mlp_b(*t[:7], *_biases(t), pol, EPS),
                       lambda pol, *t: ops.decode_out_mlp_oracle(*t[:7], pol, EPS,
                                                                 bo=t[7], bd=t[8]),
                       lambda *t: (jops.decode_out_mlp_oracle(*t[:7], JAX_AMSIM, EPS,
                                                              bo=t[7], bd=t[8]),)),
    "attn_out_mlp": (("x", "q", "k", "v", "q_pos", "k_pos", "g2", "wo", "wg", "wu", "wd", "bo",
                      "bd"),
                     lambda pol, *t: ops.decode_attn_out_mlp(*t, pol, EPS, True, 0),
                     lambda pol, *t: _attn_out_mlp_oracle(ops.attend_einsum,
                                                          ops.decode_out_mlp_oracle, pol, *t),
                     lambda *t: (_attn_out_mlp_oracle(jops.attend_einsum,
                                                      jops.decode_out_mlp_oracle, JAX_AMSIM,
                                                      *t),)),
}


@pytest.mark.parametrize("entry", sorted(CHAIN_GRADS))
def test_chain_gradients_are_their_oracles(entry):
    """Each chain entry's backward recomputes its per-op oracle: under
    ``amsim`` (the plain versions here) every gradient is bitwise the
    oracle's autograd gradient under ``amsim_torch``, and within rtol 1e-4,
    atol 1e-5 of JAX's oracle VJP under ``amsim_jnp``."""
    names, port, oracle, jax_oracle = CHAIN_GRADS[entry]
    o = _operands(seed=7)
    o.update(zip(("q", "k", "v", "q_pos", "k_pos"), _decode_attention()))
    arrays = [o[n] for n in names]
    floats = [i for i, a in enumerate(arrays) if a.dtype == np.float32]

    def grads(fn, policy):
        ts = [t.requires_grad_(i in floats) for i, t in enumerate(_t(*arrays))]
        out = fn(policy, *ts)
        outs = out if isinstance(out, tuple) else (out,)
        rng = np.random.default_rng(8)
        cot = [torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32)) for y in outs]
        return torch.autograd.grad(outs, [ts[i] for i in floats], cot), cot

    got, cot = grads(port, NumericsPolicy(mode="amsim", multiplier=MULT))
    want, _ = grads(oracle, NumericsPolicy(mode="amsim_torch", multiplier=MULT))
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))

    def jax_fn(*diff):
        full = _j(*arrays)
        for i, t in zip(floats, diff):
            full[i] = t
        return jax_oracle(*full)

    ref = jax.jit(lambda t, c: jax.vjp(jax_fn, *t)[1](tuple(c)))(
        [jnp.asarray(arrays[i]) for i in floats], [jnp.asarray(c.numpy()) for c in cot])
    assert len(ref) == len(got) == len(floats)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
