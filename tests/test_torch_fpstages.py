"""The port's staged multiplier generator and cross-format tables against
the JAX package.

* ``repro_torch.core.fpstages`` emits the same tables as
  ``repro.core.fpstages`` and as the black-box Algorithm 1, reproduces the
  hand-written families, keeps the cross-format laws (square tables, the
  mirror law, the asymmetric truncation), and every LUT of the port
  matches ``tests/golden/lut_digests.json`` by CRC32, the cross-format
  ones included;
* ``torch_pipeline_multiply`` (``Multiplier.torch_mul`` of a generated
  multiplier, the ``direct`` mode) is bitwise ``np_mul``;
* under the asymmetric tables ``fp16xbf16`` and ``bf16xfp16`` every op
  keeps JAX's operand roles: the forward and both gradients of
  ``policy_matmul`` (2-D and batched) and ``approx_conv2d`` bitwise the
  JAX kernels at chunk=1 (both fold k in order), ``policy_attention`` and
  the five decode entries within the stated tolerances of the JAX
  lowerings under ``amsim_jnp``;
* ``surrogate`` cuts each operand bitwise as ``np_truncate_mantissa`` /
  ``np_round_mantissa`` do, and its products are within rtol 1e-6 of
  JAX's surrogate.
"""
import dataclasses
import json
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fpstages as jfs  # noqa: E402
from repro.core import lutgen as jlutgen  # noqa: E402
from repro.core.amsim import np_amsim_multiply  # noqa: E402
from repro.core.policy import NumericsPolicy as JaxPolicy  # noqa: E402
from repro.kernels import approx_conv as japprox_conv  # noqa: E402
from repro.kernels import approx_gemm as japprox_gemm  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import fpstages as fs  # noqa: E402
from repro_torch.core import lutgen, multipliers  # noqa: E402
from repro_torch.core.amsim import amsim_multiply  # noqa: E402
from repro_torch.core.float_bits import (FLOAT_FORMATS, np_bits, np_float, np_pack,  # noqa: E402
                                         np_round_mantissa, np_truncate_mantissa,
                                         torch_round_mantissa, torch_truncate_mantissa)
from repro_torch.core.multipliers import get_multiplier  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.core.quantize import quantize_format, stochastic_round_format  # noqa: E402
from repro_torch.kernels import approx_conv, ops  # noqa: E402
from repro_torch.kernels.common import lut_tensor  # noqa: E402
from repro_torch.kernels.ref import ref_direct_gemm  # noqa: E402

GOLDEN = json.loads((Path(__file__).parent / "golden" / "lut_digests.json").read_text())
CROSS = ["fp16xbf16", "bf16xfp16"]


@pytest.fixture(scope="module", autouse=True)
def _own_lut_dir(tmp_path_factory):
    """The JAX package caches LUTs on disk through one fixed temporary name
    per table: give this module its own directory.  The JAX kernels' tiling
    comes from their autotune cache: pin that to an empty path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DIR", str(tmp_path_factory.mktemp("luts")))
        mp.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path_factory.mktemp("tune") / "none.json"))
        jautotune.reload_cache()
        yield
    jautotune.reload_cache()


def _t(a, requires_grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(requires_grad)


def _classic_spec(mod, fam: str, M: int = 7):
    core = mod.MulCoreStage("exact") if fam in ("bf16", "exact", "trunc") else mod.MulCoreStage(fam)
    rnd = mod.RoundStage("rne") if fam in ("bf16", "exact") else mod.RoundStage("truncate")
    return mod.PipelineSpec(M, M, M, core=core, round=rnd)


# ------------------------------------------------------------ generator
HEADLINE = [("bf16", "bf16"), ("exact7", "exact"), ("trunc16", "trunc"),
            ("mit16", "mitchell"), ("afm16", "afm"), ("realm16", "realm")]


@pytest.mark.parametrize("name,fam", HEADLINE)
def test_generator_reproduces_handwritten_lut_bitwise(name, fam):
    hand = lutgen.generate_lut(get_multiplier(name), 7)
    np.testing.assert_array_equal(hand, fs.pipeline_lut(_classic_spec(fs, fam)))


@pytest.mark.parametrize("fam", ["bf16", "trunc", "mitchell", "afm", "realm"])
@pytest.mark.parametrize("M", [3, 10])
def test_generator_bit_identity_other_widths(fam, M):
    hand = lutgen.generate_lut(get_multiplier(f"{fam}{M}"), M)
    np.testing.assert_array_equal(hand, fs.pipeline_lut(_classic_spec(fs, fam, M)))


SPECS = {
    "fp16xbf16": lambda m: m.cross_format_spec("fp16", "bf16"),
    "fp16xbf16_tr": lambda m: m.cross_format_spec("fp16", "bf16", rounding="truncate"),
    "bf16xfp8e4m3": lambda m: m.cross_format_spec("bf16", "fp8e4m3"),
    "tpp5": lambda m: m.PipelineSpec(7, 7, 7, core=m.MulCoreStage("trunc_pp", drop_cols=5)),
    "tpp6c": lambda m: m.PipelineSpec(7, 7, 7, core=m.MulCoreStage("trunc_pp", drop_cols=6,
                                                                   compensate=True)),
    "sr3": lambda m: m.PipelineSpec(8, 8, 8, round=m.RoundStage("stochastic", seed=3)),
    "mitchell_tr": lambda m: m.PipelineSpec(7, 7, 7, core=m.MulCoreStage("mitchell"),
                                            round=m.RoundStage("truncate")),
    "gradual": lambda m: m.PipelineSpec(10, 10, 10, denorm=m.DenormStage("gradual")),
    "gradual_sr": lambda m: m.PipelineSpec(7, 5, 12, denorm=m.DenormStage("gradual"),
                                           round=m.RoundStage("stochastic", seed=2)),
}


@pytest.mark.parametrize("key", [k for k in SPECS if "gradual" not in k])
def test_pipeline_lut_equals_jax_and_blackbox(key):
    """The staged emission is byte-identical to the JAX generator's and to
    probing ``np_mul`` through Algorithm 1 (the REPRO_PIPELINE_LUT=0 path)."""
    spec = SPECS[key](fs)
    ours = fs.pipeline_lut(spec)
    assert spec.name == SPECS[key](jfs).name
    assert ours.tobytes() == jfs.pipeline_lut(SPECS[key](jfs)).tobytes()
    mult = fs.make_pipeline_multiplier(spec)
    np.testing.assert_array_equal(ours, lutgen._generate_lut_blackbox(mult, spec.table_bits))


def test_repro_pipeline_lut_switch(monkeypatch):
    mult = fs.make_pipeline_multiplier(fs.cross_format_spec("bf16", "fp8e5m2"))
    monkeypatch.setenv("REPRO_PIPELINE_LUT", "0")
    off = lutgen.generate_lut(mult)
    monkeypatch.setenv("REPRO_PIPELINE_LUT", "1")
    np.testing.assert_array_equal(lutgen.generate_lut(mult), off)


@pytest.mark.parametrize("key", sorted(GOLDEN))
def test_golden_lut_digests(key):
    """Every golden CRC32 -- the cross-format tables included -- from the
    port's ``get_lut``."""
    name, m = key.split("@M")
    lut = lutgen.get_lut(name, int(m))
    assert f"{zlib.crc32(lut.tobytes()) & 0xFFFFFFFF:08x}" == GOLDEN[key]


# ---------------------------------------------------------- cross-format
def test_cross_format_table_is_square_at_max_width():
    m = get_multiplier("fp16xbf16")
    assert m.mantissa_bits == max(FLOAT_FORMATS["fp16"], FLOAT_FORMATS["bf16"])
    assert m.operand_bits == (10, 7) and get_multiplier("afm16").operand_bits == (7, 7)
    lut = lutgen.get_lut(m)
    assert lut.shape == (1 << 20,)
    packed = lutgen.get_packed_lut(m)
    assert packed.dtype == np.uint16
    assert packed.tobytes() == jlutgen.get_packed_lut("fp16xbf16").tobytes()


def test_cross_format_mirror_law():
    """amsim[fa x fb](a, b) == amsim[fb x fa](b, a): the slots are positional."""
    n = 1 << 10
    ab = lutgen.get_lut("fp16xbf16").reshape(n, n)
    ba = lutgen.get_lut("bf16xfp16").reshape(n, n)
    np.testing.assert_array_equal(ab, ba.T)
    assert (ab != ab.T).any()


def test_cross_format_asymmetry_is_real(rng):
    m = get_multiplier("fp16xbf16")
    a = (rng.standard_normal(4096) * 3).astype(np.float32)
    b = (rng.standard_normal(4096) * 3).astype(np.float32)
    assert np.any(np_bits(m.np_mul(a, b)) != np_bits(m.np_mul(b, a)))


def test_cross_format_embeds_asymmetric_truncation(rng):
    """fp16xbf16 = a truncated to 10 bits, b to 7, the exact product, RNE to 10."""
    a = (rng.standard_normal(8192) * 5).astype(np.float32)
    b = (rng.standard_normal(8192) * 5).astype(np.float32)
    at = np_truncate_mantissa(a, 10).astype(np.float64)
    bt = np_truncate_mantissa(b, 7).astype(np.float64)
    ref = np_round_mantissa((at * bt).astype(np.float32), 10)
    np.testing.assert_array_equal(get_multiplier("fp16xbf16").np_mul(a, b), ref)


def test_cross_format_multiplier_resolution_and_aliases():
    m = get_multiplier("fp16xbf16")
    assert get_multiplier("fp16xbf16") is m and get_multiplier("fp16xbf16_rne") is m
    mt = get_multiplier("fp16xbf16_trunc")
    assert mt is not m and mt.pipeline.round.mode == "truncate"
    assert get_multiplier("fp16xbf16_sr5").pipeline.round == fs.RoundStage("stochastic", seed=5)
    assert mt.exact_family                                  # an exact core
    with pytest.raises(ValueError, match="already registered"):
        multipliers.register_multiplier(fs.make_pipeline_multiplier(
            fs.cross_format_spec("fp16", "bf16", rounding="truncate"), name="fp16xbf16"))
    with pytest.raises(ValueError, match="cross-format"):
        get_multiplier("fp17xbf16")


def test_cross_format_subgrid_model_lut_and_staged_agree():
    """A slice of the 2^10 x 2^10 grid at exponents straddling the flush
    boundary: model == the port's AMSim on the table == the staged oracle."""
    m = get_multiplier("fp16xbf16")
    f = (np.arange(0, 1 << 10, 7, dtype=np.uint32) << np.uint32(13))
    for ea, eb in ((127, 127), (1, 127), (200, 182), (60, 66)):
        a = np_float(np_pack(0, ea, f))[:, None]
        b = np_float(np_pack(1, eb, f))[None, :]
        a, b = np.broadcast_arrays(a, b)
        staged = np_bits(fs.pipeline_multiply(m.pipeline, a, b))
        np.testing.assert_array_equal(np_bits(m.np_mul(a, b)), staged)
        lutted = amsim_multiply(_t(a), _t(b), lut_tensor(lutgen.get_lut(m), "cpu"), 10)
        np.testing.assert_array_equal(np_bits(lutted.numpy()), staged)


# ---------------------------------------------------------- round modes
def test_stochastic_rounding_is_deterministic_and_seeded():
    spec = lambda s: fs.PipelineSpec(7, 7, 7, round=fs.RoundStage("stochastic", seed=s))  # noqa
    np.testing.assert_array_equal(fs.pipeline_lut(spec(1)), fs.pipeline_lut(spec(1)))
    assert np.any(fs.pipeline_lut(spec(1)) != fs.pipeline_lut(spec(2)))


def test_stochastic_rounding_brackets_truncation():
    trunc = fs.pipeline_lut(fs.PipelineSpec(7, 7, 7, round=fs.RoundStage("truncate")))
    sr = fs.pipeline_lut(fs.PipelineSpec(7, 7, 7, round=fs.RoundStage("stochastic", seed=9)))

    def value(lut):
        carry = (lut >> np.uint32(23)) & 1
        top = (lut >> np.uint32(16)) & np.uint32(0x7F)
        return ((128 + top) << carry).astype(np.int64)

    diff = value(sr) - value(trunc)
    assert diff.min() >= 0 and diff.max() <= 2 and np.any(diff > 0)


def test_trunc_pp_zero_drop_is_exact_and_never_underflows():
    exact = fs.pipeline_lut(fs.PipelineSpec(7, 7, 7))
    np.testing.assert_array_equal(exact, fs.pipeline_lut(fs.PipelineSpec(
        7, 7, 7, core=fs.MulCoreStage("trunc_pp", drop_cols=0))))
    lut = fs.pipeline_lut(fs.PipelineSpec(7, 7, 7, core=fs.MulCoreStage("trunc_pp", drop_cols=7),
                                          round=fs.RoundStage("truncate")))
    assert int(lut.max()) < (1 << 24)


def test_carry_overflow_is_rejected_not_silently_wrapped():
    with pytest.raises(ValueError, match="carry"):
        fs.pipeline_lut(fs.PipelineSpec(7, 7, 7, core=fs.MulCoreStage("afm"),
                                        round=fs.RoundStage("rne")))


@pytest.mark.parametrize("bad", [
    lambda: fs.DenormStage("flush"),
    lambda: fs.MulCoreStage("booth"),
    lambda: fs.MulCoreStage("exact", drop_cols=2),
    lambda: fs.RoundStage("nearest"),
    lambda: fs.RoundStage("rne", seed=3),
    lambda: fs.PipelineSpec(0, 7),
    lambda: fs.PipelineSpec(7, 24),
    lambda: fs.PipelineSpec(7, 9, core=fs.MulCoreStage("trunc_pp", drop_cols=8)),
    lambda: fs.pipeline_lut(fs.PipelineSpec(23, 23)),
])
def test_spec_validation(bad):
    with pytest.raises(ValueError):
        bad()


def test_gradual_denorm_diverges_from_the_lut_only_on_denormals(rng):
    ftz = fs.PipelineSpec(7, 7, 7)
    grad = dataclasses.replace(ftz, denorm=fs.DenormStage("gradual"))
    a = (rng.standard_normal(4096) * 2 + 4).astype(np.float32)
    b = (rng.standard_normal(4096) * 2 + 4).astype(np.float32)
    np.testing.assert_array_equal(fs.pipeline_multiply(ftz, a, b),
                                  fs.pipeline_multiply(grad, a, b))
    tiny = np.float32(2**-126)
    assert fs.pipeline_multiply(ftz, tiny, np.float32(0.5)) == 0.0
    assert float(fs.pipeline_multiply(grad, tiny, np.float32(0.5))) == 2.0**-127


# ------------------------------------------ torch twin: the direct mode
def _battery(rng):
    special = np.array([0.0, -0.0, 1.0, -1.0, 1e-38, -1e-38, 3e-39, 1e-44, 2**-126, 2**-63,
                        1e38, -1e38, 65504.0, np.inf, -np.inf, np.nan], np.float32)
    a = np.concatenate([special, (rng.standard_normal(600) * 4).astype(np.float32),
                        (rng.standard_normal(200) * 1e-19).astype(np.float32)])
    return a[:, None], np.concatenate([special[::-1], a[16:60]])[None, :]


@pytest.mark.parametrize("key", sorted(SPECS))
def test_torch_pipeline_multiply_bitwise_numpy(key, rng):
    spec = SPECS[key](fs)
    a, b = _battery(rng)
    ref = fs.pipeline_multiply(spec, a, b)
    np.testing.assert_array_equal(np_bits(ref), np_bits(jfs.pipeline_multiply(SPECS[key](jfs),
                                                                             a, b)))
    got = fs.torch_pipeline_multiply(spec, _t(a), _t(b)).numpy()
    np.testing.assert_array_equal(np_bits(got), np_bits(ref))


@pytest.mark.parametrize("name", CROSS + ["fp16xbf16_trunc"])
def test_direct_mode_under_a_pipeline_multiplier(name, rng):
    """``direct`` runs ``torch_mul`` in the sequential-k GEMM: each product
    bitwise ``np_mul``, and the GEMM bitwise a numpy sequential fold."""
    m = get_multiplier(name)
    a = (rng.standard_normal((5, 9)) * 3).astype(np.float32)
    b = (rng.standard_normal((9, 4)) * 3).astype(np.float32)
    np.testing.assert_array_equal(np_bits(m.torch_mul(_t(a), _t(a[::-1].copy())).numpy()),
                                  np_bits(m.np_mul(a, a[::-1])))
    ref = np.zeros((5, 4), np.float32)
    for k in range(9):
        ref = (ref + m.np_mul(a[:, k:k + 1], b[k:k + 1, :])).astype(np.float32)
    got = ops.policy_matmul(_t(a), _t(b), NumericsPolicy(mode="direct", multiplier=name))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref_direct_gemm(_t(a), _t(b), m).numpy(), ref)


# ------------------------------------------ the ops under asymmetric tables
def _tables(name):
    packed = lutgen.get_packed_lut(name)
    return jnp.asarray(jlutgen.get_packed_lut(name)), packed, get_multiplier(name).mantissa_bits


def _jgemm(a, b, jlut, M):
    return np.asarray(japprox_gemm.approx_gemm(jnp.asarray(a), jnp.asarray(b), jlut, M, bm=128,
                                               bn=128, bk=128, chunk=1, interpret=True))


@pytest.mark.parametrize("name", CROSS)
def test_matmul_forward_and_gradients_keep_jax_operand_roles(name, rng):
    """fwd a @ b, da = g @ b^T (g in the A slot), db = a_flat^T @ g_flat (a^T
    in the A slot), as JAX ``_mm_bwd``: bitwise the JAX kernel at chunk=1."""
    jlut, packed, M = _tables(name)
    assert np.array_equal(packed, jlutgen.get_packed_lut(name))
    a = (rng.standard_normal((2, 3, 20)) * 2).astype(np.float32)
    b = (rng.standard_normal((20, 7)) * 2).astype(np.float32)
    g = (rng.standard_normal((2, 3, 7)) * 2).astype(np.float32)
    at, bt = _t(a, True), _t(b, True)
    y = ops.policy_matmul(at, bt, NumericsPolicy(mode="amsim", multiplier=name), "dense")
    da, db = torch.autograd.grad(y, (at, bt), _t(g))
    np.testing.assert_array_equal(y.detach().numpy().reshape(6, 7), _jgemm(a.reshape(6, 20), b,
                                                                           jlut, M))
    np.testing.assert_array_equal(da.numpy().reshape(6, 20), _jgemm(g.reshape(6, 7), b.T, jlut, M))
    np.testing.assert_array_equal(db.numpy(), _jgemm(a.reshape(6, 20).T, g.reshape(6, 7), jlut, M))
    # the swapped roles give other bits: the test can see an operand swap
    assert not np.array_equal(db.numpy(), _jgemm(g.reshape(6, 7).T, a.reshape(6, 20), jlut, M).T)


@pytest.mark.parametrize("site", ["ssm", "wg"])
@pytest.mark.parametrize("name", CROSS)
def test_batched_matmul_forward_and_gradients_keep_jax_operand_roles(name, site, rng):
    jlut, _, M = _tables(name)
    a = (rng.standard_normal((3, 5, 12)) * 2).astype(np.float32)
    b = (rng.standard_normal((3, 12, 6)) * 2).astype(np.float32)
    g = (rng.standard_normal((3, 5, 6)) * 2).astype(np.float32)
    at, bt = _t(a, True), _t(b, True)
    y = ops.policy_matmul(at, bt, NumericsPolicy(mode="amsim", multiplier=name), site)
    da, db = torch.autograd.grad(y, (at, bt), _t(g))
    batched = lambda x, y: np.asarray(japprox_gemm.approx_gemm_batched(  # noqa: E731
        jnp.asarray(x), jnp.asarray(y), jlut, M, bm=128, bn=128, bk=128, chunk=1,
        interpret=True))
    sw = lambda x: np.ascontiguousarray(np.swapaxes(x, -1, -2))  # noqa: E731
    np.testing.assert_array_equal(y.detach().numpy(), batched(a, b))
    np.testing.assert_array_equal(da.numpy(), batched(g, sw(b)))
    np.testing.assert_array_equal(db.numpy(), batched(sw(a), g))


CONV_CASES = [((2, 6, 6, 3), (3, 3, 3, 4), 1, "SAME"), ((2, 8, 8, 3), (3, 3, 3, 4), 2, "SAME")]


@pytest.mark.parametrize("xs,ws,stride,padding", CONV_CASES)
@pytest.mark.parametrize("name", CROSS)
def test_conv_forward_and_gradients_keep_jax_operand_roles(name, xs, ws, stride, padding, rng):
    """x in the A slot forward and at dw (``cols(x)^T @ g``), the error in
    the A slot at dx (a conv of the dilated error with the flipped
    weights): bitwise the JAX kernels at chunk=1."""
    jlut, _, M = _tables(name)
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    xt, wt = _t(x, True), _t(w, True)
    y = ops.approx_conv2d(xt, wt, stride, padding, NumericsPolicy(mode="amsim", multiplier=name))
    g = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    dx, dw = torch.autograd.grad(y, (xt, wt), _t(g))
    ref_y = japprox_conv.approx_conv2d_fused(jnp.asarray(x), jnp.asarray(w), jlut, M,
                                             stride=stride, padding=padding, br=1, bo=4, chunk=1,
                                             interpret=True)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(ref_y))
    pads = approx_conv.conv_pads(xs[1], xs[2], ws[0], ws[1], stride, padding)
    gd, w_rt, dpads = ops.conv_dx_operands(_t(g), _t(w), xs[1:3], stride, pads)
    ref_dx = japprox_conv.approx_conv2d_fused(jnp.asarray(gd.numpy()), jnp.asarray(w_rt.numpy()),
                                              jlut, M, stride=1, padding=dpads, br=1, bo=4,
                                              chunk=1, interpret=True)
    ref_dw = japprox_conv.approx_conv2d_dw(jnp.asarray(x), jnp.asarray(g), jlut, M, kh=ws[0],
                                           kw=ws[1], stride=stride, padding=padding, chunk=1,
                                           interpret=True)
    np.testing.assert_array_equal(dx.numpy(), np.asarray(ref_dx))
    np.testing.assert_array_equal(dw.numpy(), np.asarray(ref_dw))


@pytest.mark.parametrize("name", CROSS)
def test_attention_keeps_jax_operand_roles(name, rng):
    """q in the A slot of the scores, p of the values: the fused path (the
    kernel's plain version here) and its recompute gradient within rtol
    1e-5 / 1e-4, atol 1e-5 of JAX's ``attend_einsum`` under ``amsim_jnp``
    (their softmax sums differ by ulps); the swapped roles miss by far more."""
    B, S, H, KV, dh = 2, 8, 4, 2, 16
    q, k, v, g = ((rng.standard_normal(s) * 2).astype(np.float32) for s in
                  ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh), (B, S, H, dh)))
    pos = np.arange(S, dtype=np.int32)
    ts = [_t(a, True) for a in (q, k, v)]
    out = ops.policy_attention(*ts, _t(pos), _t(pos), NumericsPolicy(mode="amsim",
                                                                     multiplier=name), True, 0)
    got = torch.autograd.grad(out, ts, _t(g))
    jpol = JaxPolicy(mode="amsim_jnp", multiplier=name)
    jq, jk, jv, jp = (jnp.asarray(a) for a in (q, k, v, pos))
    @jax.jit
    def jax_ref(q_, k_, v_, g_):
        ref, vjp = jax.vjp(lambda *t: jops.attend_einsum(*t, jp, jp, jpol, causal=True,
                                                         window=0), q_, k_, v_)
        return ref, vjp(g_)

    ref, ref_grads = jax_ref(jq, jk, jv, jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for a, b in zip(got, ref_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    mirror = "bf16xfp16" if name == "fp16xbf16" else "fp16xbf16"
    swapped = ops.attend_einsum(*(t.detach() for t in ts), _t(pos), _t(pos),
                                NumericsPolicy(mode="amsim_torch", multiplier=mirror),
                                causal=True, window=0)
    assert np.abs(swapped.numpy() - np.asarray(ref)).max() > 1e-3


def _chain_operands(rng, d=24, hq=16, hkv=8, F=40, rows=2):
    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=r(rows, d), g1=1 + r(d, scale=0.1), g2=1 + r(d, scale=0.1),
                wq=r(d, hq, scale=d ** -0.5), wk=r(d, hkv, scale=d ** -0.5),
                wv=r(d, hkv, scale=d ** -0.5), attn=r(rows, hq), wo=r(hq, d, scale=hq ** -0.5),
                wg=r(d, F, scale=d ** -0.5), wu=r(d, F, scale=d ** -0.5),
                wd=r(F, d, scale=F ** -0.5), bo=r(d, scale=0.1), bd=r(d, scale=0.1),
                q=r(rows, 1, 4, 4), k=r(rows, 6, 2, 4), v=r(rows, 6, 2, 4),
                q_pos=np.asarray([5], np.int32), k_pos=np.arange(6, dtype=np.int32),
                buf=r(3, 4, d), ewg=r(3, d, F, scale=d ** -0.5), ewu=r(3, d, F, scale=d ** -0.5),
                ewd=r(3, F, d, scale=F ** -0.5))


EPS = 1e-5
# entry: (operand names, the port's entry, JAX's per-op oracle)
DECODE_ENTRIES = {
    "qkv": (("x", "g1", "wq", "wk", "wv"),
            lambda p, *t: ops.decode_qkv(*t, p, EPS),
            lambda p, *t: jops.decode_qkv_oracle(*t, p, EPS)),
    "out_mlp": (("x", "attn", "g2", "wo", "wg", "wu", "wd", "bo", "bd"),
                lambda p, *t: ops.decode_out_mlp_b(*t, p, EPS),
                lambda p, *t: jops.decode_out_mlp_oracle(*t[:7], p, EPS, bo=t[7], bd=t[8])),
    "attn_out_mlp": (("x", "q", "k", "v", "q_pos", "k_pos", "g2", "wo", "wg", "wu", "wd", "bo",
                      "bd"),
                     lambda p, *t: ops.decode_attn_out_mlp(*t, p, EPS, True, 0),
                     lambda p, *t: jops.decode_out_mlp_oracle(
                         t[0], jops.attend_einsum(*t[1:6], p, causal=True, window=0).reshape(
                             t[0].shape[0], -1), *t[6:11], p, EPS, bo=t[11], bd=t[12])),
    "wo_norm": (("x", "attn", "g2", "wo", "bo"),
                lambda p, *t: ops.decode_wo_norm(*t, p, EPS),
                lambda p, *t: jops.decode_wo_norm_oracle(*t, p, EPS)),
    "moe_ffn": (("buf", "ewg", "ewu", "ewd"),
                lambda p, *t: ops.decode_moe_ffn(*t, p),
                lambda p, *t: jops.decode_moe_ffn_oracle(*t, p)),
}


@pytest.mark.parametrize("entry", sorted(DECODE_ENTRIES))
@pytest.mark.parametrize("name", CROSS)
def test_decode_entries_keep_jax_operand_roles(name, entry, rng):
    """The five decode entries (the chain kernels' plain versions here)
    forward and gradient within rtol 1e-5 / 1e-4, atol 1e-5 of JAX's per-op
    oracles under ``amsim_jnp`` (the rmsnorm, silu and softmax
    transcendentals differ by ulps between torch and XLA)."""
    names, port, jax_oracle = DECODE_ENTRIES[entry]
    o = _chain_operands(rng)
    arrays = [o[n] for n in names]
    floats = [i for i, a in enumerate(arrays) if a.dtype == np.float32]
    ts = [_t(a, i in floats) for i, a in enumerate(arrays)]
    out = port(NumericsPolicy(mode="amsim", multiplier=name), *ts)
    outs = out if isinstance(out, tuple) else (out,)
    cot = [(rng.standard_normal(y.shape)).astype(np.float32) for y in outs]
    got = torch.autograd.grad(outs, [ts[i] for i in floats], [_t(c) for c in cot])
    jpol = JaxPolicy(mode="amsim_jnp", multiplier=name)

    def jfn(*diff):
        full = [jnp.asarray(a) for a in arrays]
        for i, t in zip(floats, diff):
            full[i] = t
        r = jax_oracle(jpol, *full)
        return r if isinstance(r, tuple) else (r,)

    @jax.jit
    def jax_ref(diff, cots):
        ref, vjp = jax.vjp(jfn, *diff)
        return ref, vjp(cots)

    ref, ref_grads = jax_ref([jnp.asarray(arrays[i]) for i in floats],
                             tuple(jnp.asarray(c) for c in cot))
    for a, b in zip(outs, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    for a, b in zip(got, ref_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ surrogate
@pytest.mark.parametrize("m", [3, 7, 10])
def test_quantize_format_bitwise_numpy(m, rng):
    x = np.concatenate([(rng.standard_normal(4096) * 10).astype(np.float32),
                        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3e-39,
                                  np.float32(3.4028235e38)], np.float32)])
    for rounding, np_fn, torch_fn in (("truncate", np_truncate_mantissa, torch_truncate_mantissa),
                                      ("nearest", np_round_mantissa, torch_round_mantissa)):
        ref = np_bits(np_fn(x, m))
        np.testing.assert_array_equal(np_bits(quantize_format(x, m, rounding)), ref)
        np.testing.assert_array_equal(np_bits(quantize_format(_t(x), m, rounding).numpy()), ref)
        np.testing.assert_array_equal(np_bits(torch_fn(_t(x), m).numpy()), ref)
    with pytest.raises(ValueError, match="rounding"):
        quantize_format(x, m, "up")


def test_stochastic_round_format_properties(rng):
    """JAX ``stochastic_round_format``'s rule with a torch generator (the
    draws cannot match threefry): x + sign(x) * U(0, |trunc(x)| 2^-m),
    truncated.  So each result keeps x's sign, is representable in m bits,
    lies at most two units in the last place away from zero from trunc(x),
    is less biased than truncation, and repeats with the seed."""
    x = _t((rng.standard_normal(20000) * 3).astype(np.float32))
    out = stochastic_round_format(x, 7, torch.Generator().manual_seed(0))
    lo = torch_truncate_mantissa(x, 7)
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)   # 2^(exponent - 7)
    steps = (out.abs() - lo.abs()) / ulp
    assert torch.equal(torch_truncate_mantissa(out, 7), out)
    assert bool((torch.sign(out) == torch.sign(x)).all())
    assert bool(((steps >= 0) & (steps <= 2)).all()) and bool((steps > 0).any())
    bias = lambda y: abs(float(((y.abs() - x.abs()) / ulp).mean()))   # noqa: E731
    assert bias(out) < bias(lo)
    assert torch.equal(out, stochastic_round_format(x, 7, torch.Generator().manual_seed(0)))
    assert torch.equal(stochastic_round_format(x, 23), x)


@pytest.mark.parametrize("name", ["fp16xbf16", "bf16xfp16", "bf16", "trunc7", "exact10"])
def test_surrogate_matches_jax(name, rng):
    """Operands cut per ``operand_bits`` (bf16 of the zoo rounds, the rest
    truncate), then the exact product: the cut operands bitwise, the
    product, and both gradients within rtol 1e-6, atol 1e-6 of JAX's
    surrogate (exact f32 matmuls in other orders)."""
    m = get_multiplier(name)
    ma, mb = m.operand_bits
    a = (rng.standard_normal((6, 33)) * 3).astype(np.float32)
    b = (rng.standard_normal((33, 5)) * 3).astype(np.float32)
    cut = np_round_mantissa if name == "bf16" else np_truncate_mantissa
    at, bt = _t(a, True), _t(b, True)
    pol = NumericsPolicy(mode="surrogate", multiplier=name)
    y = ops.policy_matmul(at, bt, pol, "wg")
    exact = cut(a, ma).astype(np.float64) @ cut(b, mb).astype(np.float64)
    np.testing.assert_allclose(y.detach().numpy(), exact, rtol=1e-6, atol=1e-6)
    jpol = JaxPolicy(mode="surrogate", multiplier=name)
    ref, vjp = jax.vjp(lambda x, w: jops.policy_matmul(x, w, jpol, "wg"), jnp.asarray(a),
                       jnp.asarray(b))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    g = rng.standard_normal((6, 5)).astype(np.float32)
    for u, v in zip(torch.autograd.grad(y, (at, bt), _t(g)), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-6, atol=1e-5)


def test_surrogate_cuts_each_operand_to_its_own_width(monkeypatch, rng):
    """fp16xbf16: A truncated to 10 bits and B to 7, bitwise, before the
    exact matmul (captured at ``torch.matmul``)."""
    seen = []
    real = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda x, y: seen.append((x, y)) or real(x, y))
    a = (rng.standard_normal((4, 9)) * 3).astype(np.float32)
    b = (rng.standard_normal((9, 3)) * 3).astype(np.float32)
    ops.policy_matmul(_t(a), _t(b), NumericsPolicy(mode="surrogate", multiplier="fp16xbf16"))
    (x, y), = seen
    np.testing.assert_array_equal(np_bits(x.numpy()), np_bits(np_truncate_mantissa(a, 10)))
    np.testing.assert_array_equal(np_bits(y.numpy()), np_bits(np_truncate_mantissa(b, 7)))


@pytest.mark.parametrize("stride", [1, 2])
def test_surrogate_conv_matches_jax(stride, rng):
    """The conv reaches the surrogate through im2col, as in JAX: forward,
    dx and dw within rtol 1e-5, atol 1e-5."""
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    xt, wt = _t(x, True), _t(w, True)
    pol = NumericsPolicy(mode="surrogate", multiplier="bf16")
    y = ops.approx_conv2d(xt, wt, stride, "SAME", pol)
    g = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, b: jops.approx_conv2d(a, b, stride, "SAME",
                                                        JaxPolicy("surrogate", "bf16")),
                       jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    for u, v in zip(torch.autograd.grad(y, (xt, wt), _t(g)), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-5, atol=1e-5)


def test_np_amsim_and_staged_agree_on_specials(rng):
    """The staged FTZ oracle == the LUT executor on zeros, denormals and
    exponent extremes (the contract every kernel inherits)."""
    spec = get_multiplier("fp16xbf16").pipeline
    lut = lutgen.get_lut("fp16xbf16")
    a, b = _battery(rng)
    keep = ~(np.isnan(a) | np.isinf(a))[:, 0]
    a = a[keep]
    b = b[:, ~(np.isnan(b) | np.isinf(b))[0]]
    staged = fs.pipeline_multiply(spec, a, b)
    np.testing.assert_array_equal(np_bits(staged),
                                  np_bits(np_amsim_multiply(*np.broadcast_arrays(a, b), lut, 10)))
