"""The port's LUT kernels against the JAX package's Pallas kernels.

On the CPU the kernel wrappers run their plain PyTorch versions, which
fold k one product at a time in the CUDA kernels' order:
* the plain ``approx_gemm`` is bitwise equal to JAX ``approx_gemm`` at
  chunk=1 (interpret mode), and within a reassociation bound of it at the
  default tiling;
* the plain ``approx_conv2d_fused`` is bitwise equal to JAX
  ``approx_conv2d_fused`` at br=1, bo=4, chunk=1;
* ``conv_pads`` reproduces ``lax.padtype_to_pads``.
The CUDA kernels themselves are held against the plain versions on the
card in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import approx_conv as japprox_conv  # noqa: E402
from repro.kernels import approx_gemm as japprox_gemm  # noqa: E402
from repro_torch.core import lutgen  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.kernels import approx_conv, approx_gemm, ops  # noqa: E402
from repro_torch.kernels.common import lut_tensor  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _own_lut_dir(tmp_path_factory):
    """The JAX package caches LUTs on disk through one fixed temporary name
    per table; give this module its own directory, so that it never writes
    the shared one while another test process reads it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DIR", str(tmp_path_factory.mktemp("luts")))
        yield


def _lut(name, packed):
    table = lutgen.get_packed_lut(name) if packed else lutgen.get_lut(name)
    return table, lutgen.get_multiplier(name).mantissa_bits


# ------------------------------------------------------------------- GEMM
GEMM_CASES = ([(shape, "afm16", packed) for shape in [(33, 70, 17), (1, 129, 5), (4, 784, 120)]
               for packed in (True, False)]
              + [((33, 70, 17), "afm10", packed) for packed in (True, False)])


@pytest.mark.parametrize("shape,name,packed", GEMM_CASES)
def test_plain_gemm_bitwise_vs_jax_chunk1(shape, name, packed, rng):
    m, k, n = shape
    table, M = _lut(name, packed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ref = japprox_gemm.approx_gemm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(table), M,
                                   bm=128, bn=128, bk=128, chunk=1, interpret=True)
    out = approx_gemm.approx_gemm(torch.from_numpy(a), torch.from_numpy(b),
                                  lut_tensor(table, "cpu"), M)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["zero", "negative_zero", "subnormal"])
@pytest.mark.parametrize("batched", [False, True])
def test_dead_rows_give_positive_zero_in_plain_and_jax_gemm(kind, batched, rng):
    """A row of A whose exponent fields are all 0 makes every AMSim product
    +-0 whatever B holds (inf and NaN too), and its sum from +0.0 is +0.0:
    in the plain GEMM and in the JAX kernels at chunk=1, bit for bit.  The
    CUDA kernel writes +0.0 over such row tiles without reading B."""
    table, M = _lut("afm16", True)
    B, m, k, n = 2, 6, 40, 9
    a = rng.standard_normal((B, m, k)).astype(np.float32)
    b = rng.standard_normal((B, k, n)).astype(np.float32)
    dead = {"zero": np.zeros(k, np.float32), "negative_zero": -np.zeros(k, np.float32),
            "subnormal": (rng.standard_normal(k) * 1e-39).astype(np.float32)}[kind]
    a[:, 1], a[:, 4:] = dead, dead
    b[:, ::3, :3], b[:, 1::3, :3], b[:, 2::3, :3] = np.inf, np.nan, -np.inf
    lut = lut_tensor(table, "cpu")
    if batched:
        out = approx_gemm.approx_gemm_batched(torch.from_numpy(a), torch.from_numpy(b), lut,
                                              M).numpy()
        ref = np.asarray(japprox_gemm.approx_gemm_batched(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(table), M, bm=128, bn=128, bk=128,
            chunk=1, interpret=True))
    else:
        out = approx_gemm.approx_gemm(torch.from_numpy(a[0]), torch.from_numpy(b[0]), lut,
                                      M).numpy()[None]
        ref = np.asarray(japprox_gemm.approx_gemm(
            jnp.asarray(a[0]), jnp.asarray(b[0]), jnp.asarray(table), M, bm=128, bn=128,
            bk=128, chunk=1, interpret=True))[None]
    rows = [1, 4, 5]
    assert not out[:, rows].view(np.int32).any()
    assert not ref[:, rows].view(np.int32).any()
    np.testing.assert_array_equal(out, ref)
    assert np.isfinite(out[:, [0, 2, 3], 3:]).all()


def test_plain_gemm_close_to_jax_default_tiling(rng):
    """At its default tiling JAX sums each chunk of products before adding
    it, so the order of the float32 sum differs.  Two orders of summing the
    same k terms differ by at most 2 * k * eps32 * sum_k |p_k| (first-order
    bound of recursive summation); |p| is amsim(|a|, |b|), because AMSim's
    magnitude does not depend on the signs."""
    table, M = _lut("afm16", True)
    a = rng.standard_normal((16, 784)).astype(np.float32)
    b = rng.standard_normal((784, 120)).astype(np.float32)
    lut = lut_tensor(table, "cpu")
    ref = np.asarray(japprox_gemm.approx_gemm(jnp.asarray(a), jnp.asarray(b),
                                              jnp.asarray(table), M, interpret=True))
    out = approx_gemm.approx_gemm(torch.from_numpy(a), torch.from_numpy(b), lut, M).numpy()
    mag = approx_gemm.approx_gemm(torch.from_numpy(np.abs(a)), torch.from_numpy(np.abs(b)),
                                  lut, M).numpy()
    bound = 2 * a.shape[1] * np.finfo(np.float32).eps * mag
    assert np.all(np.abs(out - ref) <= bound)


def test_gemm_wrapper_rejects_what_the_kernel_does_not_take():
    table, M = _lut("afm16", True)
    lut = lut_tensor(table, "cpu")
    a = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="takes"):
        approx_gemm.approx_gemm(a, torch.zeros((7, 3)), lut, M)
    with pytest.raises(TypeError, match="float32"):
        approx_gemm.approx_gemm(a.double(), torch.zeros((8, 3)).double(), lut, M)
    with pytest.raises(ValueError, match="entries"):
        approx_gemm.approx_gemm(a, torch.zeros((8, 3)), lut, 8)
    # Only a tensor on the CPU takes the plain version; any other device
    # must launch a kernel or raise.
    with pytest.raises(ValueError, match="no kernel for device meta"):
        approx_gemm.approx_gemm(a.to("meta"), torch.zeros((8, 3), device="meta"),
                                lut.to("meta"), M)


# ------------------------------------------------------------------- conv
CONV_CASES = [
    # (x shape, w shape, stride, padding)
    ((2, 6, 6, 3), (3, 3, 3, 4), 1, "SAME"),
    ((2, 8, 8, 3), (3, 3, 3, 4), 2, "SAME"),   # even input: pads (0, 1)
    ((2, 8, 8, 3), (1, 1, 3, 4), 2, "SAME"),
    ((2, 8, 8, 1), (5, 5, 1, 4), 1, "SAME"),
]


@pytest.mark.parametrize("xs,ws,stride,padding", CONV_CASES)
def test_plain_conv_bitwise_vs_jax_chunk1(xs, ws, stride, padding, rng):
    table, M = _lut("afm16", True)
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    ref = japprox_conv.approx_conv2d_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(table), M, stride=stride,
        padding=padding, br=1, bo=4, chunk=1, interpret=True)
    out = approx_conv.approx_conv2d_fused(torch.from_numpy(x), torch.from_numpy(w),
                                          lut_tensor(table, "cpu"), M,
                                          stride=stride, padding=padding)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_stride2_same_on_even_input_is_asymmetric():
    assert approx_conv.conv_pads(32, 32, 3, 3, 2, "SAME") == (0, 1, 0, 1)


@pytest.mark.parametrize("hw", [(7, 7), (8, 8), (9, 6), (1, 5)])
@pytest.mark.parametrize("khw", [(1, 1), (2, 2), (3, 3), (2, 4), (4, 3), (5, 5)])
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_pads_match_lax(hw, khw, stride, padding):
    (pt, pb), (pl, pr) = jax.lax.padtype_to_pads(hw, khw, (stride, stride), padding)
    assert approx_conv.conv_pads(*hw, *khw, stride, padding) == (pt, pb, pl, pr)


def test_native_ops_match_jax_native(rng):
    """native against native: exact float32 both sides, sums in other
    orders (allclose at float32 resolution)."""
    from repro.core.policy import NumericsPolicy as JaxPolicy
    from repro.kernels import ops as jops
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    ref = jops.approx_conv2d(jnp.asarray(x), jnp.asarray(w), 2, "SAME", JaxPolicy())
    out = ops.approx_conv2d(torch.from_numpy(x), torch.from_numpy(w), 2, "SAME",
                            NumericsPolicy())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_amsim_torch_conv_equals_plain_kernel_version(rng):
    """The amsim_torch lowering (im2col + policy GEMM) and the fused
    wrapper's plain version fold in the same order."""
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 4)).astype(np.float32))
    table, M = _lut("afm16", True)
    out = ops.approx_conv2d(x, w, 2, "SAME", NumericsPolicy(mode="amsim_torch",
                                                             multiplier="afm16"))
    ref = approx_conv.approx_conv2d_fused(x, w, lut_tensor(table, "cpu"), M, stride=2)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_batched_matmul_waits_for_a_later_slice(rng):
    """Under amsim an equal-batch product runs ``approx_gemm_batched``; on
    CPU tensors its plain version, which gives the bits of amsim_torch."""
    a = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 4, 5)).astype(np.float32))
    out = ops.policy_matmul(a, b, NumericsPolicy(mode="amsim", multiplier="afm16"))
    ref = ops.policy_matmul(a, b, NumericsPolicy(mode="amsim_torch", multiplier="afm16"))
    assert torch.equal(out, ref)
