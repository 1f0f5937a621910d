"""The port's core numerics against the JAX package: LUTs, AMSim, models.

* ``repro_torch.core.lutgen`` tables are byte-identical to
  ``repro.core.lutgen``'s, canonical and packed, and match the golden
  CRC32s of the hand-written multipliers;
* the torch AMSim product is bitwise equal to
  ``repro.core.amsim.np_amsim_multiply`` on random normals and on a
  boundary grid (exponent sums around 127 and 254, signed zeros,
  denormals, operands near the largest finite value);
* the numpy multiplier models, the registry and the flat policy behave
  as the JAX package's.
"""
import json
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import amsim as jamsim  # noqa: E402
from repro.core import lutgen as jlutgen  # noqa: E402
from repro.core import multipliers as jmult  # noqa: E402
from repro_torch.core import lutgen, multipliers  # noqa: E402
from repro_torch.core.amsim import amsim_multiply, np_amsim_multiply  # noqa: E402
from repro_torch.core.float_bits import np_bits, torch_bits, torch_float  # noqa: E402
from repro_torch.core.policy import MODES, NumericsPolicy, PolicyTable, site_family  # noqa: E402
from repro_torch.kernels.common import lut_tensor  # noqa: E402

LUT_NAMES = ["afm16", "mit16", "bf16", "exact7", "realm16", "trunc16", "mitchell8"]
GOLDEN = json.loads((Path(__file__).parent / "golden" / "lut_digests.json").read_text())


@pytest.fixture(scope="module", autouse=True)
def _own_lut_dir(tmp_path_factory):
    """The JAX package caches LUTs on disk through one fixed temporary name
    per table; give this module its own directory, so that it never writes
    the shared one while another test process reads it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DIR", str(tmp_path_factory.mktemp("luts")))
        yield


def _cross_format(name):
    return multipliers.get_multiplier(name).pipeline is not None


# The hand-written entries; tests/test_torch_fpstages.py checks the cross-format ones.
HAND_WRITTEN = {k: v for k, v in GOLDEN.items() if not _cross_format(k.split("@")[0])}


# ------------------------------------------------------------------- LUTs
@pytest.mark.parametrize("name", LUT_NAMES)
def test_lut_byte_identical_to_jax(name):
    ours, ref = lutgen.get_lut(name), jlutgen.get_lut(name)
    assert ours.dtype == ref.dtype == np.uint32
    assert ours.tobytes() == ref.tobytes()
    packed, ref_packed = lutgen.get_packed_lut(name), jlutgen.get_packed_lut(name)
    assert packed.dtype == ref_packed.dtype == np.uint16
    assert packed.tobytes() == ref_packed.tobytes()
    M = multipliers.get_multiplier(name).mantissa_bits
    assert lutgen.unpack_lut(packed, M).tobytes() == ours.tobytes()


def test_six_hand_written_golden_digests():
    assert len(HAND_WRITTEN) == 6
    for key, digest in HAND_WRITTEN.items():
        name, m = key.split("@M")
        lut = lutgen.generate_lut(multipliers.get_multiplier(name), int(m))
        assert f"{zlib.crc32(lut.tobytes()) & 0xFFFFFFFF:08x}" == digest, key


def test_pack_lut_rejects_full_precision_table():
    lut = lutgen.get_lut("afm16").copy()
    lut[3] |= 1  # a mantissa bit below the top M
    with pytest.raises(ValueError, match="not packable"):
        lutgen.pack_lut(lut, 7)


# ------------------------------------------------------------------ AMSim
def _boundary_grid():
    """Operands whose exponent sums straddle underflow (127) and overflow
    (254), signed zeros, denormals, and the largest finite values."""
    vals = [0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, 1.17549435e-38,
            -1.17549435e-38, 3.4028235e38, -3.4028235e38, 1.9999999, 1.0, -1.5]
    for e in (-63, -64, -65, 63, 64, 65, 126, 127):
        for mnt in (1.0, 1.25, 1.75, 1.9921875):
            vals += [np.float32(mnt * 2.0 ** e), np.float32(-mnt * 2.0 ** e)]
    v = np.asarray(vals, np.float32)
    return np.meshgrid(v, v, indexing="ij")


@pytest.mark.parametrize("name", ["afm16", "mitchell8", "bf16", "afm10"])
@pytest.mark.parametrize("packed", [False, True])
def test_amsim_bitwise_vs_np_amsim_multiply(name, packed, rng):
    M = multipliers.get_multiplier(name).mantissa_bits
    lut = lutgen.get_packed_lut(name) if packed else lutgen.get_lut(name)
    ga, gb = _boundary_grid()
    a = np.concatenate([ga.ravel(), rng.standard_normal(4096).astype(np.float32)])
    b = np.concatenate([gb.ravel(), rng.standard_normal(4096).astype(np.float32)])
    ref = jamsim.np_amsim_multiply(a, b, lut, M, packed=packed)
    ours = amsim_multiply(torch.from_numpy(a), torch.from_numpy(b),
                          lut_tensor(lut, "cpu"), M).numpy()
    np.testing.assert_array_equal(np_bits(ours), np_bits(ref))
    np.testing.assert_array_equal(
        np_bits(np_amsim_multiply(a, b, lut, M, packed=packed)), np_bits(ref))


def test_torch_bit_helpers_round_trip(rng):
    x = np.concatenate([rng.standard_normal(64), [0.0, -0.0, np.inf, -np.inf, 1e-45]])
    x = torch.from_numpy(x.astype(np.float32))
    u = torch_bits(x)
    assert u.dtype == torch.int64 and int(u.min()) >= 0 and int(u.max()) < 2**32
    np.testing.assert_array_equal(u.numpy(), np_bits(x.numpy()).astype(np.int64))
    np.testing.assert_array_equal(np_bits(torch_float(u).numpy()), np_bits(x.numpy()))


# ------------------------------------------------------------- multipliers
@pytest.mark.parametrize("name", ["fp32", "bf16", "afm16", "mit16", "realm16",
                                  "trunc16", "exact7", "mitchell8", "realm12"])
def test_numpy_models_bitwise_vs_jax(name, rng):
    a = rng.standard_normal(2048).astype(np.float32) * 4
    b = rng.standard_normal(2048).astype(np.float32) * 4
    ours = multipliers.get_multiplier(name)
    ref = jmult.get_multiplier(name)
    assert ours.name == ref.name and ours.mantissa_bits == ref.mantissa_bits
    assert ours.exact_family == ref.exact_family
    np.testing.assert_array_equal(np_bits(ours(a, b)), np_bits(ref.np_mul(a, b)))


def test_registry_names_and_errors():
    assert set(multipliers.REGISTRY) == set(jmult.REGISTRY)
    assert multipliers.get_multiplier("afm9").name == "afm9"
    cross = multipliers.get_multiplier("fp16xbf16")
    assert cross.pipeline is not None and cross.name == jmult.get_multiplier("fp16xbf16").name
    assert multipliers.get_multiplier("fp16xbf16_rne") is cross
    with pytest.raises(ValueError, match="Did you mean 'afm16'"):
        multipliers.get_multiplier("afm16x")


# ------------------------------------------------------------------ policy
def test_flat_policy_resolve():
    assert MODES == ("native", "surrogate", "amsim", "amsim_torch", "direct")
    pol = NumericsPolicy(mode="amsim", multiplier="afm16", approx_backward=False)
    assert pol.resolve("conv") is pol
    assert pol.resolve("conv", pass_="dw").mode == "native"
    assert NumericsPolicy(mode="amsim", multiplier="afm16",
                          approx_attention=False).resolve("attn_score").mode == "native"
    assert site_family("conv") == "conv" and site_family("dense") == "gemm"
    assert NumericsPolicy(mode="amsim", multiplier="fp32").is_native
    with pytest.raises(ValueError, match="unknown site"):
        pol.resolve("nope")


@pytest.mark.parametrize("mode", ["surrogate", "direct", "amsim_jnp"])
def test_later_modes_raise(mode):
    """The modes of the JAX package: surrogate (this slice) and direct (the
    training slice) are ported; amsim_jnp is JAX's own and raises, naming
    its twin here; an empty table raises."""
    with pytest.raises(ValueError, match="at least one rule"):
        PolicyTable(())
    if mode == "direct":
        assert NumericsPolicy(mode=mode, multiplier="afm32").resolve("conv").mode == "direct"
        return
    if mode == "surrogate":
        assert NumericsPolicy(mode=mode, multiplier="bf16").resolve("conv").mode == "surrogate"
        with pytest.raises(ValueError, match="truncation family"):
            NumericsPolicy(mode=mode, multiplier="afm16")
        return
    with pytest.raises(ValueError, match="amsim_torch"):
        NumericsPolicy(mode=mode, multiplier="bf16")
