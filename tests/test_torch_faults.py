"""The port's LUT fault injection against the JAX package's.

``repro_torch.core.faults`` mirrors ``tests/test_faults.py``: the spec
grammar, seeded reproducibility, the rate and stuck-at and burst models,
the packed/canonical equivalence (``unpack(faulted(packed)) ==
faulted(unpack(packed))``), multiplier targeting, and the seam off = the
same object.  Faulted tables are byte-identical to JAX's for the same
spec, multiplier and M.  The seam in ``kernels/ops.py`` keys its cache of
tables on the spec: a fresh tensor when the spec changes, the very same
tensor with faults off, one upload a key; a faulted GEMM is bitwise the
JAX kernel at chunk=1 on JAX's faulted table.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro.core import lutgen as jlutgen  # noqa: E402
from repro.kernels import approx_gemm as japprox_gemm  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.core.faults import FaultCampaign, FaultSpec, apply_faults, parse_spec  # noqa
from repro_torch.core.lutgen import get_lut, get_packed_lut, unpack_lut  # noqa: E402
from repro_torch.core.multipliers import get_multiplier  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

MULT = get_multiplier("mitchell8")
M = MULT.mantissa_bits


@pytest.fixture(autouse=True)
def _no_leaked_spec(monkeypatch):
    """Every test starts and ends with the seam off and its own table cache
    (both are process-wide)."""
    monkeypatch.delenv("REPRO_FAULTS", raising=False)
    monkeypatch.setattr(ops, "_LUTS", {})
    monkeypatch.setattr(ops, "lut_uploads", {})
    faults.clear_active()
    yield
    faults.clear_active()


@pytest.fixture(scope="module", autouse=True)
def _own_lut_dir(tmp_path_factory):
    """The JAX package caches LUTs on disk through one fixed temporary name
    per table: give this module its own directory; pin the JAX kernel's
    tiling with an empty autotune cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_LUT_DIR", str(tmp_path_factory.mktemp("luts")))
        mp.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path_factory.mktemp("tune") / "none.json"))
        jautotune.reload_cache()
        yield
    jautotune.reload_cache()


# ------------------------------------------------------------ spec grammar
def test_parse_spec_grammar():
    s = parse_spec("bitflip:rate=1e-3,seed=7,mult=mitchell8")
    assert s == FaultSpec(kind="bitflip", rate=1e-3, seed=7, mult="mitchell8")
    b = parse_spec("burst:axis=col,width=2,bit=3,start=40")
    assert (b.kind, b.axis, b.width, b.bit, b.start) == ("burst", "col", 2, 3, 40)
    assert parse_spec(s.describe()) == s
    assert parse_spec(b.describe()) == b
    assert parse_spec(s) is s
    assert s.to_json() == jfaults.parse_spec(s.describe()).to_json()


@pytest.mark.parametrize("bad", ["", "gamma:rate=0.1", "bitflip:rate=2.0", "bitflip:frob=1",
                                 "bitflip:rate", "burst:axis=diag", "burst:width=0"])
def test_parse_spec_rejects(bad):
    with pytest.raises(ValueError):
        parse_spec(bad)


def test_campaign_from_rates():
    c = FaultCampaign.from_rates("bitflip", [0, 1e-3, 1e-1], seed=3)
    pts = list(c)
    assert len(c) == 3 and pts[0] == ("rate=0", None)
    assert pts[1][1] == FaultSpec(kind="bitflip", rate=1e-3, seed=3)
    assert pts[2][0] == "rate=0.1"


# ------------------------------------------------ applying to tables
SPECS = ["bitflip:rate=1e-3,seed=5", "stuck1:rate=1e-2,seed=0", "stuck0:rate=1e-2,seed=1",
         "burst:axis=row,width=2,bit=3,start=250", "burst:axis=col,seed=4"]


@pytest.mark.parametrize("name", ["mitchell8", "afm16", "fp16xbf16"])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("text", SPECS)
def test_faulted_tables_equal_jax(text, packed, name):
    """The same spec, multiplier and M fault a table the same way in both
    packages (the draws come from numpy, seeded by the spec)."""
    mult = get_multiplier(name)
    table = get_packed_lut(name) if packed else get_lut(name)
    jtable = jlutgen.get_packed_lut(name) if packed else jlutgen.get_lut(name)
    ours = apply_faults(table, mult.mantissa_bits, parse_spec(text), packed=packed, mult=name)
    ref = jfaults.apply_faults(jtable, mult.mantissa_bits, jfaults.parse_spec(text),
                               packed=packed, mult=name)
    assert ours is not table and ours.dtype == table.dtype
    assert ours.tobytes() == np.asarray(ref).tobytes()
    assert (ours != table).any()


def test_apply_is_seeded_and_pure():
    lut = get_lut(MULT)
    a = apply_faults(lut, M, FaultSpec(rate=1e-3, seed=5), packed=False, mult=MULT.name)
    b = apply_faults(lut, M, FaultSpec(rate=1e-3, seed=5), packed=False, mult=MULT.name)
    np.testing.assert_array_equal(a, b)
    assert a is not lut and (a != lut).any()
    c = apply_faults(lut, M, FaultSpec(rate=1e-3, seed=6), packed=False, mult=MULT.name)
    assert (a != c).any()


def test_bitflip_rate_scales():
    lut = get_lut(MULT)
    for rate in (1e-3, 1e-2):
        out = apply_faults(lut, M, FaultSpec(rate=rate, seed=0), packed=False, mult=MULT.name)
        flipped = np.unpackbits((out ^ lut).view(np.uint8)).sum()
        expect = lut.size * (M + 1) * rate
        assert 0.5 * expect <= flipped <= 1.5 * expect


def test_stuck_models_are_monotone():
    lut = get_lut(MULT)
    s1 = apply_faults(lut, M, FaultSpec(kind="stuck1", rate=1e-2, seed=0), packed=False,
                      mult=MULT.name)
    s0 = apply_faults(lut, M, FaultSpec(kind="stuck0", rate=1e-2, seed=0), packed=False,
                      mult=MULT.name)
    assert (s1 != lut).any() and (s0 != lut).any()
    np.testing.assert_array_equal(s1 | lut, s1)
    np.testing.assert_array_equal(s0 & lut, s0)


def test_burst_corrupts_exactly_the_band():
    lut = get_lut(MULT)
    n = 1 << M
    spec = FaultSpec(kind="burst", axis="row", start=n - 1, width=2, bit=3)
    diff = (apply_faults(lut, M, spec, packed=False, mult=MULT.name) ^ lut).reshape(n, n)
    mask = np.uint32(1 << (3 + 23 - M))
    for r in range(n):
        assert (diff[r] == (mask if r in (0, n - 1) else 0)).all()


@pytest.mark.parametrize("name", ["mitchell8", "fp16xbf16"])
def test_packed_unpacked_equivalence(name):
    mult = get_multiplier(name)
    spec = FaultSpec(rate=1e-2, seed=11)
    fp = apply_faults(get_packed_lut(name), mult.mantissa_bits, spec, packed=True, mult=name)
    fu = apply_faults(get_lut(name), mult.mantissa_bits, spec, packed=False, mult=name)
    np.testing.assert_array_equal(unpack_lut(fp, mult.mantissa_bits), fu)


def test_mult_targeting():
    lut = get_lut(MULT)
    spec = FaultSpec(rate=0.5, seed=0, mult="afm16")
    assert apply_faults(lut, M, spec, packed=False, mult=MULT.name) is lut
    assert (apply_faults(lut, M, spec, packed=False, mult="afm16") != lut).any()


# --------------------------------------------------- activation and the seam
def test_off_is_object_identity():
    lut = get_lut(MULT)
    assert faults.active_spec() is None
    assert faults.faulted_lut(lut, M, packed=False, mult=MULT.name) is lut
    t = ops._oracle_lut(MULT, torch.device("cpu"))
    assert ops._oracle_lut(MULT, torch.device("cpu")) is t
    np.testing.assert_array_equal(t.numpy().view(np.uint32), lut)
    assert list(ops.lut_uploads.values()) == [1]


def test_inject_scopes_and_restores(monkeypatch):
    lut = get_lut(MULT)
    with faults.inject("bitflip:rate=1e-2,seed=0") as spec:
        assert faults.active_spec() == spec
        out = faults.faulted_lut(lut, M, packed=False, mult=MULT.name)
        assert out is not lut and (out != lut).any()
    assert faults.active_spec() is None
    monkeypatch.setenv("REPRO_FAULTS", "stuck1:rate=1e-3,seed=2")
    assert faults.active_spec() == FaultSpec(kind="stuck1", rate=1e-3, seed=2)
    faults.set_active(None)
    assert faults.active_spec() is None
    faults.clear_active()
    assert faults.active_spec().kind == "stuck1"


def test_the_table_cache_keys_on_the_fault_spec():
    """A changed spec serves a fresh tensor (never the clean one under the
    faulted key, nor the other way round), faults off the very same tensor
    as before, and each (multiplier, layout, device, spec) is uploaded once."""
    cpu = torch.device("cpu")
    clean = ops._amsim_lut(MULT, cpu)
    spec_a, spec_b = "bitflip:rate=1e-2,seed=0", "bitflip:rate=1e-2,seed=1"
    with faults.inject(spec_a):
        fa = ops._amsim_lut(MULT, cpu)
        assert ops._amsim_lut(MULT, cpu) is fa
        np.testing.assert_array_equal(fa.numpy().view(np.uint16), apply_faults(
            get_packed_lut(MULT), M, parse_spec(spec_a), packed=True, mult=MULT.name))
        oracle_a = ops._oracle_lut(MULT, cpu)
        np.testing.assert_array_equal(unpack_lut(fa.numpy().view(np.uint16), M),
                                      oracle_a.numpy().view(np.uint32))
    with faults.inject(spec_b):
        fb = ops._amsim_lut(MULT, cpu)
    assert fa is not clean and fb is not clean and fa is not fb
    assert not torch.equal(fa, clean) and not torch.equal(fa, fb)
    assert ops._amsim_lut(MULT, cpu) is clean
    with faults.inject(spec_a):
        assert ops._amsim_lut(MULT, cpu) is fa
    # a spec aimed at another multiplier leaves this table: the clean tensor
    with faults.inject("bitflip:rate=0.5,seed=0,mult=afm16"):
        assert ops._amsim_lut(MULT, cpu) is clean
    assert sorted(ops.lut_uploads.values()) == [1, 1, 1, 1]   # clean, a, oracle a, b


def test_faulted_gemm_bitwise_jax_kernel_chunk1(rng):
    """Under a faulted table the port's product (the plain version here) is
    bitwise the JAX GEMM kernel at chunk=1 on JAX's faulted table; after
    the scope the clean product comes back bit for bit."""
    a = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal((16, 8)).astype(np.float32)
    pol = NumericsPolicy(mode="amsim", multiplier=MULT.name)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    clean = ops.policy_matmul(at, bt, pol, "wg")
    spec = "bitflip:rate=0.05,seed=1"
    with faults.inject(spec):
        bad = ops.policy_matmul(at, bt, pol, "wg")
        oracle = ops.policy_matmul(at, bt, NumericsPolicy(mode="amsim_torch",
                                                          multiplier=MULT.name), "wg")
    jtable = jfaults.apply_faults(jlutgen.get_packed_lut(MULT.name), M,
                                  jfaults.parse_spec(spec), packed=True, mult=MULT.name)
    ref = japprox_gemm.approx_gemm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(jtable), M,
                                   bm=128, bn=128, bk=128, chunk=1, interpret=True)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(oracle.numpy(), bad.numpy())
    assert not torch.equal(clean, bad)
    assert torch.equal(ops.policy_matmul(at, bt, pol, "wg"), clean)


def test_env_var_turns_the_seam_on(monkeypatch, rng):
    a = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    pol = NumericsPolicy(mode="amsim", multiplier=MULT.name)
    clean = ops.policy_matmul(a, b, pol)
    monkeypatch.setenv("REPRO_FAULTS", "stuck1:rate=0.2,seed=3")
    assert not torch.equal(ops.policy_matmul(a, b, pol), clean)
    with faults.inject(None):
        assert torch.equal(ops.policy_matmul(a, b, pol), clean)
