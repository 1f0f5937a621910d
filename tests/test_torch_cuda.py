"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU and the CUDA toolkit; without a card
each skips with its reason.  The file imports neither JAX nor the JAX
package, so it also runs where only the port is installed (the variable
keeps ``tests/conftest.py`` from importing JAX):

    REPRO_NO_JAX_CACHE=1 python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.paper_models import VISION_REGISTRY  # noqa: E402
from repro_torch.core import lutgen  # noqa: E402
from repro_torch.core.multipliers import get_multiplier  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.kernels import approx_conv, approx_gemm, ops  # noqa: E402
from repro_torch.kernels.common import lut_tensor  # noqa: E402
from repro_torch.models import vision  # noqa: E402

pytestmark = pytest.mark.cuda

# Shared-memory tables (afm16 both layouts, mitchell8 packed) and
# global-memory ones (mitchell8 canonical, M=10).
LUTS = [("afm16", True), ("afm16", False), ("mitchell8", True), ("mitchell8", False),
        ("afm10", True), ("afm10", False)]
CONV_CASES = [
    ((2, 6, 6, 3), (3, 3, 3, 4), 1, "SAME"),
    ((2, 8, 8, 3), (3, 3, 3, 4), 2, "SAME"),   # even input: pads (0, 1)
    ((2, 8, 8, 3), (1, 1, 3, 4), 2, "SAME"),
    ((2, 8, 8, 1), (5, 5, 1, 4), 1, "SAME"),
    ((1, 9, 7, 2), (3, 3, 2, 3), 2, "VALID"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def _lut(name, packed, device):
    table = lutgen.get_packed_lut(name) if packed else lutgen.get_lut(name)
    return lut_tensor(table, device), get_multiplier(name).mantissa_bits


def _randn(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("m,k,n", [(67, 130, 33), (1, 5, 1), (64, 784, 120)])
def test_gemm_kernel_bitwise_vs_plain(cuda, name, packed, m, k, n, rng):
    lut, M = _lut(name, packed, cuda)
    a, b = _randn(rng, (m, k), cuda), _randn(rng, (k, n), cuda)
    out = approx_gemm.approx_gemm(a, b, lut, M)
    ref = approx_gemm.approx_gemm_plain(a, b, lut, M)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("xs,ws,stride,padding", CONV_CASES)
def test_conv_kernel_bitwise_vs_plain(cuda, name, packed, xs, ws, stride, padding, rng):
    lut, M = _lut(name, packed, cuda)
    x, w = _randn(rng, xs, cuda), _randn(rng, ws, cuda)
    out = approx_conv.approx_conv2d_fused(x, w, lut, M, stride=stride, padding=padding)
    pads = approx_conv.conv_pads(xs[1], xs[2], ws[0], ws[1], stride, padding)
    ref = approx_conv.approx_conv2d_plain(x, w, lut, M, stride, pads)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_kernels_refuse_non_contiguous_operands(cuda, rng):
    lut, M = _lut("afm16", True, cuda)
    a = _randn(rng, (8, 4), cuda)
    with pytest.raises(ValueError, match="contiguous"):
        approx_gemm.approx_gemm(a.t(), _randn(rng, (8, 3), cuda), lut, M)


def test_amsim_never_reaches_the_plain_versions(cuda, monkeypatch, rng):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version reached on a CUDA tensor")

    monkeypatch.setattr(approx_gemm, "approx_gemm_plain", refuse)
    monkeypatch.setattr(approx_conv, "approx_conv2d_plain", refuse)
    pol = NumericsPolicy(mode="amsim", multiplier="afm16")
    before = (approx_conv.approx_conv2d_fused.launches, approx_gemm.approx_gemm.launches)
    ops.approx_conv2d(_randn(rng, (2, 8, 8, 3), cuda), _randn(rng, (3, 3, 3, 4), cuda), 1,
                      "SAME", pol)
    ops.policy_matmul(_randn(rng, (5, 3), cuda), _randn(rng, (3, 4), cuda), pol)
    torch.cuda.synchronize()
    assert (approx_conv.approx_conv2d_fused.launches, approx_gemm.approx_gemm.launches) == (
        before[0] + 1, before[1] + 1)


def test_resnet_mini_forward_runs_through_the_kernels(cuda, rng):
    model = vision.init_vision(VISION_REGISTRY["resnet-mini"], device=cuda)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)).to(cuda)
    approx_conv.approx_conv2d_fused.launches = 0
    approx_gemm.approx_gemm.launches = 0
    out = vision.vision_forward(model, x, NumericsPolicy(mode="amsim", multiplier="afm16"))
    assert (approx_conv.approx_conv2d_fused.launches, approx_gemm.approx_gemm.launches) == \
        (15, 1)
    ref = vision.vision_forward(model, x, NumericsPolicy(mode="amsim_torch",
                                                         multiplier="afm16"))
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
