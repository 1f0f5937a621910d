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

from repro_torch.configs.paper_models import VISION_REGISTRY, VisionConfig  # noqa: E402
from repro_torch.core import lutgen  # noqa: E402
from repro_torch.core.multipliers import get_multiplier  # noqa: E402
from repro_torch.core.policy import NumericsPolicy  # noqa: E402
from repro_torch.kernels import approx_conv, approx_gemm, ops  # noqa: E402
from repro_torch.kernels.common import lut_tensor  # noqa: E402
from repro_torch.models import vision  # noqa: E402
from repro_torch.optim.optimizers import sgdm  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

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


def _error_for(xs, ws, stride, padding, rng, device):
    pads = approx_conv.conv_pads(xs[1], xs[2], ws[0], ws[1], stride, padding)
    oh, ow = approx_conv.conv_out_shape(xs[1], xs[2], ws[0], ws[1], stride, pads)
    return _randn(rng, (xs[0], oh, ow, ws[3]), device), pads


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("xs,ws,stride,padding", CONV_CASES)
def test_dw_kernel_bitwise_vs_plain(cuda, name, packed, xs, ws, stride, padding, rng):
    lut, M = _lut(name, packed, cuda)
    x = _randn(rng, xs, cuda)
    g, pads = _error_for(xs, ws, stride, padding, rng, cuda)
    out = approx_conv.approx_conv2d_dw(x, g, lut, M, kh=ws[0], kw=ws[1], stride=stride,
                                       padding=padding)
    ref = approx_conv.approx_conv2d_dw_plain(x, g, lut, M, ws[0], ws[1], stride, pads)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("name,packed", [("afm16", True), ("afm10", True)])
@pytest.mark.parametrize("xs,ws,stride,padding", CONV_CASES)
def test_conv_kernel_bitwise_vs_plain_at_dx_shapes(cuda, name, packed, xs, ws, stride, padding,
                                                   rng):
    """The data gradient runs the forward kernel on the dilated error with
    flipped, IO-transposed weights under explicit pads."""
    lut, M = _lut(name, packed, cuda)
    g, pads = _error_for(xs, ws, stride, padding, rng, cuda)
    gd, w_rt, dpads = ops.conv_dx_operands(g, _randn(rng, ws, cuda), xs[1:3], stride, pads)
    out = approx_conv.approx_conv2d_fused(gd, w_rt, lut, M, stride=1, padding=dpads)
    ref = approx_conv.approx_conv2d_plain(gd, w_rt, lut, M, 1, dpads)
    torch.cuda.synchronize()
    assert out.shape == xs and torch.equal(out, ref)


def _narrow_resnet_step(policy, device, rng_seed=0):
    cfg = VisionConfig(name="resnet-narrow", kind="resnet", input_hw=8, input_ch=3,
                              n_classes=10, channels=(4, 8), blocks_per_stage=1)
    model = vision.init_vision(cfg, generator=torch.Generator().manual_seed(0), device=device)
    rng = np.random.default_rng(rng_seed)
    batch = {"x": torch.from_numpy(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)).to(device),
             "y": torch.from_numpy(rng.integers(0, 10, 2)).to(device)}
    opt = sgdm(0.05)
    step = make_train_step(lambda m, b: vision.vision_loss(m, b, policy), opt)
    _, metrics = step(model, opt.init(dict(model.named_parameters())), batch)
    return metrics, model


def test_train_step_runs_through_the_kernels_bitwise(cuda):
    """One step of a narrow resnet (6 convs, stem input needs no dx):
    6 + 5 launches of the conv kernel, 6 of the dw kernel, 3 of the GEMM,
    and loss and parameters bitwise equal to the same step under
    amsim_torch."""
    counters = (approx_conv.approx_conv2d_fused, approx_conv.approx_conv2d_dw,
                approx_gemm.approx_gemm)
    for fn in counters:
        fn.launches = 0
    torch.use_deterministic_algorithms(True)
    try:
        m, model = _narrow_resnet_step(NumericsPolicy(mode="amsim", multiplier="afm16"), cuda)
        launches = tuple(fn.launches for fn in counters)
        m_ref, ref = _narrow_resnet_step(NumericsPolicy(mode="amsim_torch", multiplier="afm16"),
                                         cuda)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert launches == (11, 6, 3)
    assert torch.equal(m["loss"], m_ref["loss"])
    for a, b in zip(model.parameters(), ref.parameters()):
        assert torch.equal(a, b)


def test_amsim_backward_never_reaches_the_plain_versions(cuda, monkeypatch, rng):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version reached on a CUDA tensor")

    monkeypatch.setattr(approx_gemm, "approx_gemm_plain", refuse)
    monkeypatch.setattr(approx_conv, "approx_conv2d_plain", refuse)
    monkeypatch.setattr(approx_conv, "approx_conv2d_dw_plain", refuse)
    pol = NumericsPolicy(mode="amsim", multiplier="afm16")
    x = _randn(rng, (2, 8, 8, 3), cuda).requires_grad_()
    w = _randn(rng, (3, 3, 3, 4), cuda).requires_grad_()
    ops.approx_conv2d(x, w, 2, "SAME", pol).sum().backward()
    a = _randn(rng, (5, 3), cuda).requires_grad_()
    b = _randn(rng, (3, 4), cuda).requires_grad_()
    ops.policy_matmul(a, b, pol).sum().backward()
    torch.cuda.synchronize()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
