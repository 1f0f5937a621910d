"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU and the CUDA toolkit; without a card
each skips with its reason.  The file imports neither JAX nor the JAX
package, so it also runs where only the port is installed (the variable
keeps ``tests/conftest.py`` from importing JAX):

    REPRO_NO_JAX_CACHE=1 python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch, reduced  # noqa: E402
from repro_torch.configs.paper_models import VISION_REGISTRY, VisionConfig  # noqa: E402
from repro_torch.core import faults, lutgen  # noqa: E402
from repro_torch.core.multipliers import get_multiplier  # noqa: E402
from repro_torch.core.policy import NumericsPolicy, table_from_assignments  # noqa: E402
from repro_torch.kernels import (approx_attention, approx_conv, approx_gemm,  # noqa: E402
                                 decode_chain, ops, time_chain)
from repro_torch.data.pipeline import lm_batch  # noqa: E402
from repro_torch.kernels.common import (LANES, POS_PAD, lane_sum, lut_in_smem,  # noqa: E402
                                        lut_tensor)
from repro_torch.launch.train import make_lm_train_step  # noqa: E402
from repro_torch.models import encdec, moe, vision  # noqa: E402
from repro_torch.models.layers import Linear  # noqa: E402
from repro_torch.models.transformer import init_lm, init_lm_caches, lm_loss  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.optim.optimizers import sgdm  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

pytestmark = pytest.mark.cuda

# Shared-memory tables (afm16 both layouts, mitchell8 packed) and
# global-memory ones (mitchell8 canonical, M=10); the asymmetric cross-format
# table fp16xbf16 (global, operand A 10 bits and B 7), and afm16 faulted by
# a bit-flip spec ("name|spec": core/faults.py).
FAULTED = "afm16|bitflip:rate=1e-3,seed=0"
LUTS = [("afm16", True), ("afm16", False), ("mitchell8", True), ("mitchell8", False),
        ("afm10", True), ("afm10", False), ("fp16xbf16", True), (FAULTED, True)]
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
    name, _, spec = name.partition("|")
    table = lutgen.get_packed_lut(name) if packed else lutgen.get_lut(name)
    M = get_multiplier(name).mantissa_bits
    if spec:
        table = faults.apply_faults(table, M, faults.parse_spec(spec), packed=packed,
                                    mult=get_multiplier(name).name)
    return lut_tensor(table, device), M


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


def _dw_bits(x, g, lut, M, ws, stride, padding):
    """The dw kernel against its plain version, bit for bit (+0.0 and -0.0
    differ)."""
    pads = approx_conv.conv_pads(x.shape[1], x.shape[2], ws[0], ws[1], stride, padding)
    out = approx_conv.approx_conv2d_dw(x, g, lut, M, kh=ws[0], kw=ws[1], stride=stride,
                                       padding=padding)
    ref = approx_conv.approx_conv2d_dw_plain(x, g, lut, M, ws[0], ws[1], stride, pads)
    torch.cuda.synchronize()
    return out, _same_bits(out, ref)


# The dw kernel's tiles (TC, TO), forced: the split path's 8, 16 and 32
# outputs with TO = 8 and wider, the tiled path with TO = 32, 64 and 8; and
# every table form (name, packed, where and how the kernel reads it).
DW_FORCED = [(1, 8), (2, 8), (4, 8), (1, 16), (1, 32), (8, 32), (4, 64), (32, 8)]
DW_TABLES = [("afm16", True, "smem packed"), ("afm16", True, "smem canonical"),
             ("afm16", False, "smem canonical"), ("mitchell8", True, "smem packed"),
             ("mitchell8", False, "global canonical"), ("afm10", True, "global packed"),
             ("afm10", False, "global canonical")]


def _force_dw(monkeypatch, tile, table):
    import dataclasses
    plan_of = approx_conv.dw_plan
    outputs = tile[0] * tile[1]

    def forced(*a):
        return dataclasses.replace(
            plan_of(*a), tile=tile, outputs=outputs, chunk=approx_conv.dw_chunk(outputs),
            path="tiled" if outputs >= approx_conv.DW_THREADS else "split", table=table)

    monkeypatch.setattr(approx_conv, "dw_plan", forced)
    return forced


@pytest.mark.parametrize("name,packed,table", DW_TABLES)
@pytest.mark.parametrize("tile", DW_FORCED)
def test_dw_kernel_bitwise_vs_plain_on_every_tile(cuda, monkeypatch, name, packed, table, tile,
                                                  rng):
    """Each tile at its edges (channels and columns one past a tile, fewer
    positions than a chunk, several chunks and a partial one, stride 2 with
    odd pads), then at more tiles than the card holds blocks."""
    lut, M = _lut(name, packed, cuda)
    forced = _force_dw(monkeypatch, tile, table)
    tc, to = tile
    cases = [((2, 9, 7, tc + 1), (3, 3, tc + 1, to + 1), 1, "SAME"),
             ((1, 3, 2, tc), (3, 3, tc, max(1, to - 1)), 1, "SAME"),
             ((3, 17, 13, 2 * tc), (3, 3, 2 * tc, to), 2, "SAME"),
             ((2, 11, 9, 3), (2, 3, 3, 2 * to + 3), 2, "VALID")]
    for xs, ws, stride, padding in cases:
        x = _randn(rng, xs, cuda)
        g, _ = _error_for(xs, ws, stride, padding, rng, cuda)
        assert _dw_bits(x, g, lut, M, ws, stride, padding)[1], (xs, ws, stride, padding)
    # more tiles than blocks: each block walks several
    xs, ws = (2, 5, 4, 30 * tc), (3, 3, 30 * tc, 4 * to)
    grid = approx_conv.dw_grid(forced(3, 3, ws[2], ws[3], lut, 0), 3, 3, ws[2], ws[3], lut)
    assert grid["tiles"] == 9 * 30 * 4 and grid["blocks"] < grid["tiles"], grid
    x = _randn(rng, xs, cuda)
    g, _ = _error_for(xs, ws, 1, "SAME", rng, cuda)
    assert _dw_bits(x, g, lut, M, ws, 1, "SAME")[1]


def _special(rng, shape, device):
    """Random normals with zeros, -0.0, subnormals, inf, -inf and NaN mixed
    in."""
    v = rng.standard_normal(shape).astype(np.float32)
    pick = rng.integers(0, 12, size=shape)
    v[pick == 0] = 0.0
    v[pick == 1] = -0.0
    v[pick == 2] = (rng.standard_normal(int((pick == 2).sum())) * 1e-39).astype(np.float32)
    v[pick == 3] = np.inf
    v[pick == 4] = -np.inf
    v[pick == 5] = np.nan
    return torch.from_numpy(v).to(device)


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("xs,ws,stride,padding", CONV_CASES)
def test_dw_kernel_bitwise_vs_plain_with_special_values(cuda, name, packed, xs, ws, stride,
                                                        padding, rng):
    lut, M = _lut(name, packed, cuda)
    pads = approx_conv.conv_pads(xs[1], xs[2], ws[0], ws[1], stride, padding)
    oh, ow = approx_conv.conv_out_shape(xs[1], xs[2], ws[0], ws[1], stride, pads)
    for _ in range(3):
        x, g = _special(rng, xs, cuda), _special(rng, (xs[0], oh, ow, ws[3]), cuda)
        assert _dw_bits(x, g, lut, M, ws, stride, padding)[1]


@pytest.mark.parametrize("name,packed", LUTS)
def test_dw_kernel_where_every_product_is_a_padding_tap(cuda, name, packed, rng):
    """A 5x5 kernel on a 2x2 image: the taps two off the centre see only
    padding, so their outputs are +0.0 (even where g holds inf and NaN)."""
    lut, M = _lut(name, packed, cuda)
    x = _randn(rng, (3, 2, 2, 3), cuda)
    g = _special(rng, (3, 2, 2, 6), cuda)
    out, same = _dw_bits(x, g, lut, M, (5, 5, 3, 6), 1, "SAME")
    assert same
    bits = out.view(torch.int32)
    assert int(bits[0].abs().sum()) == 0 and int(bits[:, 0].abs().sum()) == 0
    assert int(bits[4].abs().sum()) == 0 and int(bits[:, 4].abs().sum()) == 0


# Every dw shape of resnet-mini and LeNet-5 at batch 64 (chip_smoke.py's
# CONV_SHAPES): (x shape, w shape, stride), all SAME.
DW_PATH_SHAPES = [((64, 32, 32, 3), (3, 3, 3, 16), 1), ((64, 32, 32, 16), (3, 3, 16, 16), 1),
                  ((64, 32, 32, 16), (3, 3, 16, 32), 2), ((64, 32, 32, 16), (1, 1, 16, 32), 2),
                  ((64, 16, 16, 32), (3, 3, 32, 32), 1), ((64, 16, 16, 32), (3, 3, 32, 64), 2),
                  ((64, 16, 16, 32), (1, 1, 32, 64), 2), ((64, 8, 8, 64), (3, 3, 64, 64), 1),
                  ((64, 28, 28, 1), (5, 5, 1, 6), 1), ((64, 14, 14, 6), (5, 5, 6, 16), 1)]


@pytest.mark.parametrize("name,packed", [("afm16", True), ("afm16", False), ("afm10", True)])
def test_dw_grid_covers_every_sm(cuda, name, packed):
    """At every path shape the launched blocks reach min(tiles, SMs) and are
    no more than the tiles; a shape whose plan has fewer tiles than SMs has
    no tile of fewer outputs to take."""
    lut, _ = _lut(name, packed, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for xs, ws, stride in DW_PATH_SHAPES:
        kh, kw, c, o = ws
        pads = approx_conv.conv_pads(xs[1], xs[2], kh, kw, stride, "SAME")
        oh, ow = approx_conv.conv_out_shape(xs[1], xs[2], kh, kw, stride, pads)
        plan = approx_conv.dw_plan(kh, kw, c, o, lut, sms)
        grid = approx_conv.dw_grid(plan, kh, kw, c, o, lut)
        assert grid["tiles"] == plan.tiles, (xs, ws, plan, grid)
        assert min(plan.tiles, sms) <= grid["blocks"] <= plan.tiles, (xs, ws, plan, grid)
        assert plan.tiles >= sms or plan.outputs == min(approx_conv.DW_SPLIT_OUTPUTS), (xs, ws,
                                                                                       plan)


@pytest.mark.parametrize("name,packed", [("afm16", True), ("afm10", True)])
@pytest.mark.parametrize("xs,ws,stride", DW_PATH_SHAPES)
def test_dw_kernel_bitwise_vs_plain_at_path_shapes(cuda, name, packed, xs, ws, stride, rng):
    """The plan each path shape takes (the batch does not enter it), at
    batch 8."""
    lut, M = _lut(name, packed, cuda)
    xs = (8, *xs[1:])
    x = _randn(rng, xs, cuda)
    g, _ = _error_for(xs, ws, stride, "SAME", rng, cuda)
    assert _dw_bits(x, g, lut, M, ws, stride, "SAME")[1]


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


def _conv_bits(x, w, lut, M, stride, padding, dilation=1):
    """The conv kernel against its plain version, bit for bit (+0.0 and
    -0.0 differ); the plain version materialises the dilation."""
    hd, wd = ((s - 1) * dilation + 1 for s in x.shape[1:3])
    pads = approx_conv.conv_pads(hd, wd, w.shape[0], w.shape[1], stride, padding)
    out = approx_conv.approx_conv2d_fused(x, w, lut, M, stride=stride, padding=padding,
                                          input_dilation=dilation)
    ref = approx_conv.approx_conv2d_plain(approx_conv.dilate(x, dilation), w, lut, M, stride,
                                          pads)
    torch.cuda.synchronize()
    return out, _same_bits(out, ref)


def _dx_operands(xs, ws, stride, padding, rng, device, special=False):
    """The undilated error, the reversed IO-transposed weights and the
    explicit pads of the data gradient of a conv of x ``xs``."""
    pads = approx_conv.conv_pads(xs[1], xs[2], ws[0], ws[1], stride, padding)
    oh, ow = approx_conv.conv_out_shape(xs[1], xs[2], ws[0], ws[1], stride, pads)
    make = _special if special else _randn
    g, w = make(rng, (xs[0], oh, ow, ws[3]), device), make(rng, ws, device)
    w_rt, dpads = ops.conv_dx_weights(w, (oh, ow), xs[1:3], stride, pads)
    return g, w_rt, dpads


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("xs,ws,stride,padding", CONV_CASES)
def test_conv_kernel_with_input_dilation_bitwise_vs_plain(cuda, name, packed, xs, ws, stride,
                                                         padding, rng):
    """The data gradient as the amsim backward runs it: the error read
    undilated, input_dilation = stride; random values, then values with
    zeros, -0.0, subnormals, inf and NaN."""
    lut, M = _lut(name, packed, cuda)
    for special in (False, True, True):
        g, w_rt, dpads = _dx_operands(xs, ws, stride, padding, rng, cuda, special)
        out, same = _conv_bits(g, w_rt, lut, M, 1, dpads, stride)
        assert out.shape == xs[:3] + (ws[2],) and same, (special, dpads)


@pytest.mark.parametrize("name,packed", [("afm16", True), ("afm10", True)])
@pytest.mark.parametrize("xs,ws,stride", DW_PATH_SHAPES)
def test_conv_kernel_bitwise_vs_plain_at_path_dx_shapes(cuda, name, packed, xs, ws, stride, rng):
    """Every data gradient of resnet-mini and LeNet-5, from the undilated
    error, at batch 8 (chip_smoke.py holds batch 64, whose plans may
    differ)."""
    lut, M = _lut(name, packed, cuda)
    xs = (8, *xs[1:])
    g, w_rt, dpads = _dx_operands(xs, ws, stride, "SAME", rng, cuda)
    assert _conv_bits(g, w_rt, lut, M, 1, dpads, stride)[1]


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("xs,ws,stride,padding", CONV_CASES)
def test_conv_kernel_bitwise_vs_plain_with_special_values(cuda, name, packed, xs, ws, stride,
                                                         padding, rng):
    lut, M = _lut(name, packed, cuda)
    for _ in range(3):
        x, w = _special(rng, xs, cuda), _special(rng, ws, cuda)
        assert _conv_bits(x, w, lut, M, stride, padding)[1]


# The conv kernel's tiles (TM, WN): every one it takes; and every table
# form (name, packed, where and how the kernel reads it).
CONV_FORCED = list(approx_conv.CONV_TILES)
CONV_TABLES = [("afm16", True, "smem packed"), ("afm16", True, "smem canonical"),
               ("afm16", False, "smem canonical"), ("mitchell8", True, "smem packed"),
               ("mitchell8", False, "global canonical"), ("afm10", True, "global packed"),
               ("afm10", False, "global canonical")]


def _force_conv(monkeypatch, tm, wn, table):
    import dataclasses
    plan_of = approx_conv.conv_plan
    block = (approx_conv.CONV_WARPS // wn * 32 * tm, wn * approx_conv.CONV_TN)

    def forced(*a):
        return dataclasses.replace(plan_of(*a), tile=(tm, approx_conv.CONV_TN),
                                   warps=(approx_conv.CONV_WARPS // wn, wn), block=block,
                                   table=table)

    monkeypatch.setattr(approx_conv, "conv_plan", forced)
    return forced


@pytest.mark.parametrize("name,packed,table", CONV_TABLES)
@pytest.mark.parametrize("tm,wn", CONV_FORCED)
def test_conv_kernel_bitwise_vs_plain_on_every_tile(cuda, monkeypatch, name, packed, table, tm,
                                                    wn, rng):
    """Each tile at its edges (channels one past a slab and a tile, fewer
    positions than a tile, several position and channel tiles, stride 2 and
    3, a dilated input, more channels than a slab, whole taps in the
    padding), forward and data gradient, then at more tiles than the card
    holds blocks."""
    lut, M = _lut(name, packed, cuda)
    forced = _force_conv(monkeypatch, tm, wn, table)
    bn = wn * approx_conv.CONV_TN
    cases = [((2, 9, 7, 3), (3, 3, 3, bn + 1), 1, "SAME"),
             ((1, 3, 2, 9), (3, 3, 9, max(1, bn - 1)), 1, "SAME"),
             ((3, 17, 13, 17), (3, 3, 17, bn), 2, "SAME"),
             ((2, 11, 9, 5), (2, 3, 5, 2 * bn + 3), 3, "VALID"),
             ((3, 2, 2, 3), (5, 5, 3, 6), 1, "SAME")]
    for xs, ws, stride, padding in cases:
        x, w = _randn(rng, xs, cuda), _randn(rng, ws, cuda)
        assert _conv_bits(x, w, lut, M, stride, padding)[1], (xs, ws, stride, padding)
        g, w_rt, dpads = _dx_operands(xs, ws, stride, padding, rng, cuda)
        assert _conv_bits(g, w_rt, lut, M, 1, dpads, stride)[1], ("dx", xs, ws, stride)
    x, w = _randn(rng, (2, 5, 4, 3), cuda), _randn(rng, (3, 3, 3, 4), cuda)
    assert _conv_bits(x, w, lut, M, 2, "SAME", 3)[1]         # dilation 3 with stride 2
    # more tiles than the card holds blocks (8 of 256 threads an SM at most,
    # 1088 tiles at the largest tile): each block walks several
    xs, ws = (34, 32, 16, 1), (1, 1, 1, 32 * bn)
    shape = approx_conv.conv_shape(xs, ws, 1, (0, 0, 0, 0))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    grid = approx_conv.conv_grid(forced(shape, lut, sms), shape, lut)
    assert grid["blocks"] < grid["tiles"], grid
    x, w = _randn(rng, xs, cuda), _randn(rng, ws, cuda)
    assert _conv_bits(x, w, lut, M, 1, "SAME")[1]


@pytest.mark.parametrize("name,packed", [("afm16", True), ("afm16", False), ("afm10", True)])
def test_conv_grid_covers_every_sm(cuda, name, packed):
    """At every path shape, forward and data gradient, the launched blocks
    reach min(tiles, SMs) and are no more than the tiles."""
    lut, _ = _lut(name, packed, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for xs, ws, stride in DW_PATH_SHAPES:
        pads = approx_conv.conv_pads(xs[1], xs[2], ws[0], ws[1], stride, "SAME")
        fwd = approx_conv.conv_shape(xs, ws, stride, pads)
        w_rt, dpads = ops.conv_dx_weights(torch.zeros(ws), (fwd.oh, fwd.ow), xs[1:3], stride,
                                          pads)
        dx = approx_conv.conv_shape((xs[0], fwd.oh, fwd.ow, ws[3]), tuple(w_rt.shape), 1,
                                    dpads, stride)
        for shape in (fwd, dx):
            plan = approx_conv.conv_plan(shape, lut, sms)
            grid = approx_conv.conv_grid(plan, shape, lut)
            assert grid["tiles"] == plan.tiles, (shape, plan, grid)
            assert min(plan.tiles, sms) <= grid["blocks"] <= plan.tiles, (shape, plan, grid)


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


# ------------------------------------------------ attention and decode chain
def _ring(T, written):
    """Positions of a ring of T slots after `written` tokens (POS_PAD where
    none was written yet)."""
    pos = np.full(T, POS_PAD, np.int64)
    for p in range(max(0, written - T), written):
        pos[p % T] = p
    return pos


# (B, S, H, KV, dh, T, q_pos, k_pos, causal, window); rows 6-8 are
# bidirectional (an encoder's and cross-attention's): S != T, 16 queries
# over whisper-base's 1500 frames, and a decode step over them; the last
# three are heads of 128 (two whole value chunks: G = 7 as llava-next-34b's,
# a causal prefill into a ring, and a decode step over a ring) and of 160
# (a ragged chunk of 32: G = 4 as stablelm-12b's, a ring of 160 with a
# window).
ATTN_CASES = [
    (2, 8, 4, 2, 32, 8, range(8), range(8), True, 0),
    (2, 8, 4, 4, 64, 8, range(8), range(8), True, 3),
    (3, 5, 6, 3, 48, 70, range(60, 65), _ring(70, 65), True, 0),
    (2, 1, 8, 2, 64, 40, [44], _ring(40, 45), True, 0),
    (2, 1, 8, 2, 64, 160, [29], _ring(160, 30), True, 8),
    (2, 6, 4, 2, 32, 11, range(6), range(11), False, 0),
    (2, 16, 8, 8, 64, 1500, range(16), range(1500), False, 0),
    (4, 1, 8, 8, 64, 1500, [3], range(1500), False, 0),
    (1, 9, 14, 2, 128, 40, range(31, 40), _ring(40, 40), True, 0),
    (2, 1, 14, 2, 128, 96, [79], _ring(96, 80), True, 0),
    (2, 1, 8, 2, 160, 160, [95], _ring(160, 96), True, 8),
]


def _attention_inputs(case, rng, device):
    B, S, H, KV, dh, T, q_pos, k_pos, causal, window = case
    pos = [torch.tensor(list(p), dtype=torch.int32, device=device) for p in (q_pos, k_pos)]
    return ([_randn(rng, (B, S, H, dh), device), _randn(rng, (B, T, KV, dh), device),
             _randn(rng, (B, T, KV, dh), device), *pos], dict(causal=causal, window=window))


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_attention_kernel_bitwise_vs_plain(cuda, name, packed, case, rng):
    lut, M = _lut(name, packed, cuda)
    args, kw = _attention_inputs(ATTN_CASES[case], rng, cuda)
    out = approx_attention.approx_attention(*args, lut, M, **kw)
    ref = approx_attention.approx_attention_plain(*args, lut, M, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _attention_bits(args, kw, lut, M):
    """Whether the kernel gives the plain version's bits (int32 views, so
    that NaN outputs and the sign of zeros compare too)."""
    out = approx_attention.approx_attention(*args, lut, M, **kw)
    ref = approx_attention.approx_attention_plain(*args, lut, M, **kw)
    torch.cuda.synchronize()
    return torch.equal(out.view(torch.int32), ref.view(torch.int32))


# The attention kernel's serving shapes: granite-3-2b's prefill of 4 x 64
# into a ring of 96, its decode step over a ring of 160 (96 written),
# granite-moe-3b-a800m's decode step over 96 (80 written, G = 3), and a
# prefill of 512 into a ring of 512.
ATTN_PATH_CASES = [
    (4, 64, 32, 8, 64, 96, range(64), _ring(96, 64), True, 0),
    (4, 1, 32, 8, 64, 160, [95], _ring(160, 96), True, 0),
    (4, 1, 24, 8, 64, 96, [79], _ring(96, 80), True, 0),
    (1, 512, 32, 8, 64, 512, range(512), _ring(512, 512), True, 0),
]


@pytest.mark.parametrize("name,packed", [("afm16", True), ("afm10", True)])
@pytest.mark.parametrize("case", range(len(ATTN_PATH_CASES)))
def test_attention_kernel_bitwise_vs_plain_at_path_shapes(cuda, name, packed, case, rng):
    lut, M = _lut(name, packed, cuda)
    args, kw = _attention_inputs(ATTN_PATH_CASES[case], rng, cuda)
    assert _attention_bits(args, kw, lut, M)


def _special_attention_inputs(case, rng, device):
    """Zeros, -0.0 and subnormals in q, k and v, and inf, -inf and NaN in
    the K and V of every unwritten ring slot (k_pos < 0)."""
    args, kw = _attention_inputs(case, rng, device)
    unwritten = args[4] < 0
    for a in args[:3]:
        pick = torch.from_numpy(rng.integers(0, 8, a.shape)).to(device)
        a[pick == 0] = 0.0
        a[pick == 1] = -0.0
        a[pick == 2] *= 1e-39
    for a in args[1:3]:
        pick = torch.from_numpy(rng.integers(0, 3, a.shape)).to(device)
        for i, value in enumerate((float("inf"), -float("inf"), float("nan"))):
            a[:, unwritten] = torch.where(pick[:, unwritten] == i, value, a[:, unwritten])
    return args, kw


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("case", [*range(len(ATTN_CASES)), "moe_decode", "granite_prefill"])
def test_attention_kernel_bitwise_vs_plain_with_special_values(cuda, name, packed, case, rng):
    lut, M = _lut(name, packed, cuda)
    shape = {"moe_decode": ATTN_PATH_CASES[2], "granite_prefill": ATTN_PATH_CASES[0]}
    args, kw = _special_attention_inputs(shape.get(case) or ATTN_CASES[case], rng, cuda)
    assert _attention_bits(args, kw, lut, M)


@pytest.mark.parametrize("name,packed", LUTS)
def test_attention_kernel_gives_a_row_without_a_valid_key_the_mean_of_v(cuda, name, packed, rng):
    """A prefill of 12 tokens into a ring of 8: positions 0-3 lost their
    keys, so their rows average V (uniform p, which is not zero on masked
    keys); with G = 2 and 4 their tiles also hold rows with valid keys."""
    lut, M = _lut(name, packed, cuda)
    for G in (2, 4):
        args, kw = _attention_inputs((2, 12, 2 * G, 2, 32, 8, range(12), _ring(8, 12), True, 0),
                                     rng, cuda)
        assert _attention_bits(args, kw, lut, M)
        out = approx_attention.approx_attention(*args, lut, M, **kw)
        assert bool(torch.isfinite(out).all()) and float(out[:, :4].abs().amax()) > 0


# Every tile of the attention kernel with every table form (name, packed,
# where and how the kernel reads it), and the layouts it takes: K chunks
# and V slabs of the full width and of a quarter, scores in shared and in
# global memory.
ATTN_FORCED = range(len(approx_attention.ATTN_TILES))
ATTN_TABLES = [("afm16", True, "smem packed"), ("afm16", True, "smem canonical"),
               ("afm16", False, "smem canonical"), ("mitchell8", False, "smem canonical"),
               ("afm10", True, "global packed"), ("afm10", False, "global canonical")]


def _force_attention(monkeypatch, tile, table, quarter, scores_smem):
    """Force the tile, the table form and the layout where they fit a
    block; else the tile and table in the layout the planner would give
    them (``attention_layout``); else the shape's own plan."""
    plan_of = approx_attention.attention_plan

    def forced(shape, lut, sms):
        rows, key_slab = approx_attention.tile_rows_keys(tile)
        space = approx_attention.SMEM_BLOCK_MAX - approx_attention._table_bytes(
            table, lut.dtype == torch.int16, lut.numel() * lut.element_size())
        cw = max(1, min(shape.dh, 64) // (4 if quarter else 1))
        layout = (cw, 16 if quarter else key_slab, scores_smem)
        if approx_attention.attention_smem_bytes(rows, key_slab, shape.dh, shape.T,
                                                 *layout) > space:
            layout = approx_attention.attention_layout(tile, shape.dh, shape.T, space)
        if layout is None:
            return plan_of(shape, lut, sms)
        return approx_attention._tile_plan(shape, tile, table, layout,
                                           "decode" if shape.S == 1 else "prefill")

    monkeypatch.setattr(approx_attention, "attention_plan", forced)
    return forced


@pytest.mark.parametrize("name,packed,table", ATTN_TABLES)
@pytest.mark.parametrize("tile", ATTN_FORCED)
@pytest.mark.parametrize("quarter,scores_smem", [(False, True), (True, False)])
def test_attention_kernel_bitwise_vs_plain_under_every_plan(cuda, monkeypatch, name, packed,
                                                            table, tile, quarter, scores_smem,
                                                            rng):
    """Each tile at its edges: G = 1, 3 and 8 (more heads than a decode
    tile), more rows than a tile, T not a multiple of a slab, a window, an
    odd head dim and one of 256 (four value chunks), decode, rows without a
    valid key, heads of 128 (G = 7) and 160 (a ragged chunk) and special
    values in unwritten slots; then more tiles than the card holds
    blocks."""
    lut, M = _lut(name, packed, cuda)
    forced = _force_attention(monkeypatch, tile, table, quarter, scores_smem)
    cases = [(2, 8, 4, 2, 32, 8, range(8), range(8), True, 0),
             (3, 5, 6, 2, 48, 70, range(60, 65), _ring(70, 65), True, 0),
             (1, 9, 16, 2, 37, 70, range(40, 49), _ring(70, 49), True, 5),
             (2, 1, 8, 8, 64, 131, [129], _ring(131, 130), True, 0),
             (1, 3, 4, 1, 256, 67, range(60, 63), _ring(67, 63), True, 0),
             (2, 12, 4, 2, 32, 8, range(12), _ring(8, 12), True, 0),
             (1, 70, 8, 8, 64, 1500, range(70), range(1500), False, 0),
             (1, 9, 14, 2, 128, 40, range(31, 40), _ring(40, 40), True, 0),
             (2, 6, 8, 2, 160, 70, range(60, 66), _ring(70, 66), True, 0)]
    for case in cases:
        args, kw = _attention_inputs(case, rng, cuda)
        assert _attention_bits(args, kw, lut, M), case
    args, kw = _special_attention_inputs(cases[1], rng, cuda)
    assert _attention_bits(args, kw, lut, M)
    # more tiles than the card holds blocks: each block walks several
    case = (8, 64, 16, 8, 16, 64, range(64), range(64), True, 0)
    shape = approx_attention.AttnShape(8, 64, 16, 8, 64, 16)
    grid = approx_attention.attention_grid(forced(shape, lut, 132), shape, lut)
    assert grid["tiles"] == forced(shape, lut, 132).tiles
    args, kw = _attention_inputs(case, rng, cuda)
    assert _attention_bits(args, kw, lut, M)


@pytest.mark.parametrize("name,packed", [("afm16", True), ("afm10", True)])
def test_attention_kernel_bitwise_vs_plain_at_whisper_encoder(cuda, name, packed, rng):
    """whisper-base's encoder attention, 4 x 1500 frames over themselves
    (causal=False): under afm16 its plan takes tiles of 64 rows whose scores
    (384 KiB) sit in the global scratch; the bits are the plain version's,
    with special values in q, k and v too."""
    lut, M = _lut(name, packed, cuda)
    case = (4, 1500, 8, 8, 64, 1500, range(1500), range(1500), False, 0)
    shape = approx_attention.AttnShape(4, 1500, 8, 8, 1500, 64, False)
    plan = approx_attention.attention_plan(
        shape, lut, torch.cuda.get_device_properties(cuda).multi_processor_count)
    if name == "afm16":
        assert (plan.rows, plan.scores) == (64, "global")
    args, kw = _attention_inputs(case, rng, cuda)
    assert _attention_bits(args, kw, lut, M)
    args, kw = _special_attention_inputs(case, rng, cuda)
    assert _attention_bits(args, kw, lut, M)


@pytest.mark.parametrize("name,packed", [("afm16", True), ("afm16", False), ("afm10", True)])
def test_attention_grid_covers_the_card(cuda, name, packed):
    """At every path shape the launched blocks reach min(tiles, SMs) and
    are no more than the tiles; the plan fits a block."""
    lut, _ = _lut(name, packed, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B, S, H, KV, dh, T, *_ in ATTN_PATH_CASES:
        shape = approx_attention.AttnShape(B, S, H, KV, T, dh)
        plan = approx_attention.attention_plan(shape, lut, sms)
        grid = approx_attention.attention_grid(plan, shape, lut)
        assert grid["tiles"] == plan.tiles, (shape, plan, grid)
        assert min(plan.tiles, sms) <= grid["blocks"] <= plan.tiles, (shape, plan, grid)


# (rows, d, H, KV, dh, F): two k-tiles and two column tiles of the chain
# kernels at 160/300, two row groups at 9 rows; rows 4 and 8 at a d and F
# that are multiples of neither the back half's column tiles (8, 32) nor
# its k-chunks (128 k steps for wo and wd, 16 for gate/up); four row groups
# at 32 rows, with a wo contraction of 148 (a full k-chunk, then a partial
# one); then granite-3-2b's widths.
CHAIN_CASES = [(1, 160, 4, 2, 40, 300), (3, 160, 4, 2, 40, 300), (9, 160, 4, 2, 40, 300),
               (4, 130, 2, 1, 37, 301), (8, 130, 2, 1, 37, 301), (32, 130, 4, 1, 37, 301),
               (4, 2048, 32, 8, 64, 8192)]
SMALL_CHAIN = range(len(CHAIN_CASES) - 1)
FULL_LUTS = [("afm16", True), ("afm10", True)]     # one shared-memory, one global-memory table


def _chain_inputs(case, rng, device):
    rows, d, H, KV, dh, F = case
    w = lambda k, n: _randn(rng, (k, n), device) * k ** -0.5  # noqa: E731
    return dict(x=_randn(rng, (rows, d), device), g=1 + 0.1 * _randn(rng, (d,), device),
                wq=w(d, H * dh), wk=w(d, KV * dh), wv=w(d, KV * dh),
                attn=_randn(rng, (rows, H * dh), device), wo=w(H * dh, d), wg=w(d, F),
                wu=w(d, F), wd=w(F, d),
                bo=0.1 * _randn(rng, (d,), device), bd=0.1 * _randn(rng, (d,), device))


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("case", range(len(CHAIN_CASES)))
def test_chain_kernels_bitwise_vs_plain(cuda, name, packed, case, rng):
    if case == len(CHAIN_CASES) - 1 and (name, packed) not in FULL_LUTS:
        pytest.skip("full width only with one shared-memory and one global-memory table")
    lut, M = _lut(name, packed, cuda)
    o = _chain_inputs(CHAIN_CASES[case], rng, cuda)
    qkv = [o[n] for n in ("x", "g", "wq", "wk", "wv")]
    out = decode_chain.fused_qkv_norm(*qkv, lut, M, eps=1e-5)
    ref = decode_chain.fused_qkv_norm_plain(*qkv, lut, M, eps=1e-5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    back = [o[n] for n in ("x", "attn", "g", "wo", "wg", "wu", "wd")]
    for bias in ({}, {"bo": o["bo"], "bd": o["bd"]}):
        out = decode_chain.fused_out_mlp(*back, lut, M, eps=1e-5, **bias)
        ref = decode_chain.fused_out_mlp_plain(*back, lut, M, eps=1e-5, **bias)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


def _attn_out_mlp_bitwise(case, T, written, window, lut, M, rng, device, biases=()):
    rows, d, H, KV, dh, F = case
    o = _chain_inputs(case, rng, device)
    args, _ = _attention_inputs((rows, 1, H, KV, dh, T, [written - 1], _ring(T, written), True,
                                 window), rng, device)
    tail = [o[n] for n in ("g", "wo", "wg", "wu", "wd")]
    bias = {n: o[n] for n in biases}
    out = decode_chain.fused_attn_out_mlp(o["x"], *args, *tail, lut, M, eps=1e-5,
                                          window=window, **bias)
    ref = decode_chain.fused_attn_out_mlp_plain(o["x"], *args, *tail, lut, M, eps=1e-5,
                                                causal=True, window=window, **bias)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("T,written,window", [(20, 13, 0), (40, 45, 0), (128, 100, 16)])
@pytest.mark.parametrize("case", SMALL_CHAIN)
def test_attn_out_mlp_kernel_bitwise_vs_plain(cuda, name, packed, T, written, window, case, rng):
    lut, M = _lut(name, packed, cuda)
    _attn_out_mlp_bitwise(CHAIN_CASES[case], T, written, window, lut, M, rng, cuda, ("bo",))


@pytest.mark.parametrize("name,packed", FULL_LUTS)
def test_attn_out_mlp_kernel_bitwise_vs_plain_at_full_width(cuda, name, packed, rng):
    """granite-3-2b's widths, 4 rows, a ring of 96 slots with 70 written:
    the 2-launch form of a decode step, with and without the biases."""
    lut, M = _lut(name, packed, cuda)
    for biases in ((), ("bo", "bd")):
        _attn_out_mlp_bitwise(CHAIN_CASES[-1], 96, 70, 0, lut, M, rng, cuda, biases)


@pytest.mark.parametrize("name,packed", FULL_LUTS)
def test_back_half_grid_covers_every_sm(cuda, name, packed):
    """granite-3-2b at 4 rows: 256 work items in each fold phase, and the
    cooperative grid has a block on every SM, no more blocks than items; at
    32 rows four row groups of them, in the same shared memory a block.
    The attention phase has a tile for each (row, kv-head): its 4 heads."""
    lut, _ = _lut(name, packed, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for rows in (4, 32):
        groups = (rows + 7) // 8
        for heads, kv_heads in ((0, 0), (32, 8)):
            g = decode_chain.back_half_grid(rows, 2048, 8192, lut, heads=heads,
                                            kv_heads=kv_heads)
            items = 256 * groups
            assert (g["wo"], g["gate_up"], g["down"], g["attention"]) == (
                items, items, items, rows * kv_heads)
            assert sms <= g["blocks"] <= items


# The chain at heads of 128 and 160: (rows, d, H, KV, dh, F) with qwen2.5's
# G = 5 at dh 128 and stablelm's G = 4 at dh 160, narrow; then stablelm-12b's
# own widths.
BIG_HEAD_CHAIN = [(4, 640, 10, 2, 128, 300), (4, 640, 8, 2, 160, 300),
                  (4, 5120, 32, 8, 160, 13824)]


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("case", range(len(BIG_HEAD_CHAIN)))
def test_chain_kernels_bitwise_vs_plain_at_heads_of_128_and_160(cuda, name, packed, case, rng):
    """``fused_qkv_norm`` (q of H x dh columns, k and v of KV x dh) and
    ``fused_attn_out_mlp`` (its attention phase over a ring of 96 with 70
    written, and of 128 with a window of 16) at heads of 128 and 160: the
    plain versions' bits."""
    if case == len(BIG_HEAD_CHAIN) - 1 and (name, packed) not in FULL_LUTS:
        pytest.skip("full width only with one shared-memory and one global-memory table")
    lut, M = _lut(name, packed, cuda)
    o = _chain_inputs(BIG_HEAD_CHAIN[case], rng, cuda)
    qkv = [o[n] for n in ("x", "g", "wq", "wk", "wv")]
    out = decode_chain.fused_qkv_norm(*qkv, lut, M, eps=1e-5)
    ref = decode_chain.fused_qkv_norm_plain(*qkv, lut, M, eps=1e-5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    for T, written, window in ((96, 70, 0), (128, 100, 16)):
        _attn_out_mlp_bitwise(BIG_HEAD_CHAIN[case], T, written, window, lut, M, rng, cuda)


@pytest.mark.parametrize("name,packed", LUTS)
def test_attn_out_mlp_kernel_bitwise_vs_plain_with_scores_in_global_memory(cuda, name, packed,
                                                                           rng):
    """A ring of 3000 slots: the phase's scores outgrow the fold buffers
    and go to a global scratch (at one row also with halved K chunks and V
    slabs); G = 3."""
    lut, M = _lut(name, packed, cuda)
    for rows in (1, 4):
        assert decode_chain.attention_phase_plan(rows, 6, 2, 3000, 64, lut).scores == "global"
        _attn_out_mlp_bitwise((rows, 160, 6, 2, 64, 300), 3000, 2500, 0, lut, M, rng, cuda)


def test_kernel_exp_and_rsqrt_match_torch(cuda):
    """The kernels' expf and rsqrtf against torch.exp and torch.rsqrt on the
    card, over every 101st float32 bit pattern (NaNs left out)."""
    bits = torch.arange(0, 2 ** 32, 101, dtype=torch.int64, device=cuda)
    x = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)
    x = x[~torch.isnan(x)].contiguous()
    e, r = decode_chain.device_exp_rsqrt(x)
    for got, want in ((e, torch.exp(x)), (r, torch.rsqrt(x))):
        both_nan = torch.isnan(got) & torch.isnan(want)
        differ = (got.view(torch.int32) != want.view(torch.int32)) & ~both_nan
        assert int(differ.sum()) == 0, x[differ][:8]


def _serve(model, mode, max_len, prompts):
    engine = ServingEngine(model, NumericsPolicy(mode=mode, multiplier="afm16"), max_len=max_len)
    return engine.generate(prompts, 4, return_logits=True)


@pytest.mark.parametrize("max_len,per_step", [(16, (2, 0, 0, 2, 1)), (136, (2, 2, 2, 0, 1))])
def test_serving_runs_through_the_kernels_bitwise(cuda, max_len, per_step):
    """reduced granite-3-2b, 2 layers: prefill is 7 GEMMs and one attention
    a layer plus the head; each decode step qkv + fused attention/back half
    a layer (ring <= 128) or qkv + attention + back half, plus the head;
    tokens and logits bitwise equal to amsim_torch."""
    cfg = reduced(get_arch("granite-3-2b"), n_layers=2)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    prompts = torch.randint(0, cfg.vocab, (2, 5), generator=torch.Generator().manual_seed(1))
    counters = (decode_chain.fused_qkv_norm, approx_attention.approx_attention,
                decode_chain.fused_out_mlp, decode_chain.fused_attn_out_mlp,
                approx_gemm.approx_gemm)
    for fn in counters:
        fn.launches = 0
    out, logits = _serve(model, "amsim", max_len, prompts)
    torch.cuda.synchronize()
    got = tuple(fn.launches for fn in counters)
    steps = 3
    want = tuple(n * steps for n in per_step)
    want = (want[0], want[1] + 2, want[2], want[3], want[4] + 2 * 7 + 1)
    assert got == want
    ref_out, ref_logits = _serve(model, "amsim_torch", max_len, prompts)
    torch.cuda.synchronize()
    assert torch.equal(out, ref_out) and torch.equal(logits, ref_logits)


def test_amsim_serving_never_reaches_the_plain_versions(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version reached on a CUDA tensor")

    for module, names in ((decode_chain, ("fused_qkv_norm_plain", "fused_out_mlp_plain",
                                          "fused_attn_out_mlp_plain")),
                          (approx_attention, ("approx_attention_plain",)),
                          (approx_gemm, ("approx_gemm_plain",)),
                          (ops, ("fused_qkv_norm_plain", "fused_out_mlp_plain",
                                 "fused_attn_out_mlp_plain", "attend_einsum"))):
        for name in names:
            monkeypatch.setattr(module, name, refuse)
    cfg = reduced(get_arch("granite-3-2b"), n_layers=1)
    model = init_lm(cfg, device=cuda)
    prompts = torch.randint(0, cfg.vocab, (2, 5), generator=torch.Generator().manual_seed(1))
    for max_len in (16, 136):
        out, _ = _serve(model, "amsim", max_len, prompts)
        torch.cuda.synchronize()
        assert out.shape == (2, 4)


# ------------------------------------- per-row positions (the paged cache)
def _paged_positions(S, T, starts, live, device):
    """Positions of a paged batch: row b's queries at starts[b] .. + S - 1,
    its keys valid below starts[b] + S when the row is live, every key
    unwritten (POS_PAD) when it is dead."""
    starts, live = np.asarray(starts), np.asarray(live, bool)
    q = starts[:, None] + np.arange(S)[None]
    t = np.arange(T)[None]
    k = np.where(live[:, None] & (t < (starts + S)[:, None]), t, POS_PAD)
    return (torch.tensor(q, dtype=torch.int32, device=device),
            torch.tensor(k, dtype=torch.int32, device=device))


# (B, S, H, KV, dh, T, starts, live, window): granite-3-2b decode ticks of 8
# slots over a table of 19 pages of 16 (Tcap 304, the 3-launch form) and of 8
# (128, the 2-launch form), with dead slots; a paged prefill of a 256-token
# bucket at start 0 (its rows past a prompt's true length are computed too);
# G = 3 rows under a sliding window.
PAGED_CASES = [
    (8, 1, 32, 8, 64, 304, [0, 17, 100, 250, 303, 5, 60, 0], [1, 1, 1, 1, 1, 1, 1, 0], 0),
    (8, 1, 32, 8, 64, 128, [3, 40, 127, 0, 64, 90, 11, 0], [1, 1, 1, 0, 1, 1, 1, 0], 0),
    (1, 256, 32, 8, 64, 304, [0], [1], 0),
    (3, 5, 6, 3, 48, 70, [3, 30, 60], [1, 0, 1], 8),
]
PAGED_LUTS = [("afm16", True), ("afm10", True), ("fp16xbf16", True), (FAULTED, True)]


def _paged_inputs(case, rng, device, special=True):
    """q, k, v, q_pos (B, S), k_pos (B, T), and the keyword arguments; with
    ``special``, inf, -inf and NaN in the K and V of every key a row may
    not read (released pages keep old contents, the trash page takes every
    masked write)."""
    B, S, H, KV, dh, T, starts, live, window = case
    q_pos, k_pos = _paged_positions(S, T, starts, live, device)
    q, k, v = (_randn(rng, (B, S, H, dh), device), _randn(rng, (B, T, KV, dh), device),
               _randn(rng, (B, T, KV, dh), device))
    if special:
        bad = (k_pos < 0)[:, :, None, None].expand_as(k)
        for a in (k, v):
            pick = torch.from_numpy(rng.integers(0, 3, a.shape)).to(device)
            for i, value in enumerate((float("inf"), -float("inf"), float("nan"))):
                a[:] = torch.where(bad & (pick == i), value, a)
    return [q, k, v, q_pos, k_pos], dict(causal=True, window=window)


@pytest.mark.parametrize("name,packed", PAGED_LUTS)
@pytest.mark.parametrize("case", range(len(PAGED_CASES)))
def test_attention_kernel_per_row_bitwise_vs_plain(cuda, name, packed, case, rng):
    lut, M = _lut(name, packed, cuda)
    args, kw = _paged_inputs(PAGED_CASES[case], rng, cuda)
    assert _attention_bits(args, kw, lut, M)


@pytest.mark.parametrize("name,packed", PAGED_LUTS)
@pytest.mark.parametrize("T", [128, 304])
def test_attn_out_mlp_kernel_per_row_bitwise_vs_plain(cuda, name, packed, T, rng):
    """granite-3-2b's widths, a decode tick of 8 slots at their own
    positions, one dead, inf and NaN in the keys no row reads."""
    lut, M = _lut(name, packed, cuda)
    case = PAGED_CASES[0] if T == 304 else PAGED_CASES[1]
    args, kw = _paged_inputs(case, rng, cuda)
    o = _chain_inputs((8, 2048, 32, 8, 64, 8192), rng, cuda)
    tail = [o[n] for n in ("g", "wo", "wg", "wu", "wd")]
    out = decode_chain.fused_attn_out_mlp(o["x"], *args, *tail, lut, M, eps=1e-5, **kw)
    ref = decode_chain.fused_attn_out_mlp_plain(o["x"], *args, *tail, lut, M, eps=1e-5, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("name,packed", [("afm16", True), ("afm10", True)])
def test_per_row_positions_that_agree_give_the_shared_bits(cuda, name, packed, rng):
    """Positions repeated across the batch rows give the bits of the one
    shared vector, in the attention kernel and in fused_attn_out_mlp."""
    lut, M = _lut(name, packed, cuda)
    for case in (ATTN_PATH_CASES[0], ATTN_PATH_CASES[1], ATTN_CASES[2]):
        args, kw = _attention_inputs(case, rng, cuda)
        B, S, T = args[0].shape[0], args[0].shape[1], args[1].shape[1]
        rows = [args[3].expand(B, S).contiguous(), args[4].expand(B, T).contiguous()]
        out = approx_attention.approx_attention(*args[:3], *rows, lut, M, **kw)
        ref = approx_attention.approx_attention(*args, lut, M, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    rows_, d, H, KV, dh, F = CHAIN_CASES[1]
    o = _chain_inputs(CHAIN_CASES[1], rng, cuda)
    args, kw = _attention_inputs((rows_, 1, H, KV, dh, 40, [44], _ring(40, 45), True, 0), rng,
                                 cuda)
    tail = [o[n] for n in ("g", "wo", "wg", "wu", "wd")]
    rows = [args[3].expand(rows_, 1).contiguous(), args[4].expand(rows_, 40).contiguous()]
    out = decode_chain.fused_attn_out_mlp(o["x"], *args[:3], *rows, *tail, lut, M, eps=1e-5)
    ref = decode_chain.fused_attn_out_mlp(o["x"], *args, *tail, lut, M, eps=1e-5)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-3b-a800m"])
def test_paged_stream_amsim_matches_amsim_torch(cuda, arch):
    """reduced widths, 2 layers: a ragged two-tier stream through the
    continuous-batching engine gives the same tokens under
    ``cheap=amsim:afm16`` (the kernels, per-row positions) and
    ``cheap=amsim_torch:afm16`` (their plain versions), with preemption;
    the cheap lane's decode ticks launched the chain's kernels."""
    from repro_torch.serve.scheduler import ContinuousBatchingEngine
    cfg = reduced(get_arch(arch), n_layers=2)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    rng = np.random.default_rng(3)
    stream = [(i, rng.integers(1, cfg.vocab, size=int(rng.integers(3, 20))).tolist(), 8,
               ("cheap", "exact")[i % 2]) for i in range(8)]
    outs = []
    for mode in ("amsim", "amsim_torch"):
        decode_chain.fused_qkv_norm.launches = 0
        tiers = {"exact": NumericsPolicy(), "cheap": NumericsPolicy(mode=mode,
                                                                    multiplier="afm16")}
        eng = ContinuousBatchingEngine(model, tiers, max_len=40, capacity=3, page_size=4,
                                       n_pages=12)
        eng.run(stream)
        outs.append({rid: (r.out, r.status, r.preemptions) for rid, r in eng.finished.items()})
        if mode == "amsim":
            assert decode_chain.fused_qkv_norm.launches == 2 * eng.decode_ticks["cheap"] > 0
            assert sum(r.preemptions for r in eng.finished.values()) > 0
    assert outs[0] == outs[1]


@pytest.mark.parametrize("shape", [(8, 2048), (256, 8192), (4, 7, 100), (1, 32), (3, 33)])
def test_lane_sum_scan_is_the_loop(cuda, shape, rng):
    """``lane_sum`` on a CUDA tensor takes each lane's sum with one
    ``torch.cumsum`` over the lane-strided rows, on the premise that the
    scan adds each column in order from +0.0 in float32.  It must give the
    bits of the plain loop (``lanes + x[..., j:j + 32]``), which is the
    order of the kernels' warp sums; values span 2^-40 .. 2^40 so that any
    other order rounds differently."""
    x = _randn(rng, shape, cuda) * torch.exp2(
        torch.from_numpy(rng.integers(-40, 41, shape)).to(cuda, torch.float32))
    n = shape[-1]
    xp = torch.nn.functional.pad(x, (0, (-n) % LANES))
    lanes = torch.zeros((*shape[:-1], LANES), dtype=torch.float32, device=cuda)
    for j in range(0, xp.shape[-1], LANES):
        lanes = lanes + xp[..., j:j + LANES]
    off = LANES // 2
    while off:
        lanes = lanes[..., :off] + lanes[..., off:2 * off]
        off //= 2
    assert torch.equal(lane_sum(x).view(torch.int32), lanes[..., 0].view(torch.int32))


def test_full_width_moe_stream_repeats_its_tokens(cuda):
    """granite-moe-3b-a800m at full width, 2 layers, a ragged stream on one
    amsim:afm16 lane of 4 slots (dead slots on most ticks; prompts whose
    bucket runs past their pages) in a pool small enough to preempt, run
    twice without deterministic algorithms: the same tokens, statuses and
    preemptions, and every pool's trash page still zero (the writes that
    collide there all carry zeros, so dead rows, which take expert
    capacity, read the same keys on every run)."""
    from repro_torch.serve.scheduler import ContinuousBatchingEngine
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m"), n_layers=2)
    model = init_lm(cfg, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    rng = np.random.default_rng(4)
    stream = [(i, rng.integers(1, cfg.vocab, size=int(rng.integers(17, 100))).tolist(), 12,
               "default") for i in range(8)]
    outs = []
    for _ in range(2):
        eng = ContinuousBatchingEngine(model, NumericsPolicy(mode="amsim", multiplier="afm16"),
                                       max_len=112, capacity=4, page_size=16, n_pages=12)
        eng.run(stream)
        outs.append({rid: (r.out, r.status, r.preemptions) for rid, r in eng.finished.items()})
        assert all(r.status == "ok" for r in eng.finished.values())
        for layer in eng._lanes["default"].caches:
            assert not layer["pool_k"][0].any() and not layer["pool_v"][0].any()
    assert sum(o[2] for o in outs[0].values()) > 0
    assert outs[0] == outs[1]


# --------------------------------------------------------------- LM training
def lm_train_launches(cfg) -> dict:
    """Kernel launches of one LM training step under ``amsim`` with remat:
    a dense layer's 7 GEMMs forward, again in the recompute, and 14 in
    the backward (dx and dw), its attention forward and recompute, and 6
    batched GEMMs for the attention backward (the einsums' recompute and
    both operands' gradients); an MoE layer's 5 GEMMs (wq/wk/wv/wo/router)
    likewise, its expert banks forward and recompute, and 9 batched GEMMs
    for the banks' backward (3 recomputed, 6 gradients); the tied head's
    3 GEMMs."""
    L = cfg.n_layers
    if cfg.moe is None:
        return {"approx_gemm": 28 * L + 3, "approx_gemm_batched": 6 * L,
                "approx_attention": 2 * L}
    return {"approx_gemm": 20 * L + 3, "approx_gemm_batched": 15 * L,
            "approx_attention": 2 * L, "fused_moe_ffn": 2 * L}


def _lm_train(cfg, policy, device, steps=2):
    """``steps`` steps from seed-0 weights; then the gradient of the loss
    at the next batch.  Returns (losses, launches per step, model, grads)."""
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device=device)
    opt, step = make_lm_train_step(cfg, policy, lr=3e-4, steps=3)
    state = opt.init(dict(model.named_parameters()))
    counters = {"approx_gemm": approx_gemm.approx_gemm,
                "approx_gemm_batched": approx_gemm.approx_gemm_batched,
                "approx_attention": approx_attention.approx_attention,
                "fused_moe_ffn": decode_chain.fused_moe_ffn}
    losses, launches = [], []
    for i in range(steps):
        for fn in counters.values():
            fn.launches = 0
        state, metrics = step(model, state, lm_batch(cfg, (2, 16), i, device))
        losses.append(metrics["loss"])
        launches.append({k: fn.launches for k, fn in counters.items() if fn.launches})
    loss, _ = lm_loss(model, lm_batch(cfg, (2, 16), steps, device), policy)
    return losses, launches, model, torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-3b-a800m"])
def test_lm_train_steps_run_through_the_kernels_bitwise(cuda, arch):
    """Two adamw steps of the reduced LM at depth 2 under ``amsim``: the
    launches of ``lm_train_launches`` each step, and losses, parameters and
    the next gradient bitwise equal to ``amsim_torch`` (deterministic
    algorithms: the embedding's and the MoE gather's backward scatters
    would add in no fixed order without them)."""
    cfg = dataclasses.replace(reduced(get_arch(arch)), n_layers=2)
    torch.use_deterministic_algorithms(True)
    try:
        runs = {mode: _lm_train(cfg, NumericsPolicy(mode=mode, multiplier="afm16"), cuda)
                for mode in ("amsim", "amsim_torch")}
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    (losses, launches, model, grads), (r_losses, r_launches, ref, r_grads) = (
        runs["amsim"], runs["amsim_torch"])
    assert launches == [lm_train_launches(cfg)] * 2 and r_launches == [{}, {}]
    assert all(bool(torch.isfinite(v)) for v in losses)
    for a, b in zip(losses, r_losses):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip([*model.parameters(), *grads], [*ref.parameters(), *r_grads]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# --------------------------------------------------------------- MoE serving
# (batch, m, k, n): ragged shapes, then granite-moe-3b-a800m's expert banks
# at C = 512 (the batched route) with one shared- and one global-memory table.
BATCHED_CASES = [(3, 67, 130, 33), (2, 1, 5, 1), (40, 8, 40, 17)]
BATCHED_FULL = [(40, 512, 1536, 512), (40, 512, 512, 1536)]
FULL_LUTS = [("afm16", True), ("afm10", True)]


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("B,m,k,n", BATCHED_CASES)
def test_batched_gemm_kernel_bitwise_vs_plain(cuda, name, packed, B, m, k, n, rng):
    lut, M = _lut(name, packed, cuda)
    a, b = _randn(rng, (B, m, k), cuda), _randn(rng, (B, k, n), cuda)
    out = approx_gemm.approx_gemm_batched(a, b, lut, M)
    ref = approx_gemm.approx_gemm_batched_plain(a, b, lut, M)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("name,packed", FULL_LUTS)
@pytest.mark.parametrize("B,m,k,n", BATCHED_FULL)
def test_batched_gemm_kernel_bitwise_vs_plain_at_full_width(cuda, name, packed, B, m, k, n, rng):
    lut, M = _lut(name, packed, cuda)
    a, b = _randn(rng, (B, m, k), cuda), _randn(rng, (B, k, n), cuda) * k ** -0.5
    out = approx_gemm.approx_gemm_batched(a, b, lut, M)
    ref = approx_gemm.approx_gemm_batched_plain(a, b, lut, M)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


# The GEMM kernel's two paths.  First each shape with the plan a launch
# takes (gemm_plan): m on both sides of the small-m threshold, the router's
# 40 columns, a ragged wide n, k off the 16-step slab and the 256-step
# chunk, m and n one off the tiled path's 64x64 and 32x64 tiles, and
# granite-3-2b's gate/up projection at prefill.  Then every tile shape of
# each path, forced, at its edges and at a batch of more tiles than the
# card holds blocks (each block walks several).
GEMM_PLANNED = [(1, 300, 70), (4, 1000, 300), (8, 500, 300), (9, 500, 300), (4, 1536, 40),
                (4, 2048, 4099), (65, 37, 8193), (63, 64, 8257), (129, 100, 4161)]
GEMM_FORCED = [("tiled", 8, 2), ("tiled", 4, 2), ("tiled", 2, 1), ("tiled", 1, 1),
               ("column", 1, 128), ("column", 2, 64), ("column", 4, 32), ("column", 8, 16)]
# (name, packed, expand): the table forms a plan can choose; expand False
# keeps a packed table packed at every k.
GEMM_TABLES = [("afm16", True, True), ("afm16", True, False), ("afm16", False, True),
               ("mitchell8", True, True), ("mitchell8", False, True), ("afm10", True, True),
               ("afm10", False, True)]


def _expand(monkeypatch, expand):
    """Expand a packed table that fits twice at every k, or at none."""
    monkeypatch.setattr(approx_gemm, "EXPAND_MIN_K", 0 if expand else 1 << 62)


def _gemm_bits(a, b, lut, M):
    out = (approx_gemm.approx_gemm(a, b, lut, M) if a.ndim == 2
           else approx_gemm.approx_gemm_batched(a, b, lut, M))
    ref = (approx_gemm.approx_gemm_plain(a, b, lut, M) if a.ndim == 2
           else approx_gemm.approx_gemm_batched_plain(a, b, lut, M))
    torch.cuda.synchronize()
    return _same_bits(out, ref)


@pytest.mark.parametrize("name,packed,expand", GEMM_TABLES)
@pytest.mark.parametrize("m,k,n", GEMM_PLANNED)
def test_gemm_kernel_bitwise_vs_plain_at_planned_shapes(cuda, monkeypatch, name, packed, expand,
                                                        m, k, n, rng):
    _expand(monkeypatch, expand)
    lut, M = _lut(name, packed, cuda)
    a, b = _randn(rng, (m, k), cuda), _randn(rng, (k, n), cuda)
    assert _gemm_bits(a, b, lut, M)


@pytest.mark.parametrize("name,packed,expand", GEMM_TABLES)
@pytest.mark.parametrize("path,rows,cols", GEMM_FORCED)
def test_gemm_kernel_bitwise_vs_plain_on_every_tile_shape(cuda, monkeypatch, name, packed,
                                                          expand, path, rows, cols, rng):
    import dataclasses
    _expand(monkeypatch, expand)
    lut, M = _lut(name, packed, cuda)
    plan_of = approx_gemm.gemm_plan
    bm, bn = (8 * rows, 32 * cols) if path == "tiled" else (rows, cols)

    def forced(batch, m, k, n, lut_, sms):
        return dataclasses.replace(plan_of(batch, m, k, n, lut_, sms),
                                   path=path, rows=rows, cols=cols, tile=(bm, bn))

    monkeypatch.setattr(approx_gemm, "gemm_plan", forced)
    # one off the tile each way, k off the slab and across a 256-step chunk
    shapes = [(bm + 1, 37, bn - 1), (max(1, bm - 1), 300, 2 * bn + 1), (2 * bm, 16, bn),
              (3 * bm + 5, 1, 33), (17, 260, 40)]
    for m, k, n in shapes:
        a, b = _randn(rng, (m, k), cuda), _randn(rng, (k, n), cuda)
        assert _gemm_bits(a, b, lut, M), (m, k, n)
        ab, bb = _randn(rng, (3, m, k), cuda), _randn(rng, (3, k, n), cuda)
        assert _gemm_bits(ab, bb, lut, M), (3, m, k, n)
    # 3 x 40 x 40 tiles, more than the card holds blocks of this kernel
    m, n = 39 * bm + 1, 39 * bn + 1
    grid = approx_gemm.gemm_grid(forced(3, m, 5, n, lut, 0), 3, m, n, lut)
    assert grid["tiles"] == 3 * 40 * 40 and grid["blocks"] < grid["tiles"], grid
    ab, bb = _randn(rng, (3, m, 5), cuda), _randn(rng, (3, 5, n), cuda)
    assert _gemm_bits(ab, bb, lut, M), (3, m, 5, n)


@pytest.mark.parametrize("name,packed", FULL_LUTS)
def test_gemm_kernel_bitwise_vs_plain_at_the_prefill_shape(cuda, name, packed, rng):
    """granite-3-2b's gate/up projection at a prefill of 4 x 64 tokens."""
    lut, M = _lut(name, packed, cuda)
    a, b = _randn(rng, (256, 2048), cuda), _randn(rng, (2048, 8192), cuda) * 2048 ** -0.5
    assert _gemm_bits(a, b, lut, M)


def _dead_tail_rows(B, m, k, n, rng, device):
    """Capacity buffers as moe_ffn scatters them: each expert's live rows
    first, then dead rows (+0.0, -0.0 and subnormal in turn); expert 1
    wholly dead with inf and NaN in its B."""
    a, b = _randn(rng, (B, m, k), device), _randn(rng, (B, k, n), device) * k ** -0.5
    fill = torch.from_numpy((rng.standard_normal((m, k)) * 1e-39).astype(np.float32)).to(device)
    fill[0::3], fill[1::3] = 0.0, -0.0
    for e, live in enumerate(rng.integers(0, m, size=B)):
        a[e, live:] = fill[live:]
    a[1] = fill
    b[1, ::3], b[1, 1::3], b[1, 2::3] = float("inf"), float("nan"), -float("inf")
    return a, b


@pytest.mark.parametrize("name,packed,expand", GEMM_TABLES)
@pytest.mark.parametrize("B,m,k,n", [(5, 70, 130, 90), (4, 200, 64, 300), (3, 8, 40, 17)])
def test_batched_gemm_kernel_bitwise_vs_plain_with_dead_tail_rows(cuda, monkeypatch, name,
                                                                  packed, expand, B, m, k, n,
                                                                  rng):
    _expand(monkeypatch, expand)
    lut, M = _lut(name, packed, cuda)
    a, b = _dead_tail_rows(B, m, k, n, rng, cuda)
    out = approx_gemm.approx_gemm_batched(a, b, lut, M)
    assert _gemm_bits(a, b, lut, M)
    dead = ~((a.view(torch.int32) >> 23) & 0xFF).bool().any(dim=-1)
    assert bool(dead.any()) and int((out[dead].view(torch.int32) != 0).sum()) == 0


@pytest.mark.parametrize("name,packed", FULL_LUTS)
def test_batched_gemm_kernel_bitwise_vs_plain_at_full_width_with_dead_tail_rows(cuda, name,
                                                                               packed, rng):
    """granite-moe-3b-a800m's gate bank at capacity 512 with dead tails."""
    lut, M = _lut(name, packed, cuda)
    a, b = _dead_tail_rows(40, 512, 1536, 512, rng, cuda)
    plan = approx_gemm.gemm_plan(40, 512, 1536, 512, lut,
                                 torch.cuda.get_device_properties(cuda).multi_processor_count)
    live, total = approx_gemm.live_row_tiles(a, plan)
    assert 0 < live < total
    assert _gemm_bits(a, b, lut, M)


@pytest.mark.parametrize("name,packed", FULL_LUTS)
def test_gemm_grid_keeps_busy_every_sm_the_old_grid_did(cuda, name, packed):
    """The grid as the C launch sizes it: at least min(the 16x16 grid's
    blocks, the SMs) blocks and no more than the plan's tiles, at the
    vision models' fc shapes (forward, dx, dw) and at granite-3-2b's and
    granite-moe-3b-a800m's serving shapes."""
    lut, _ = _lut(name, packed, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    dense, moe_cfg = get_arch("granite-3-2b"), get_arch("granite-moe-3b-a800m")
    shapes = []
    for m, k, n in ((64, 784, 120), (64, 120, 84), (64, 84, 10), (64, 784, 300),
                    (64, 300, 100), (64, 64, 10)):
        shapes += [(1, m, k, n), (1, m, n, k), (1, k, m, n)]
    d, F = dense.d_model, dense.d_ff
    for rows in (4, 32, 256):
        shapes += [(1, rows, d, n) for n in (dense.n_heads * dense.head_dim,
                                             dense.n_kv_heads * dense.head_dim, F, dense.vocab)]
        shapes.append((1, rows, F, d))
    dm, E = moe_cfg.d_model, moe_cfg.moe.n_experts
    shapes += [(1, 4, dm, E), (1, 2048, dm, E), (E, 512, dm, moe_cfg.moe.d_ff),
               (E, 512, moe_cfg.moe.d_ff, dm)]
    for batch, m, k, n in shapes:
        plan = approx_gemm.gemm_plan(batch, m, k, n, lut, sms)
        grid = approx_gemm.gemm_grid(plan, batch, m, n, lut)
        assert grid["tiles"] == plan.tiles, (batch, m, k, n, plan, grid)
        assert min(plan.old_blocks, sms) <= grid["blocks"] <= plan.tiles, (batch, m, k, n, plan,
                                                                           grid)


# (rows, d, K): two k-tiles and two column tiles at 160/300, two row groups
# at 9 rows; four row groups at 32 rows, with d and K multiples of neither 8
# nor the wo phase's k-chunk (128 steps); then granite-moe-3b-a800m's wo at
# 4 rows.
WO_NORM_CASES = [(1, 160, 300), (3, 300, 160), (9, 160, 300), (32, 1539, 1027)]


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("rows,d,K", WO_NORM_CASES)
def test_wo_norm_kernel_bitwise_vs_plain(cuda, name, packed, rows, d, K, rng):
    lut, M = _lut(name, packed, cuda)
    x, attn = _randn(rng, (rows, d), cuda), _randn(rng, (rows, K), cuda)
    g2, wo = 1 + 0.1 * _randn(rng, (d,), cuda), _randn(rng, (K, d), cuda) * K ** -0.5
    for bias in ({}, {"bo": 0.1 * _randn(rng, (d,), cuda)}):
        out = decode_chain.fused_wo_norm(x, attn, g2, wo, lut, M, eps=1e-5, **bias)
        ref = decode_chain.fused_wo_norm_plain(x, attn, g2, wo, lut, M, eps=1e-5, **bias)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("name,packed", FULL_LUTS)
def test_wo_norm_kernel_bitwise_vs_plain_at_full_width(cuda, name, packed, rng):
    lut, M = _lut(name, packed, cuda)
    cfg = get_arch("granite-moe-3b-a800m")
    d, K = cfg.d_model, cfg.n_heads * cfg.head_dim
    x, attn = _randn(rng, (4, d), cuda), _randn(rng, (4, K), cuda)
    g2, wo = 1 + 0.1 * _randn(rng, (d,), cuda), _randn(rng, (K, d), cuda) * K ** -0.5
    for bias in ({}, {"bo": 0.1 * _randn(rng, (d,), cuda)}):
        out = decode_chain.fused_wo_norm(x, attn, g2, wo, lut, M, eps=1e-5, **bias)
        ref = decode_chain.fused_wo_norm_plain(x, attn, g2, wo, lut, M, eps=1e-5, **bias)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("name,packed", FULL_LUTS)
def test_wo_norm_grid_covers_every_sm(cuda, name, packed):
    """granite-moe-3b-a800m's wo at a decode step's 4 rows: 192 items (d =
    1536 in column tiles of 8) and a block on every SM; at 32 rows four row
    groups of them; at 300 rows of d = 8 a block a row for the norm."""
    lut, _ = _lut(name, packed, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for rows in (4, 32):
        g = decode_chain.wo_norm_grid(rows, 1536, lut)
        assert g["items"] == 192 * (rows // 8 or 1)
        assert sms <= g["blocks"] <= g["items"]
    g = decode_chain.wo_norm_grid(300, 8, lut)
    assert g["items"] == 38 and min(sms, 300) <= g["blocks"] <= 300


# (E, C, d, F): ragged shapes with partial k-chunks and column tiles and
# two or three row groups (of 6 rows); then granite-moe-3b-a800m's banks at
# a decode step (C = 8) and a prefill of 4 x 64 tokens (C = 64).
MOE_CASES = [(3, 8, 160, 300), (2, 13, 130, 40), (1, 1, 5, 3)]
MOE_FULL = [(40, 8, 1536, 512), (40, 64, 1536, 512)]


def _moe_inputs(E, C, d, F, rng, device):
    return (_randn(rng, (E, C, d), device), _randn(rng, (E, d, F), device) * d ** -0.5,
            _randn(rng, (E, d, F), device) * d ** -0.5, _randn(rng, (E, F, d), device) * F ** -0.5)


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("E,C,d,F", MOE_CASES)
def test_moe_ffn_kernel_bitwise_vs_plain(cuda, name, packed, E, C, d, F, rng):
    lut, M = _lut(name, packed, cuda)
    args = _moe_inputs(E, C, d, F, rng, cuda)
    out = decode_chain.fused_moe_ffn(*args, lut, M)
    ref = decode_chain.fused_moe_ffn_plain(*args, lut, M)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("name,packed", FULL_LUTS)
@pytest.mark.parametrize("E,C,d,F", MOE_FULL)
def test_moe_ffn_kernel_bitwise_vs_plain_at_full_width(cuda, name, packed, E, C, d, F, rng):
    lut, M = _lut(name, packed, cuda)
    args = _moe_inputs(E, C, d, F, rng, cuda)
    out = decode_chain.fused_moe_ffn(*args, lut, M)
    ref = decode_chain.fused_moe_ffn_plain(*args, lut, M)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _same_bits(a, b):
    """Bitwise equality, which tells +0.0 from -0.0 (torch.equal does not)."""
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


# Capacity buffers with dead rows (every element +-0 or subnormal), at a
# ragged shape (E 3, C 13, d 130, F 40): the kernel computes only the live
# rows and writes +0.0 over the others.
DEAD_ROW_CASES = ["zero", "negative_zero", "subnormal", "between_live_rows",
                  "dead_expert_inf_nan_banks", "all_dead"]


def _dead_row_inputs(case, rng, device):
    h, wg, wu, wd = _moe_inputs(3, 13, 130, 40, rng, device)
    subnormal = torch.from_numpy(
        (rng.standard_normal((13, 130)) * 1e-39).astype(np.float32)).to(device)
    fill = {"zero": torch.zeros_like(subnormal), "negative_zero": -torch.zeros_like(subnormal),
            "subnormal": subnormal}
    if case in fill:
        h[1, ::2] = fill[case][::2]
    elif case == "between_live_rows":
        # expert 0: rows 0, 4, 8, 12 live, the three kinds of dead row
        # between them; expert 2: only its last row live.
        kinds = ("zero", "negative_zero", "subnormal")
        for r in range(13):
            if r % 4:
                h[0, r] = fill[kinds[r % 3]][r]
        h[2, :12] = subnormal[:12]
    elif case == "dead_expert_inf_nan_banks":
        h[1] = -subnormal
        for w in (wg, wu, wd):
            w[1, ::3] = float("inf")
            w[1, 1::3] = float("nan")
            w[1, 2::3] = -float("inf")
    else:
        h[:] = subnormal
        h[:, ::2] = 0.0
    return h, wg, wu, wd


@pytest.mark.parametrize("name,packed", LUTS)
@pytest.mark.parametrize("case", DEAD_ROW_CASES)
def test_moe_ffn_kernel_bitwise_vs_plain_with_dead_rows(cuda, name, packed, case, rng):
    lut, M = _lut(name, packed, cuda)
    args = _dead_row_inputs(case, rng, cuda)
    dead = decode_chain.live_rows(args[0]) < args[0].shape[1]
    assert bool(dead.any())
    out = decode_chain.fused_moe_ffn(*args, lut, M)
    ref = decode_chain.fused_moe_ffn_plain(*args, lut, M)
    torch.cuda.synchronize()
    assert _same_bits(out, ref)
    rows_dead = ~((args[0].view(torch.int32) >> 23) & 0xFF).bool().any(dim=-1)
    assert int((out[rows_dead].view(torch.int32) != 0).sum()) == 0


@torch.no_grad()
@pytest.mark.parametrize("name,packed", FULL_LUTS)
def test_moe_ffn_kernel_bitwise_vs_plain_on_a_routed_decode_buffer(cuda, name, packed, rng):
    """The buffer ``moe.moe_ffn`` scatters at granite-moe-3b-a800m's widths
    for a decode step of 4 tokens (C = 8): 32 live rows of 320, most
    experts empty."""
    lut, M = _lut(name, packed, cuda)
    cfg = get_arch("granite-moe-3b-a800m")
    E, d, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff
    banks = _moe_inputs(E, 1, d, F, rng, cuda)[1:]
    h = time_chain.routed_buffer(cfg, _randn(rng, (d, E), cuda) * d ** -0.5,
                                 _randn(rng, (1, 4, d), cuda),
                                 NumericsPolicy(mode="amsim", multiplier="afm16"))
    live = decode_chain.live_rows(h)
    assert h.shape == (E, 8, d) and int(live.sum()) == 4 * cfg.moe.top_k
    out = decode_chain.fused_moe_ffn(h, *banks, lut, M)
    ref = decode_chain.fused_moe_ffn_plain(h, *banks, lut, M)
    torch.cuda.synchronize()
    assert _same_bits(out, ref)


@pytest.mark.parametrize("name,packed", FULL_LUTS)
@pytest.mark.parametrize("rows", [4, 32])
def test_qkv_kernel_bitwise_vs_plain_at_moe_widths(cuda, name, packed, rows, rng):
    """granite-moe-3b-a800m's q/k/v (d 1536, nq 1536, nk = nv 512) at a
    decode step's 4 rows and at 32 rows (four row groups)."""
    lut, M = _lut(name, packed, cuda)
    o = _chain_inputs((rows, 1536, 24, 8, 64, 512), rng, cuda)
    qkv = [o[n] for n in ("x", "g", "wq", "wk", "wv")]
    out = decode_chain.fused_qkv_norm(*qkv, lut, M, eps=1e-5)
    ref = decode_chain.fused_qkv_norm_plain(*qkv, lut, M, eps=1e-5)
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("name,packed", FULL_LUTS)
def test_qkv_and_moe_grids_cover_every_sm(cuda, name, packed):
    """granite-3-2b's qkv at 4 rows: 384 items (256 q, 64 k, 64 v column
    tiles of 8) and a block on every SM; at 32 rows four row groups of
    them.  granite-moe-3b-a800m's expert banks at C = 8 (two row groups of
    at most 6 an expert): a full buffer has 40 x 2 x 32 gate/up items (16
    columns a tile; 16 tiles of 32 with a global-memory LUT) and 40 x 2 x
    48 down items, a buffer with 1 and 7 live rows in two experts 3 row
    groups' worth, and an empty one none."""
    lut, _ = _lut(name, packed, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for rows in (4, 32):
        g = decode_chain.qkv_grid(rows, 2048, 512, 512, lut)
        assert g["items"] == 384 * (rows // 8 or 1)
        assert sms <= g["blocks"] <= g["items"]
    gate_up_tiles = 32 if lut_in_smem(lut) else 16
    full = decode_chain.moe_ffn_grid(40, 8, 1536, 512, lut)
    assert (full["gate_up"], full["down"]) == (80 * gate_up_tiles, 80 * 48)
    assert sms <= full["blocks"] <= 80 * 48
    some = decode_chain.moe_ffn_grid(40, 8, 1536, 512, lut, live=[1, 7] + [0] * 38)
    assert (some["gate_up"], some["down"]) == (3 * gate_up_tiles, 3 * 48)
    assert decode_chain.moe_ffn_grid(40, 8, 1536, 512, lut, live=[0] * 40)["down"] == 0


MOE_COUNTERS = (approx_gemm.approx_gemm, approx_gemm.approx_gemm_batched,
                approx_attention.approx_attention, decode_chain.fused_qkv_norm,
                decode_chain.fused_wo_norm, decode_chain.fused_moe_ffn)


@pytest.mark.parametrize("max_c", [ops.MOE_FFN_MAX_C, 0])
def test_moe_serving_runs_through_the_kernels_bitwise(cuda, monkeypatch, max_c):
    """reduced granite-moe-3b-a800m, 2 layers: the prefill is 5 GEMMs
    (wq, wk, wv, wo, router), one attention and the expert-bank launch a
    layer (or, with the capacity bound at 0, three batched GEMMs a layer)
    plus the head; each decode step qkv, attention, wo+norm, the router
    GEMM and the expert-bank launch a layer plus the head; tokens and
    logits bitwise equal to amsim_torch."""
    monkeypatch.setattr(ops, "MOE_FFN_MAX_C", max_c)
    cfg = reduced(get_arch("granite-moe-3b-a800m"), n_layers=2)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    prompts = torch.randint(0, cfg.vocab, (2, 5), generator=torch.Generator().manual_seed(1))
    for fn in MOE_COUNTERS:
        fn.launches = 0
    out, logits = _serve(model, "amsim", 16, prompts)
    torch.cuda.synchronize()
    got = tuple(fn.launches for fn in MOE_COUNTERS)
    L, steps = cfg.n_layers, 3
    batched = max_c == 0
    banks = L * (1 + steps)        # expert FFNs: one a layer, prefill and every step
    want = (5 * L + 1 + (L + 1) * steps, 3 * banks if batched else 0, L * (1 + steps),
            L * steps, L * steps, 0 if batched else banks)
    assert got == want
    ref_out, ref_logits = _serve(model, "amsim_torch", 16, prompts)
    torch.cuda.synchronize()
    assert torch.equal(out, ref_out) and torch.equal(logits, ref_logits)


@torch.no_grad()
def test_tied_router_routes_alike_under_amsim_and_amsim_torch(cuda, rng):
    """Router weights of zero tie every probability: under amsim and
    amsim_torch every token picks experts 0 .. k-1 (the lower index first,
    as jax.lax.top_k), and moe_ffn gives the same bits."""
    cfg = reduced(get_arch("granite-moe-3b-a800m"), n_layers=1)
    E, d, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff
    banks = {n: Linear(_randn(rng, shape, cuda) * shape[1] ** -0.5)
             for n, shape in (("wg", (E, d, F)), ("wu", (E, d, F)), ("wd", (E, F, d)))}
    p = torch.nn.ModuleDict({"router": Linear(torch.zeros(d, E, device=cuda)),
                             "experts": torch.nn.ModuleDict(banks)})
    x = _randn(rng, (2, 8, d), cuda)
    results = {}
    for mode in ("amsim", "amsim_torch"):
        policy = NumericsPolicy(mode=mode, multiplier="afm16")
        _, _, sel = moe.route(p["router"], x.reshape(-1, d), cfg, policy)
        assert torch.equal(sel.cpu(), torch.arange(cfg.moe.top_k).expand(16, -1))
        results[mode] = moe.moe_ffn(p, x, cfg, policy)
    torch.cuda.synchronize()
    (y, aux), (y_ref, aux_ref) = results["amsim"], results["amsim_torch"]
    assert torch.equal(y, y_ref) and torch.equal(aux, aux_ref)


def test_amsim_moe_serving_never_reaches_the_plain_versions(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version reached on a CUDA tensor")

    for module, names in ((decode_chain, ("fused_qkv_norm_plain", "fused_wo_norm_plain",
                                          "fused_moe_ffn_plain")),
                          (approx_attention, ("approx_attention_plain",)),
                          (approx_gemm, ("approx_gemm_plain", "approx_gemm_batched_plain")),
                          (ops, ("fused_qkv_norm_plain", "fused_wo_norm_plain",
                                 "fused_moe_ffn_plain", "attend_einsum", "ref_amsim_gemm"))):
        for name in names:
            monkeypatch.setattr(module, name, refuse)
    cfg = reduced(get_arch("granite-moe-3b-a800m"), n_layers=1)
    model = init_lm(cfg, device=cuda)
    prompts = torch.randint(0, cfg.vocab, (2, 5), generator=torch.Generator().manual_seed(1))
    for max_c in (ops.MOE_FFN_MAX_C, 0):
        monkeypatch.setattr(ops, "MOE_FFN_MAX_C", max_c)
        out, _ = _serve(model, "amsim", 16, prompts)
        torch.cuda.synchronize()
        assert out.shape == (2, 4)


# ------------------------------------------------- the numerics surface
def test_faulted_and_clean_tables_differ():
    """The faulted case of LUTS is a different table from afm16's."""
    clean, _ = _lut("afm16", True, "cpu")
    faulted, _ = _lut(FAULTED, True, "cpu")
    assert not torch.equal(clean, faulted)


@pytest.mark.parametrize("mult", ["fp16xbf16", "bf16xfp16"])
def test_cross_format_ops_run_the_kernels_never_the_plain_versions(cuda, monkeypatch, mult, rng):
    """A cross-format table on the card runs the CUDA kernels (the
    counters show it), forward and backward, and never a plain version."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version reached on a CUDA tensor")

    monkeypatch.setattr(approx_gemm, "approx_gemm_plain", refuse)
    monkeypatch.setattr(approx_conv, "approx_conv2d_plain", refuse)
    monkeypatch.setattr(approx_conv, "approx_conv2d_dw_plain", refuse)
    pol = NumericsPolicy(mode="amsim", multiplier=mult)
    counters = (approx_conv.approx_conv2d_fused, approx_conv.approx_conv2d_dw,
                approx_gemm.approx_gemm)
    before = [fn.launches for fn in counters]
    x = _randn(rng, (2, 8, 8, 3), cuda).requires_grad_()
    w = _randn(rng, (3, 3, 3, 4), cuda).requires_grad_()
    ops.approx_conv2d(x, w, 1, "SAME", pol).sum().backward()
    a = _randn(rng, (5, 3), cuda).requires_grad_()
    ops.policy_matmul(a, _randn(rng, (3, 4), cuda).requires_grad_(), pol).sum().backward()
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [2, 1, 3]


def test_lut_cache_keys_on_the_fault_spec_on_the_card(cuda, monkeypatch):
    """On the card as on the CPU: a fresh tensor when the spec changes, the
    very same tensor with faults off, one upload a key."""
    monkeypatch.setattr(ops, "_LUTS", {})
    monkeypatch.setattr(ops, "lut_uploads", {})
    mult = get_multiplier("afm16")
    clean = ops._amsim_lut(mult, cuda)
    with faults.inject("bitflip:rate=1e-3,seed=0"):
        faulted = ops._amsim_lut(mult, cuda)
        assert ops._amsim_lut(mult, cuda) is faulted
    assert ops._amsim_lut(mult, cuda) is clean and faulted is not clean
    assert not torch.equal(clean, faulted) and faulted.is_cuda
    ref, _ = _lut(FAULTED, True, cuda)
    assert torch.equal(faulted, ref)
    assert sorted(ops.lut_uploads.values()) == [1, 1]


@pytest.mark.parametrize("spec", ["qkv=mitchell8,attn_score=bf16,dw=native,default=afm16",
                                  "default=fp16xbf16"])
def test_sweep_point_bitwise_amsim_vs_amsim_torch(cuda, spec):
    """A depth-2 sweep point (reduced widths, 2 adamw steps) under the table
    in ``amsim`` and in ``amsim_torch``: the same losses bit for bit, one
    step built each, and the kernels launched under ``amsim`` only."""
    from repro_torch.launch import sweep
    cfg = dataclasses.replace(reduced(get_arch("granite-3-2b")), n_layers=2)
    counters = (approx_gemm.approx_gemm, approx_gemm.approx_gemm_batched)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("amsim", "amsim_torch"):
            before = [fn.launches for fn in counters]
            res = sweep.run_point(cfg, table_from_assignments(spec, default_mode=mode), steps=2,
                                  batch=2, seq=16, device=cuda)
            torch.cuda.synchronize()
            runs[mode] = (res, [fn.launches - b for fn, b in zip(counters, before)])
    finally:
        torch.use_deterministic_algorithms(False)
    (a, launched), (b, r_launched) = runs["amsim"], runs["amsim_torch"]
    assert a["losses"] == b["losses"] and a["traces"] == b["traces"] == 1
    assert all(n > 0 for n in launched) and r_launched == [0, 0]


def test_faulted_vision_point_bitwise_amsim_vs_amsim_torch(cuda):
    """A faulted LeNet-5 point of the fault campaign (conv, dw and GEMM
    kernels) trains to the same losses and test accuracy under ``amsim``
    (the packed table) as under ``amsim_torch`` (the canonical one)."""
    from repro_torch.launch import faultsweep
    problem = faultsweep.vision_problem(VISION_REGISTRY["lenet-5"], batch=32, lr=0.05, seed=0,
                                        device=cuda, n_train=128, n_test=64)
    spec = faults.FaultSpec(kind="bitflip", rate=1e-3, seed=0)
    torch.use_deterministic_algorithms(True)
    try:
        a, b = (faultsweep.run_fault_point(problem, NumericsPolicy(mode=m, multiplier="afm16"),
                                           spec, steps=2) for m in ("amsim", "amsim_torch"))
    finally:
        torch.use_deterministic_algorithms(False)
    assert a["losses"] == b["losses"] and a["test_acc"] == b["test_acc"]


# --------------------------------------------------------------- SSM families
# The GEMM kernel at the SSM paths' new widths: mamba2-780m's in_proj (1536
# -> 6448) and out_proj (3072 -> 1536), zamba2-1.2b's (2048 -> 8384, 4096 ->
# 2048), at a prefill's 4 x 64 rows and a decode step's 4; the tied head
# over vocab 50280 and zamba2's over 32000 at 4 rows.
SSM_GEMM_SHAPES = [(256, 1536, 6448), (4, 1536, 6448), (256, 3072, 1536), (256, 2048, 8384),
                   (4, 2048, 8384), (256, 4096, 2048), (4, 1536, 50280), (4, 2048, 32000)]
# The SSD products of a 1 x 256 chunk, (batch, m, k, n): scores, intra-chunk
# values (a batch a head), chunk states and inter-chunk output, mamba2 (48
# heads of 64, N 128) then zamba2 (64 heads, N 64).
SSM_BATCHED_SHAPES = [(1, 256, 128, 256), (48, 256, 256, 64), (1, 128, 256, 3072),
                      (1, 256, 128, 3072), (64, 256, 256, 64), (1, 64, 256, 4096),
                      (1, 256, 64, 4096)]


@pytest.mark.parametrize("name,packed", FULL_LUTS)
@pytest.mark.parametrize("m,k,n", SSM_GEMM_SHAPES)
def test_gemm_kernel_bitwise_vs_plain_at_ssm_shapes(cuda, name, packed, m, k, n, rng):
    lut, M = _lut(name, packed, cuda)
    a, b = _randn(rng, (m, k), cuda), _randn(rng, (k, n), cuda) * k ** -0.5
    out = approx_gemm.approx_gemm(a, b, lut, M)
    ref = approx_gemm.approx_gemm_plain(a, b, lut, M)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("name,packed", FULL_LUTS)
@pytest.mark.parametrize("B,m,k,n", SSM_BATCHED_SHAPES)
def test_batched_gemm_kernel_bitwise_vs_plain_at_ssd_shapes(cuda, name, packed, B, m, k, n,
                                                           rng):
    lut, M = _lut(name, packed, cuda)
    a, b = _randn(rng, (B, m, k), cuda), _randn(rng, (B, k, n), cuda) * k ** -0.5
    out = approx_gemm.approx_gemm_batched(a, b, lut, M)
    ref = approx_gemm.approx_gemm_batched_plain(a, b, lut, M)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


# zamba2's shared attention: 32 heads over 32 kv heads (G = 1), dh 64: a
# prefill of 2 x 16 into a ring of 24, the same prefill into a ring of 8
# (its window cut to 8: the early rows see no valid key), and a decode step
# over the wrapped ring of 8 and over 96 slots.
SSM_ATTN_CASES = [
    (2, 16, 32, 32, 64, 24, range(16), _ring(24, 16), True, 4096),
    (2, 16, 32, 32, 64, 8, range(16), _ring(8, 16), True, 8),
    (2, 1, 32, 32, 64, 8, [20], _ring(8, 21), True, 8),
    (4, 1, 32, 32, 64, 96, [70], _ring(96, 71), True, 4096),
]


@pytest.mark.parametrize("name,packed", FULL_LUTS)
@pytest.mark.parametrize("case", range(len(SSM_ATTN_CASES)))
def test_attention_kernel_bitwise_vs_plain_with_one_head_a_group(cuda, name, packed, case, rng):
    lut, M = _lut(name, packed, cuda)
    args, kw = _attention_inputs(SSM_ATTN_CASES[case], rng, cuda)
    assert _attention_bits(args, kw, lut, M)


@pytest.mark.parametrize("name,packed", FULL_LUTS)
def test_chain_kernels_bitwise_vs_plain_at_zamba2_widths(cuda, name, packed, rng):
    """zamba2-1.2b's shared block at 4 rows: qkv with k/v 2048 wide, then
    attention (G = 1) and the back half in one launch over a ring of 96."""
    lut, M = _lut(name, packed, cuda)
    case = (4, 2048, 32, 32, 64, 8192)
    o = _chain_inputs(case, rng, cuda)
    qkv = (o["x"], o["g"], o["wq"], o["wk"], o["wv"])
    out = decode_chain.fused_qkv_norm(*qkv, lut, M, eps=1e-5)
    ref = decode_chain.fused_qkv_norm_plain(*qkv, lut, M, eps=1e-5)
    torch.cuda.synchronize()
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(out, ref))
    _attn_out_mlp_bitwise(case, 96, 71, 4096, lut, M, rng, cuda)


def _ssm_depth2(arch, **changes):
    cfg = dataclasses.replace(get_arch(arch), n_layers=2, **changes)
    return dataclasses.replace(cfg, attn_every=2) if cfg.attn_every else cfg


@pytest.mark.parametrize("arch,window", [("mamba2-780m", None), ("zamba2-1.2b", None),
                                         ("zamba2-1.2b", 8)])
def test_ssm_serving_runs_through_the_kernels_bitwise(cuda, arch, window):
    """Depth 2 at full width (zamba2's shared block after layer 2; with its
    window cut to 8 the ring wraps in the prefill): prefill and decode
    logits and tokens under ``amsim`` bitwise ``amsim_torch``; a decode
    step launches 2 GEMMs a Mamba2 layer and the head, and the shared
    block's qkv and attention+out-mlp."""
    cfg = _ssm_depth2(arch, **({} if window is None else {"sliding_window": window}))
    model = init_lm(cfg, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    prompts = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(0))
    counters = {"gemm": approx_gemm.approx_gemm, "qkv": decode_chain.fused_qkv_norm,
                "attn_out_mlp": decode_chain.fused_attn_out_mlp}
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("amsim", "amsim_torch"):
            engine = ServingEngine(model, NumericsPolicy(mode=mode, multiplier="afm16"),
                                   max_len=16)
            _, nxt, caches = engine.prefill(prompts.to(cuda), init_lm_caches(cfg, 2, 16, cuda))
            for fn in counters.values():
                fn.launches = 0
            logits, _, _ = engine.step(nxt, caches)
            launched = {k: fn.launches for k, fn in counters.items()}
            runs[mode] = (engine.generate(prompts, 4, return_logits=True), logits, launched)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    ((toks, kept), step_logits, launched), ((r_toks, r_kept), r_step, r_launched) = (
        runs["amsim"], runs["amsim_torch"])
    A = 1 if cfg.attn_every else 0
    assert launched == {"gemm": 2 * cfg.n_layers + 1, "qkv": A, "attn_out_mlp": A}
    assert r_launched == {"gemm": 0, "qkv": 0, "attn_out_mlp": 0}
    assert torch.equal(toks, r_toks)
    for a, b in ((kept, r_kept), (step_logits, r_step)):
        assert bool(torch.isfinite(a).all()) and torch.equal(a.view(torch.int32),
                                                             b.view(torch.int32))


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_ssm_train_steps_run_through_the_kernels_bitwise(cuda, arch):
    """Two adamw steps of the reduced SSM LM (chunk 8, 2 chunks a row)
    under ``amsim``: the SSD products through the batched kernel, losses,
    parameters and the next gradient bitwise ``amsim_torch``."""
    cfg = reduced(get_arch(arch))
    torch.use_deterministic_algorithms(True)
    try:
        runs = {mode: _lm_train(cfg, NumericsPolicy(mode=mode, multiplier="afm16"), cuda)
                for mode in ("amsim", "amsim_torch")}
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    (losses, launches, model, grads), (r_losses, r_launches, ref, r_grads) = (
        runs["amsim"], runs["amsim_torch"])
    assert all(n["approx_gemm_batched"] > 0 and n["approx_gemm"] > 0 for n in launches)
    assert r_launches == [{}, {}]
    assert all(bool(torch.isfinite(v)) for v in losses)
    for a, b in zip([*losses, *model.parameters(), *grads],
                    [*r_losses, *ref.parameters(), *r_grads]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _whisper_launches():
    return {"approx_gemm": approx_gemm.approx_gemm,
            "approx_gemm_batched": approx_gemm.approx_gemm_batched,
            "approx_attention": approx_attention.approx_attention}


def test_encdec_greedy_runs_through_the_kernels_bitwise(cuda):
    """whisper-base at full width, 2 + 2 layers, 256 frames (the widths of
    the path, fewer frames): greedy decoding of batch 2, prompt 4, 3 new
    tokens under ``amsim``: the encoder states, every step's logits and the
    tokens bitwise ``amsim_torch``.  An encoder layer launches 6 GEMMs and
    the attention kernel (bidirectional); a decoder layer 10 GEMMs (self
    and cross q/k/v/wo, wu, wd) and 2 attentions at the prefill and every
    step; the head 1 GEMM."""
    cfg = dataclasses.replace(get_arch("whisper-base"), n_layers=2, n_enc_layers=2,
                              n_frontend_tokens=256)
    model = encdec.init_encdec(cfg, generator=torch.Generator(device=cuda).manual_seed(0),
                               device=cuda)
    gen = torch.Generator().manual_seed(0)
    frames = torch.randn((2, 256, cfg.d_model), generator=gen).to(cuda)
    prompts = torch.randint(0, cfg.vocab, (2, 4), generator=gen).to(cuda)
    counters = _whisper_launches()
    runs = {}
    for mode in ("amsim", "amsim_torch"):
        for fn in counters.values():
            fn.launches = 0
        runs[mode] = encdec.greedy(model, frames, prompts, 3,
                                   NumericsPolicy(mode=mode, multiplier="afm16"))
        torch.cuda.synchronize()
        runs[mode] += ({k: fn.launches for k, fn in counters.items()},)
    *got, launched = runs["amsim"]
    *ref, r_launched = runs["amsim_torch"]
    L, steps = 2, 3          # the prompt's decode, then two steps
    assert launched == {"approx_gemm": 6 * L + (10 * L + 1) * steps, "approx_gemm_batched": 0,
                        "approx_attention": L + 2 * L * steps}
    assert set(r_launched.values()) == {0}
    assert all(bool(torch.isfinite(t.float()).all()) for t in got)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, ref))


def test_encdec_train_steps_run_through_the_kernels_bitwise(cuda):
    """Two adamw steps of reduced whisper-base (2 + 2 layers, 8 frames)
    under ``amsim``: GEMMs, attention and the attention backward's batched
    products through the kernels; losses, parameters and the next gradient
    bitwise ``amsim_torch``."""
    cfg = reduced(get_arch("whisper-base"))
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("amsim", "amsim_torch"):
            policy = NumericsPolicy(mode=mode, multiplier="afm16")
            model = encdec.init_encdec(cfg, generator=torch.Generator().manual_seed(0),
                                       device=cuda)
            opt, step = make_lm_train_step(cfg, policy, lr=3e-4, steps=3)
            state = opt.init(dict(model.named_parameters()))
            counters = _whisper_launches()
            losses, launches = [], []
            for i in range(2):
                for fn in counters.values():
                    fn.launches = 0
                state, metrics = step(model, state, lm_batch(cfg, (2, 16), i, cuda))
                losses.append(metrics["loss"])
                launches.append({k: fn.launches for k, fn in counters.items() if fn.launches})
            loss, _ = encdec.encdec_loss(model, lm_batch(cfg, (2, 16), 2, cuda), policy)
            runs[mode] = (losses, launches, model,
                          torch.autograd.grad(loss, list(model.parameters())))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    (losses, launches, model, grads), (r_losses, r_launches, ref, r_grads) = (
        runs["amsim"], runs["amsim_torch"])
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    assert launches == [{"approx_gemm": 24 * Le + 40 * Ld + 3, "approx_gemm_batched":
                         6 * Le + 12 * Ld, "approx_attention": 2 * Le + 4 * Ld}] * 2
    assert r_launches == [{}, {}]
    assert all(bool(torch.isfinite(v)) for v in losses)
    for a, b in zip([*losses, *model.parameters(), *grads],
                    [*r_losses, *ref.parameters(), *r_grads]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
