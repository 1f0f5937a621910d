"""The conv kernel's launch plan and its dilated data gradient, checked on
the CPU.

``approx_conv.conv_plan`` picks the register tile and the warps' layout of
each launch of ``csrc/approx_conv.cu``; here its tile walk
(``conv_tiles``, the kernel's own order) must cover every output exactly
once, at every conv of resnet-mini and LeNet-5 at batch 64 and its data
gradient (the error read undilated, ``input_dilation`` = the stride), and
at ragged shapes, under every tile the kernel takes.  A tile of a dilated
conv holds one parity class, and a class's live taps (``conv_classes``)
must be exactly the taps that land on a real value of the dilated input,
at the x index the kernel reads.  The plain version with
``input_dilation`` must give the bits of the plain version on
``ops.conv_dx_operands``' materialised error, and the swizzled table the
conv kernel stages must give AMSim's products bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import lutgen  # noqa: E402
from repro_torch.core.amsim import _amsim, lut_words  # noqa: E402
from repro_torch.core.multipliers import get_multiplier  # noqa: E402
from repro_torch.kernels import approx_conv, ops  # noqa: E402
from repro_torch.kernels.common import lut_tensor  # noqa: E402
from repro_torch.kernels.ref import ref_kernel_product  # noqa: E402

SMS = 132   # an H100 SXM

# Every conv of resnet-mini and LeNet-5 at batch 64 (chip_smoke.py's
# CONV_SHAPES), then ragged ones: odd sizes and channels, a 5x5 kernel on a
# 2x2 image (whole taps in the padding), stride 2 VALID, stride 3, more
# channels than a slab and than a tile.  (x shape, w shape, stride, padding)
SHAPES = [((64, 32, 32, 3), (3, 3, 3, 16), 1, "SAME"),
          ((64, 32, 32, 16), (3, 3, 16, 16), 1, "SAME"),
          ((64, 32, 32, 16), (3, 3, 16, 32), 2, "SAME"),
          ((64, 32, 32, 16), (1, 1, 16, 32), 2, "SAME"),
          ((64, 16, 16, 32), (3, 3, 32, 32), 1, "SAME"),
          ((64, 16, 16, 32), (3, 3, 32, 64), 2, "SAME"),
          ((64, 16, 16, 32), (1, 1, 32, 64), 2, "SAME"),
          ((64, 8, 8, 64), (3, 3, 64, 64), 1, "SAME"),
          ((64, 28, 28, 1), (5, 5, 1, 6), 1, "SAME"),
          ((64, 14, 14, 6), (5, 5, 6, 16), 1, "SAME"),
          ((2, 9, 7, 3), (3, 3, 3, 6), 1, "SAME"),
          ((3, 2, 2, 3), (5, 5, 3, 6), 1, "SAME"),
          ((1, 9, 7, 2), (3, 3, 2, 3), 2, "VALID"),
          ((2, 11, 10, 5), (4, 3, 5, 9), 3, "SAME"),
          ((5, 13, 11, 70), (3, 3, 70, 130), 2, "SAME")]


def _lut(name, packed):
    table = lutgen.get_packed_lut(name) if packed else lutgen.get_lut(name)
    return lut_tensor(table, "cpu")


def _launches(xs, ws, stride, padding):
    """The forward conv's launch shape and its data gradient's: the error
    (N, OH, OW, O) dilated by the stride, the reversed IO-transposed
    weights, the explicit pads (``ops._conv_dx``)."""
    pads = approx_conv.conv_pads(xs[1], xs[2], ws[0], ws[1], stride, padding)
    fwd = approx_conv.conv_shape(xs, ws, stride, pads)
    w_rt, dpads = ops.conv_dx_weights(torch.zeros(ws), (fwd.oh, fwd.ow), xs[1:3], stride, pads)
    dx = approx_conv.conv_shape((xs[0], fwd.oh, fwd.ow, ws[3]), tuple(w_rt.shape), 1, dpads,
                                stride)
    assert (dx.oh, dx.ow) == tuple(xs[1:3])
    return {"fwd": fwd, "dx": dx}


def _plans(shape, lut):
    """The shape's own plan, then every tile the kernel takes, forced."""
    plan = approx_conv.conv_plan(shape, lut, SMS)
    plans = [plan]
    for tm, wn in approx_conv.CONV_TILES:
        bm, bn = approx_conv.CONV_WARPS // wn * 32 * tm, wn * approx_conv.CONV_TN
        tiles = len(approx_conv.conv_tiles(dataclasses.replace(plan, block=(bm, bn)), shape, 1))
        plans.append(dataclasses.replace(plan, tile=(tm, approx_conv.CONV_TN),
                                         warps=(approx_conv.CONV_WARPS // wn, wn),
                                         block=(bm, bn), tiles=tiles))
    return plans


def _outputs(shape):
    """{(ry, rx): (n, oy, ox) index arrays of the class's positions}."""
    out = {}
    for ry, rx, _, _ in approx_conv.conv_classes(shape):
        got = np.array(approx_conv.class_outputs(shape, ry, rx), np.int64).reshape(-1, 3)
        out[ry, rx] = tuple(got.T)
    return out


@pytest.mark.parametrize("pass_", ["fwd", "dx"])
@pytest.mark.parametrize("xs,ws,stride,padding", SHAPES)
def test_conv_tiles_walk_every_output_once(xs, ws, stride, padding, pass_):
    """Under every plan, over a grid of as many blocks as tiles, of one
    block an SM, and of 3 blocks (each then walks many tiles)."""
    shape = _launches(xs, ws, stride, padding)[pass_]
    outputs = _outputs(shape)
    for plan in _plans(shape, _lut("afm16", True)):
        tiles = approx_conv.conv_tiles(plan, shape, plan.tiles)
        assert len(tiles) == plan.tiles, plan
        seen = np.zeros((shape.n, shape.oh, shape.ow, shape.o), np.int32)
        for _, ry, rx, p0, p1, o0, o1 in tiles:
            assert 0 <= p0 < p1 <= p0 + plan.block[0] and o1 - o0 <= plan.block[1], plan
            n, oy, ox = (a[p0:p1] for a in outputs[ry, rx])
            seen[n, oy, ox, o0:o1] += 1
        assert (seen == 1).all(), (xs, ws, pass_, plan)
        for grid in (min(plan.tiles, SMS), min(plan.tiles, 3)):
            walk = approx_conv.conv_tiles(plan, shape, grid)
            assert [t[1:] for t in walk] == [t[1:] for t in tiles]
            assert {t[0] for t in walk} == set(range(grid)), (plan, grid)


@pytest.mark.parametrize("xs,ws,stride,padding", [s for s in SHAPES if s[2] > 1])
def test_dx_tiles_never_mix_parity_classes(xs, ws, stride, padding):
    """At stride s the data gradient's outputs fall into s x s classes by
    (oy, ox) mod s, and each tile's outputs are of one class."""
    shape = _launches(xs, ws, stride, padding)["dx"]
    assert len(approx_conv.conv_classes(shape)) == stride * stride
    outputs = _outputs(shape)
    for plan in _plans(shape, _lut("afm16", True)):
        for _, ry, rx, p0, p1, _, _ in approx_conv.conv_tiles(plan, shape, plan.tiles):
            _, oy, ox = (a[p0:p1] for a in outputs[ry, rx])
            assert (oy % stride == ry).all() and (ox % stride == rx).all(), (plan, ry, rx)


@pytest.mark.parametrize("xs,ws,stride,padding", SHAPES)
def test_class_taps_are_the_taps_on_real_values(xs, ws, stride, padding):
    """For each output of each class, the taps (ki, kj) that land on a real
    value of the dilated input are the class's live taps that land inside
    the input, and the kernel's x index (q * sp + b + t) is that value's;
    the forward conv is one class whose live taps are all taps."""
    for pass_, shape in _launches((1, *xs[1:]), ws, stride, padding).items():
        d, s = shape.dilation, shape.stride
        sp = s // np.gcd(s, d)
        classes = approx_conv.conv_classes(shape)
        if d == 1:
            assert len(classes) == 1 and (classes[0][2].t_n, classes[0][3].t_n) == ws[:2]
        real_taps = 0
        for ry, rx, ay, ax in classes:
            live = {(ay.k0 + d * ty, ax.k0 + d * tx): (ty, tx)
                    for ty in range(ay.t_n) for tx in range(ax.t_n)}
            for _, oy, ox in approx_conv.class_outputs(shape, ry, rx):
                qy, qx = (oy - ry) // (d // np.gcd(s, d)), (ox - rx) // (d // np.gcd(s, d))
                for ki in range(shape.kh):
                    for kj in range(shape.kw):
                        iy, ix = oy * s + ki - shape.pt, ox * s + kj - shape.pl
                        real = (iy % d == 0 and ix % d == 0 and 0 <= iy // d < shape.h
                                and 0 <= ix // d < shape.w)
                        if (ki, kj) in live:
                            ty, tx = live[ki, kj]
                            y, x = qy * sp + ay.b + ty, qx * sp + ax.b + tx
                            assert (iy, ix) == (y * d, x * d), (pass_, ry, rx, oy, ox, ki, kj)
                            assert real == (0 <= y < shape.h and 0 <= x < shape.w)
                        else:
                            assert not real, (pass_, ry, rx, oy, ox, ki, kj)
                        real_taps += real
        assert real_taps > 0


def _special(rng, shape):
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
    return torch.from_numpy(v)


@pytest.mark.parametrize("values", ["random", "special"])
@pytest.mark.parametrize("xs,ws,stride,padding", SHAPES[:10] + SHAPES[12:14])
def test_plain_with_input_dilation_is_the_plain_on_the_dilated_error(xs, ws, stride, padding,
                                                                    values):
    """At batch 2: the plain version (and the wrapper on CPU tensors) with
    input_dilation = stride on the undilated error, bit for bit the plain
    version on conv_dx_operands' dilated one (+0.0 and -0.0 differ)."""
    rng = np.random.default_rng(0)
    xs = (2, *xs[1:])
    lut, M = _lut("afm16", True), get_multiplier("afm16").mantissa_bits
    pads = approx_conv.conv_pads(xs[1], xs[2], ws[0], ws[1], stride, padding)
    oh, ow = approx_conv.conv_out_shape(xs[1], xs[2], ws[0], ws[1], stride, pads)
    make = _special if values == "special" else (
        lambda r, s: torch.from_numpy(r.standard_normal(s).astype(np.float32)))
    g, w = make(rng, (2, oh, ow, ws[3])), make(rng, ws)
    gd, w_rt, dpads = ops.conv_dx_operands(g, w, xs[1:3], stride, pads)
    ref = approx_conv.approx_conv2d_plain(gd, w_rt, lut, M, 1, dpads)
    got = approx_conv.approx_conv2d_plain(g, w_rt, lut, M, 1, dpads, input_dilation=stride)
    wrapped = approx_conv.approx_conv2d_fused(g, w_rt, lut, M, padding=dpads,
                                              input_dilation=stride)
    assert ref.shape == xs[:3] + (ws[2],)
    for out in (got, wrapped):
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def test_amsim_dx_reads_the_undilated_error(monkeypatch):
    """ops._conv_dx under amsim hands the kernel wrapper the error as it is
    and input_dilation = stride; the gradient equals amsim_torch's, which
    convolves the materialised dilated error."""
    from repro_torch.core.policy import NumericsPolicy
    rng = np.random.default_rng(1)
    seen = []
    fused = approx_conv.approx_conv2d_fused

    def spy(x, w, lut, M, **kw):
        seen.append((tuple(x.shape), kw.get("input_dilation", 1)))
        return fused(x, w, lut, M, **kw)

    monkeypatch.setattr(ops, "approx_conv2d_fused", spy)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 4)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 4, 4, 4)).astype(np.float32))
    grads = {}
    for mode in ("amsim", "amsim_torch"):
        xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = ops.approx_conv2d(xt, wt, 2, "SAME", NumericsPolicy(mode=mode, multiplier="afm16"))
        grads[mode] = torch.autograd.grad(y, (xt, wt), g)
    assert seen == [((2, 8, 8, 3), 1), ((2, 4, 4, 4), 2)]
    for a, b in zip(grads["amsim"], grads["amsim_torch"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_input_dilation_is_checked():
    lut, M = _lut("afm16", True), 7
    x, w = torch.zeros((1, 4, 4, 2)), torch.zeros((3, 3, 2, 3))
    with pytest.raises(ValueError, match="input_dilation"):
        approx_conv.approx_conv2d_fused(x, w, lut, M, input_dilation=0)
    out = approx_conv.approx_conv2d_fused(x, w, lut, M, input_dilation=3, padding="VALID")
    assert out.shape == (1, 8, 8, 3)


def _words(e, s, mantissa):
    return (s.astype(np.int64) << 31) | (e.astype(np.int64) << 23) | mantissa


@pytest.mark.parametrize("name,packed,expand", [
    ("afm16", True, False), ("afm16", True, True), ("afm16", False, True),
    ("mitchell8", True, False), ("mitchell8", False, True)])
def test_swizzled_table_products_are_amsim_bitwise(name, packed, expand):
    """The table as the conv kernel stages it in shared memory (packed
    kept packed, packed expanded, canonical): every (ma, mb) mantissa pair
    at exponents that flush, carry into inf and stay normal, both signs,
    then every pair of exponent fields at a few mantissas."""
    lut, M = _lut(name, packed), get_multiplier(name).mantissa_bits
    words, _ = lut_words(lut)
    rng = np.random.default_rng(0)
    ma, mb = np.divmod(np.arange(1 << (2 * M)), 1 << M)
    low = rng.integers(0, 1 << (23 - M), size=(2, ma.size))
    ua, ub = [], []
    for ea, eb in ((127, 127), (1, 100), (0, 200), (200, 200), (255, 1), (126, 1)):
        for sa, sb in ((0, 1), (1, 1)):
            ua.append(_words(np.full(ma.shape, ea), np.full(ma.shape, sa),
                             (ma << (23 - M)) | low[0]))
            ub.append(_words(np.full(mb.shape, eb), np.full(mb.shape, sb),
                             (mb << (23 - M)) | low[1]))
    e = np.arange(256)
    for _ in range(4):
        pa, pb = rng.integers(0, 1 << 23, size=2)
        ua.append(np.broadcast_to(_words(e[:, None], np.zeros((256, 1)), int(pa)),
                                  (256, 256)).ravel())
        ub.append(np.broadcast_to(_words(e[None, :], np.ones((1, 256)), int(pb)),
                                  (256, 256)).ravel())
    ua, ub = torch.from_numpy(np.concatenate(ua)), torch.from_numpy(np.concatenate(ub))
    want = _amsim(ua, ub, words, M, torch, packed=packed)
    got = ref_kernel_product(ua, ub, lut, M, expand=expand, swizzle=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,packed", [("afm10", True), ("afm10", False),
                                         ("mitchell8", False)])
def test_transposed_global_table_products_are_amsim_bitwise(name, packed):
    """A table read from global memory is read transposed, w decoded as the
    row (decode_a) and x as the column (decode_b): amsim(x, w) bit for bit,
    for random words and every pair of exponent fields."""
    lut, M = _lut(name, packed), get_multiplier(name).mantissa_bits
    words, _ = lut_words(lut)
    rng = np.random.default_rng(1)
    ux = rng.integers(0, 1 << 32, size=1 << 16, dtype=np.int64)
    uw = rng.integers(0, 1 << 32, size=1 << 16, dtype=np.int64)
    e = np.arange(256)
    ux = np.concatenate([ux, _words(np.repeat(e, 256), np.zeros(65536), 0x2A5A5A)])
    uw = np.concatenate([uw, _words(np.tile(e, 256), np.ones(65536), 0x35A5A5)])
    ux, uw = torch.from_numpy(ux), torch.from_numpy(uw)
    table = approx_conv.transposed_lut(lut)
    assert table is approx_conv.transposed_lut(lut)          # made once a table
    got = ref_kernel_product(uw, ux, table, M)
    assert torch.equal(got, _amsim(ux, uw, words, M, torch, packed=packed))


@pytest.mark.parametrize("name,packed,table", [
    ("afm16", True, "smem canonical"), ("afm16", False, "smem canonical"),
    ("mitchell8", True, "smem packed"), ("afm10", True, "global packed"),
    ("afm10", False, "global canonical")])
def test_conv_plan_places_the_table_and_fills_the_sms(name, packed, table):
    """A table whose canonical words fit goes to shared memory so, a packed
    one expanded; a packed one whose canonical words do not (M = 8) stays
    packed there; a larger one stays in global memory, as stored.  At every
    resnet-mini shape, forward and data
    gradient, the plan's tiles reach nearly every SM (LeNet-5's convs have
    too few outputs for 132 tiles of a block of 8 warps)."""
    lut = _lut(name, packed)
    for i, (xs, ws, stride, padding) in enumerate(SHAPES[:10]):
        for pass_, shape in _launches(xs, ws, stride, padding).items():
            plan = approx_conv.conv_plan(shape, lut, SMS)
            assert plan.table == table
            tm, tn = plan.tile
            wm, wn = plan.warps
            assert (tm, wn) in approx_conv.CONV_TILES and tn == approx_conv.CONV_TN
            assert plan.block == (wm * 32 * tm, wn * tn) and wm * wn == approx_conv.CONV_WARPS
            assert plan.classes == len(approx_conv.conv_classes(shape))
            if i < 8:
                assert plan.tiles >= 0.95 * SMS, (xs, ws, pass_, plan)


def test_conv_cpu_path_never_plans_a_launch(monkeypatch):
    """On CPU tensors the wrapper runs its plain version, whatever the plan."""
    def boom(*a):
        raise AssertionError("conv_plan called on the CPU path")

    monkeypatch.setattr(approx_conv, "conv_plan", boom)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 5, 4, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 6)).astype(np.float32))
    lut = _lut("afm16", True)
    out = approx_conv.approx_conv2d_fused(x, w, lut, 7, input_dilation=2)
    ref = approx_conv.approx_conv2d_plain(x, w, lut, 7, 1, (1, 1, 1, 1), input_dilation=2)
    assert torch.equal(out, ref)
