"""The conv weight-gradient kernel's launch plan, checked on the CPU.

``approx_conv.dw_plan`` picks the output tile (one tap, TC channels x TO
output channels), the path and the table form of each launch of
``csrc/approx_conv_dw.cu``; here its tile walk (``dw_tiles``, the kernel's
own order) must cover every output exactly once, and its chunk walk
(``dw_chunks``, the kernel's x staging: a position divided out once, then
advanced with two carries) must visit every position once, in order, at
every dw shape of resnet-mini and LeNet-5 at batch 64 and at ragged ones.
The new C entries must match their ctypes bindings.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import lutgen  # noqa: E402
from repro_torch.kernels import _build, approx_conv  # noqa: E402
from repro_torch.kernels.common import lut_tensor  # noqa: E402

SMS = 132   # an H100 SXM

# Every dw of resnet-mini and LeNet-5 at batch 64 (chip_smoke.py's
# CONV_SHAPES), then ragged ones: 3 channels, 6 output channels, a 5x5
# kernel on a 2x2 image (whole taps in the padding), stride 2 VALID.
# (x shape, w shape, stride, padding)
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
          ((5, 13, 11, 70), (3, 3, 70, 130), 2, "SAME")]
TABLES = [("afm16", True), ("afm16", False), ("mitchell8", True), ("afm10", True)]


def _lut(name, packed):
    table = lutgen.get_packed_lut(name) if packed else lutgen.get_lut(name)
    return lut_tensor(table, "cpu")


def _geometry(xs, ws, stride, padding):
    pads = approx_conv.conv_pads(xs[1], xs[2], ws[0], ws[1], stride, padding)
    return approx_conv.conv_out_shape(xs[1], xs[2], ws[0], ws[1], stride, pads)


# Outputs of a tile the kernel takes: the split sizes, then the tiled one.
OUTPUTS = (*approx_conv.DW_SPLIT_OUTPUTS, approx_conv.DW_THREADS)


def _plans(ws, lut):
    """The shape's own plan, then every tile the kernel takes, forced."""
    plan = approx_conv.dw_plan(*ws, lut, SMS)
    plans = [plan]
    for outputs in OUTPUTS:
        for to in (8, 16, 32, 64):
            if to <= outputs:
                plans.append(dataclasses.replace(plan, tile=(outputs // to, to), outputs=outputs,
                                                 chunk=approx_conv.dw_chunk(outputs)))
    return plans


@pytest.mark.parametrize("name,packed", TABLES)
@pytest.mark.parametrize("xs,ws,stride,padding", SHAPES)
def test_dw_plan_walks_every_output_once(name, packed, xs, ws, stride, padding):
    """Over a grid of as many blocks as tiles, of one block an SM, and of 3
    blocks (each then walks many tiles)."""
    lut = _lut(name, packed)
    kh, kw, c, o = ws
    for plan in _plans(ws, lut):
        tiles = kh * kw * -(-c // plan.tile[0]) * -(-o // plan.tile[1])
        for grid in (tiles, min(tiles, SMS), min(tiles, 3)):
            seen = np.zeros((kh, kw, c, o), np.int32)
            blocks = set()
            for block, ki, kj, c0, c1, o0, o1 in approx_conv.dw_tiles(plan, kh, kw, c, o, grid):
                seen[ki, kj, c0:c1, o0:o1] += 1
                blocks.add(block)
            assert (seen == 1).all(), (xs, ws, plan, grid)
            assert blocks == set(range(grid)), (xs, ws, plan, grid)


@pytest.mark.parametrize("xs,ws,stride,padding", SHAPES)
def test_dw_chunks_visit_every_position_once_in_order(xs, ws, stride, padding):
    """At every chunk length a plan can take: the positions (n, oy, ox) in
    row-major order, then nothing past the last."""
    n = xs[0]
    oh, ow = _geometry(xs, ws, stride, padding)
    want = [(i, y, x) for i in range(n) for y in range(oh) for x in range(ow)]
    plan = approx_conv.dw_plan(*ws, _lut("afm16", True), SMS)
    for chunk in sorted({approx_conv.dw_chunk(u) for u in OUTPUTS}):
        chunks = approx_conv.dw_chunks(dataclasses.replace(plan, chunk=chunk), n, oh, ow)
        walked = [p for ch in chunks for p in ch]
        assert len(chunks) == -(-len(want) // chunk) and all(len(ch) == chunk for ch in chunks)
        assert walked[:len(want)] == want, (xs, ws, chunk)
        assert all(p is None for p in walked[len(want):]), (xs, ws, chunk)


@pytest.mark.parametrize("name,packed", TABLES)
def test_dw_plan_reaches_every_sm_where_the_shape_allows(name, packed):
    """Tiled where the outputs fill a tile of DW_THREADS on every SM; else
    split, TO = DW_SPLIT_COLS, the largest split tile whose tiles reach
    DW_TILES_PER_SM an SM, or the smallest."""
    lut = _lut(name, packed)
    for xs, ws, stride, padding in SHAPES:
        kh, kw, c, o = ws
        plan = approx_conv.dw_plan(*ws, lut, SMS)
        tc, to = plan.tile
        assert plan.outputs == tc * to and plan.outputs in OUTPUTS
        assert plan.tiles == kh * kw * -(-c // tc) * -(-o // to)
        assert plan.chunk == approx_conv.dw_chunk(plan.outputs)
        tiled = kh * kw * c * o >= approx_conv.DW_THREADS * SMS
        assert plan.path == ("tiled" if tiled else "split"), (ws, plan)
        if tiled:
            assert 8 <= to <= approx_conv.DW_TILED_COLS and to & (to - 1) == 0
            continue
        assert to == approx_conv.DW_SPLIT_COLS and tc <= max(1, 1 << (c - 1).bit_length())
        want = approx_conv.DW_TILES_PER_SM * SMS
        assert plan.tiles >= want or plan.outputs == min(OUTPUTS), (ws, plan)
        for larger in (u for u in OUTPUTS[:-1] if u > plan.outputs):
            ltc = larger // to
            if ltc <= 1 << (c - 1).bit_length():
                assert kh * kw * -(-c // ltc) * -(-o // to) < want, (ws, plan, larger)
    # the resnet-mini step: the stem and stage 1 split, stage 3 tiled
    stem = approx_conv.dw_plan(3, 3, 3, 16, lut, SMS)
    stage1 = approx_conv.dw_plan(3, 3, 16, 16, lut, SMS)
    stage3 = approx_conv.dw_plan(3, 3, 64, 64, lut, SMS)
    assert (stem.path, stem.tile, stem.tiles) == ("split", (1, 8), 54)
    assert (stage1.path, stage1.tile, stage1.tiles) == ("split", (1, 8), 288)
    assert (stage3.path, stage3.tile, stage3.tiles) == ("tiled", (8, 32), 144)


@pytest.mark.parametrize("name,packed,table", [
    ("afm16", True, "smem packed"), ("afm16", False, "smem canonical"),
    ("mitchell8", True, "smem packed"), ("mitchell8", False, "global canonical"),
    ("afm10", True, "global packed"), ("afm10", False, "global canonical")])
def test_dw_plan_places_the_table(name, packed, table):
    """A table the blocks can hold goes to shared memory as it is stored
    (expanded, a packed one would leave room for fewer blocks an SM beside
    the staging buffers); larger tables stay in global memory.  On both
    paths."""
    lut = _lut(name, packed)
    assert approx_conv.dw_plan(3, 3, 16, 16, lut, SMS).table == table
    assert approx_conv.dw_plan(3, 3, 64, 64, lut, SMS).table == table


def test_dw_cpu_path_never_plans_a_launch(monkeypatch):
    """On CPU tensors the wrapper runs its plain version, whatever the plan."""
    def boom(*a):
        raise AssertionError("dw_plan called on the CPU path")

    monkeypatch.setattr(approx_conv, "dw_plan", boom)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 5, 4, 3)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 5, 4, 6)).astype(np.float32))
    lut = _lut("afm16", True)
    out = approx_conv.approx_conv2d_dw(x, g, lut, 7, kh=3, kw=3)
    ref = approx_conv.approx_conv2d_dw_plain(x, g, lut, 7, 3, 3, 1, (1, 1, 1, 1))
    assert torch.equal(out, ref)


def _c_signature(source: str, fn: str):
    import re
    text = (_build.CSRC / source).read_text()
    params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text).group(1)
    # a parameter's type: all but its name ("void*" has none)
    return [" ".join(p.split()[:-1]) or p.strip() for p in params.split(",")]


@pytest.mark.parametrize("library,fn", [("approx_conv_dw", "approx_conv2d_dw_f32"),
                                        ("approx_conv_dw", "approx_conv_dw_grid"),
                                        ("decode_chain", "wo_norm_grid"),
                                        ("decode_chain", "fused_wo_norm_f32")])
def test_new_bindings_match_their_c_entry_points(library, fn):
    """A pointer for each pointer and the stream, an int for each int, a
    float for each float, in the C signature's order."""
    import ctypes
    source, fns = _build.LIBRARIES[library]
    want = [ctypes.c_void_p if "*" in p else
            {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}[p.replace("const ", "")]
            for p in _c_signature(source, fn)]
    assert fns[fn] == want
