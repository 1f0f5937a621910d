"""The GEMM kernel's launch plan and arithmetic, checked on the CPU.

``approx_gemm.gemm_plan`` picks the path, tile and grid of each launch of
``csrc/approx_gemm.cu``; here its tile walk (``gemm_tiles``, the kernel's
own order) must cover every output of every batch element exactly once,
and its tiles must reach every SM that the 16x16 grid it replaced kept
busy, at every GEMM shape of the vision models' training steps and of
granite-3-2b and granite-moe-3b-a800m serving.  ``ref.ref_kernel_product``,
the kernel's decoded product written in torch, must be AMSim bit for bit
over every pair of exponent fields.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core import lutgen  # noqa: E402
from repro_torch.core.amsim import _amsim, lut_words  # noqa: E402
from repro_torch.core.multipliers import get_multiplier  # noqa: E402
from repro_torch.kernels import approx_gemm  # noqa: E402
from repro_torch.kernels.common import lut_tensor  # noqa: E402
from repro_torch.kernels.ref import ref_kernel_product  # noqa: E402

SMS = 132   # an H100 SXM


def _lut(name, packed):
    table = lutgen.get_packed_lut(name) if packed else lutgen.get_lut(name)
    return lut_tensor(table, "cpu"), get_multiplier(name).mantissa_bits


# Forward GEMMs of LeNet-300-100 and LeNet-5's fc layers and resnet-mini's
# head at batch 64, and a ragged one (as chip_smoke.py's GEMM_SHAPES).
FORWARD = [(64, 784, 120), (64, 120, 84), (64, 84, 10), (64, 784, 300),
           (64, 300, 100), (64, 100, 10), (64, 64, 10), (67, 130, 33)]


def _shapes():
    """(batch, m, k, n) of every GEMM launch: the vision forward, dx and dw
    products, then granite-3-2b's and granite-moe-3b-a800m's at prefill
    (4 x 64 and 2 x 16 tokens; granite-moe also 4 x 512, with its expert
    banks at capacity 512) and decode (4 and 2 rows), heads included."""
    out = []
    for m, k, n in FORWARD:
        out += [(1, m, k, n), (1, m, n, k), (1, k, m, n)]
    dense, moe = get_arch("granite-3-2b"), get_arch("granite-moe-3b-a800m")
    for cfg in (dense, moe):
        d, kv = cfg.d_model, cfg.n_kv_heads * cfg.head_dim
        q = cfg.n_heads * cfg.head_dim
        widths = {(d, q), (d, kv), (q, d), (d, cfg.vocab)}
        if cfg is dense:
            widths |= {(d, cfg.d_ff), (cfg.d_ff, d)}
        else:
            widths.add((d, cfg.moe.n_experts))
        for rows in (4 * 64, 2 * 16, 4, 2) + ((4 * 512,) if cfg is moe else ()):
            out += [(1, rows, k, n) for k, n in sorted(widths)]
    E, F = moe.moe.n_experts, moe.moe.d_ff
    out += [(E, 512, moe.d_model, F), (E, 512, F, moe.d_model), (3, 67, 130, 33), (2, 1, 5, 1),
            (40, 8, 40, 17)]
    return sorted(set(out))


SHAPES = _shapes()
TABLES = [("afm16", True), ("afm16", False), ("mitchell8", True), ("afm10", True),
          ("afm10", False)]


@pytest.mark.parametrize("name,packed", TABLES)
def test_plan_walks_every_output_once(name, packed):
    """Over a grid of as many blocks as tiles, of one block an SM, and of
    3 blocks (each then walks many tiles)."""
    lut, _ = _lut(name, packed)
    for batch, m, k, n in SHAPES:
        plan = approx_gemm.gemm_plan(batch, m, k, n, lut, SMS)
        for grid in (plan.tiles, min(plan.tiles, SMS), min(plan.tiles, 3)):
            seen = np.zeros((batch, m, n), np.int32)
            blocks = set()
            for block, e, r0, r1, c0, c1 in approx_gemm.gemm_tiles(plan, batch, m, n, grid):
                seen[e, r0:r1, c0:c1] += 1
                blocks.add(block)
            assert (seen == 1).all(), (batch, m, n, plan, grid)
            assert blocks == set(range(grid)), (batch, m, n, plan, grid)


@pytest.mark.parametrize("name,packed", TABLES)
def test_plan_keeps_busy_every_sm_the_old_grid_did(name, packed):
    """At least min(the 16x16 grid's blocks, the SMs) tiles at every shape:
    the launch gives them at least one block an SM (card test
    ``test_gemm_grid_keeps_busy_every_sm_the_old_grid_did``)."""
    lut, _ = _lut(name, packed)
    for batch, m, k, n in SHAPES:
        plan = approx_gemm.gemm_plan(batch, m, k, n, lut, SMS)
        old = batch * -(-m // 16) * -(-n // 16)
        assert plan.old_blocks == old
        assert plan.tiles >= min(old, SMS), (batch, m, n, plan)
        bm, bn = plan.tile
        assert plan.tiles == batch * -(-m // bm) * -(-n // bn)


def test_plan_takes_the_column_path_at_and_below_the_small_m_threshold():
    lut, _ = _lut("afm16", True)
    for m in range(1, 2 * approx_gemm.SMALL_M + 1):
        plan = approx_gemm.gemm_plan(1, m, 2048, 49155, lut, SMS)
        assert (plan.path == "column") == (m <= approx_gemm.SMALL_M), (m, plan)
        if plan.path == "column":
            assert plan.rows in approx_gemm.COLUMN_ROWS and plan.rows >= m
            assert plan.tile == (m, plan.cols) and plan.threads == plan.cols
        else:
            assert plan.threads == approx_gemm.TILED_THREADS
            assert (plan.rows, plan.cols) in approx_gemm.TILED


@pytest.mark.parametrize("name,packed,table", [
    ("afm16", True, "smem canonical"), ("afm16", False, "smem canonical"),
    ("mitchell8", True, "smem packed"), ("mitchell8", False, "global canonical"),
    ("afm10", True, "global packed"), ("afm10", False, "global canonical")])
def test_plan_places_the_table(name, packed, table, monkeypatch):
    """A table the blocks can hold goes to shared memory, a packed one that
    fits twice expanded to canonical words where the fold is long (k >=
    EXPAND_MIN_K) and kept packed where it is short; the rest is read from
    global memory."""
    lut, _ = _lut(name, packed)
    assert approx_gemm.gemm_plan(1, 256, 2048, 2048, lut, SMS).table == table
    short = approx_gemm.gemm_plan(1, 64, approx_gemm.EXPAND_MIN_K - 1, 120, lut, SMS).table
    if (name, packed) == ("afm16", True):
        assert short == "smem packed"
        monkeypatch.setattr(approx_gemm, "EXPAND_MIN_K", 0)
        assert approx_gemm.gemm_plan(1, 64, 64, 10, lut, SMS).table == table
        monkeypatch.setattr(approx_gemm, "EXPAND_MIN_K", 1 << 62)
        assert approx_gemm.gemm_plan(1, 256, 2048, 2048, lut, SMS).table == "smem packed"
    else:
        assert short == table


def test_live_row_tiles_counts_tiles_with_a_live_row():
    lut, _ = _lut("afm16", True)
    a = torch.zeros(3, 100, 20)
    a[0, :10] = 1.0                       # expert 0: rows 0-9 live
    a[1, 70] = 1e-39                      # expert 1: a subnormal row is dead
    a[2, 99, 5] = -2.0                    # expert 2: the last row live
    plan = approx_gemm.gemm_plan(3, 100, 20, 512, lut, SMS)
    bm = plan.tile[0]
    assert approx_gemm.live_row_tiles(a, plan) == (2, 3 * -(-100 // bm))


def _words(exponents, signs, mantissas):
    """int64 words of float32 bit patterns from fields, broadcast."""
    return (signs.astype(np.int64) << 31) | (exponents.astype(np.int64) << 23) | mantissas


@pytest.mark.parametrize("name,packed,expand", [
    ("afm16", True, True), ("afm16", True, False), ("afm16", False, True),
    ("mitchell8", True, False), ("mitchell8", False, True), ("afm10", True, False)])
def test_kernel_product_is_amsim_bitwise(name, packed, expand):
    """Every pair of exponent fields (zeros, subnormals, inf and NaN
    included, sums that underflow and that carry into 255), both signs,
    with mantissas whose table entry carries and whose does not."""
    lut, M = _lut(name, packed)
    words, _ = lut_words(lut)
    carry = ((words >> M) & 1) if packed else ((words >> 23) & 1)
    rng = np.random.default_rng(0)
    picks = [int(np.flatnonzero(carry.numpy() == c)[rng.integers(0, int((carry == c).sum()))])
             for c in (0, 1)]
    e = np.arange(256)
    ua, ub = [], []
    for idx in picks:
        ma, mb = divmod(idx, 1 << M)
        low = rng.integers(0, 1 << (23 - M), size=2)
        for sa, sb in ((0, 0), (0, 1), (1, 0), (1, 1)):
            ua.append(_words(e[:, None], np.full((256, 1), sa), (ma << (23 - M)) | int(low[0])))
            ub.append(_words(e[None, :], np.full((1, 256), sb), (mb << (23 - M)) | int(low[1])))
    ua = torch.from_numpy(np.stack([np.broadcast_to(u, (256, 256)) for u in ua]))
    ub = torch.from_numpy(np.stack([np.broadcast_to(u, (256, 256)) for u in ub]))
    want = _amsim(ua, ub, words, M, torch, packed=packed)
    got = ref_kernel_product(ua, ub, lut, M, expand=expand)
    assert torch.equal(got, want)
    # the edges the kernel's single compare and clamp stand for
    ex = (ua >> 23) & 0xFF
    assert bool(((want & 0x7FFF_FFFF) == 0x7F80_0000).any())      # overflow to inf
    assert bool(((want & 0x7FFF_FFFF) == 0)[(ex > 0) & (((ub >> 23) & 0xFF) > 0)].any())


def _c_signatures():
    """{C entry point: its parameter types} of every kernel source."""
    import re
    from repro_torch.kernels import _build
    sigs = {}
    for source, _ in _build.LIBRARIES.values():
        text = (_build.CSRC / source).read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            # a parameter's type: all but its name ("int* /*out*/" has none)
            params = re.sub(r"/\*.*?\*/", "", params)
            sigs[name] = [" ".join(p.split()[:-1]) or p.strip() for p in params.split(",")]
    return sigs


@pytest.mark.parametrize("library", ["approx_gemm", "approx_conv", "approx_conv_dw",
                                     "approx_attention", "decode_chain"])
def test_ctypes_bindings_match_the_c_entry_points(library):
    """Each function's ctypes argtypes: a pointer for each pointer (and the
    stream), an int for each int, in the C signature's order; a count off
    by one would cut or shift the arguments on the card."""
    import ctypes
    from repro_torch.kernels import _build
    sigs = _c_signatures()
    for fn, argtypes in _build.LIBRARIES[library][1].items():
        want = [ctypes.c_void_p if "*" in p else
                {"int": ctypes.c_int, "float": ctypes.c_float,
                 "long long": ctypes.c_longlong}[p.replace("const ", "")]
                for p in sigs[fn]]
        assert argtypes == want, fn
