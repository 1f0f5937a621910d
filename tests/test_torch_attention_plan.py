"""The attention kernel's launch plan and its order of work, checked on the
CPU.

``approx_attention.attention_plan`` picks the tile of each launch of
``csrc/approx_attention.cu`` (query rows a block, a thread's register tile)
and its shared-memory layout; here the kernel's walk (``attention_tiles``
over the tiles, ``attention_threads`` within one) must compute every
(row, key) score and every (row, dim) output exactly once, at the test
shapes of the port, at granite-3-2b's and granite-moe-3b-a800m's serving
shapes and at a ring of 512, under every plan the kernel takes.  The
kernel's order in torch (``ref.ref_attention_tiled``: tile by tile, the
decoded product, K slabs skipped where no row has a valid key and V slabs
where every probability is +0.0) must give the bits of
``approx_attention_plain`` on random values, on zeros, -0.0 and
subnormals with inf and NaN in unwritten ring slots, and with rows that
have no valid key; it never skips a slab that holds a valid key, and
never a V slab of a tile with such a row.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import lutgen  # noqa: E402
from repro_torch.core.multipliers import get_multiplier  # noqa: E402
from repro_torch.kernels import approx_attention as attn  # noqa: E402
from repro_torch.kernels import decode_chain  # noqa: E402
from repro_torch.kernels.common import POS_PAD, attention_mask, lut_tensor  # noqa: E402
from repro_torch.kernels.ref import ref_attention_tiled  # noqa: E402

SMS = 132   # an H100 SXM


def _ring(T, written):
    """Positions of a ring of T slots after `written` tokens (POS_PAD where
    none was written yet)."""
    pos = np.full(T, POS_PAD, np.int64)
    for p in range(max(0, written - T), written):
        pos[p % T] = p
    return pos


RING_WRAPPED = [16, 17, 18, 19] + list(range(4, 16))
RING_PARTIAL = list(range(10)) + [POS_PAD] * 6
# (B, S, H, KV, dh, T, q_pos, k_pos, causal, window): test_torch_attention's
# CASES, test_torch_cuda's ATTN_CASES, then the serving shapes:
# granite-3-2b's prefill into a ring of 96 and a decode step over 160,
# granite-moe-3b-a800m's decode step (G = 3), a prefill of 512 into a ring
# of 512, and head dims past a value chunk (odd, and 256); then
# bidirectional attention (``causal=False``): whisper-base's encoder (1500
# frames; here one KV head pair, the plan's other inputs as there), its
# cross prefill of 4 tokens and a cross decode step over 1500 frames, small
# encoder and cross shapes, and a bidirectional read of a partly written
# ring (keys that no row may read).
SHAPES = {
    "prefill_causal_G2": (2, 8, 4, 2, 32, 8, range(8), range(8), True, 0),
    "prefill_causal_G1": (2, 8, 2, 2, 32, 8, range(8), range(8), True, 0),
    "prefill_window3": (2, 8, 4, 2, 32, 8, range(8), range(8), True, 3),
    "decode_ring_wrapped": (2, 1, 4, 2, 32, 16, [19], RING_WRAPPED, True, 0),
    "decode_ring_unwritten": (2, 1, 4, 2, 32, 16, [9], RING_PARTIAL, True, 0),
    "cuda_0": (2, 8, 4, 2, 32, 8, range(8), range(8), True, 0),
    "cuda_1": (2, 8, 4, 4, 64, 8, range(8), range(8), True, 3),
    "cuda_2": (3, 5, 6, 3, 48, 70, range(60, 65), _ring(70, 65), True, 0),
    "cuda_3": (2, 1, 8, 2, 64, 40, [44], _ring(40, 45), True, 0),
    "cuda_4": (2, 1, 8, 2, 64, 160, [29], _ring(160, 30), True, 8),
    "granite_prefill": (4, 64, 32, 8, 64, 96, range(64), _ring(96, 64), True, 0),
    "granite_decode_160": (4, 1, 32, 8, 64, 160, [95], _ring(160, 96), True, 0),
    "moe_decode": (4, 1, 24, 8, 64, 96, [79], _ring(96, 80), True, 0),
    "ring_512": (1, 512, 24, 8, 64, 512, range(512), _ring(512, 512), True, 0),
    "dh37_G8": (1, 3, 16, 2, 37, 70, range(40, 43), _ring(70, 43), True, 0),
    "dh256": (1, 2, 4, 1, 256, 67, range(60, 62), _ring(67, 62), True, 0),
    "whisper_encoder": (1, 1500, 2, 2, 64, 1500, range(1500), range(1500), False, 0),
    "whisper_cross_prefill": (4, 4, 8, 8, 64, 1500, range(4), range(1500), False, 0),
    "whisper_cross_decode": (4, 1, 8, 8, 64, 1500, [4], range(1500), False, 0),
    "bidir_G2": (2, 8, 4, 2, 32, 8, range(8), range(8), False, 0),
    "bidir_cross_S6_T70": (1, 6, 4, 4, 32, 70, range(6), range(70), False, 0),
    "bidir_unwritten": (2, 3, 4, 2, 32, 16, range(3), RING_PARTIAL, False, 0),
    # heads of 128 (two whole value chunks) and 160 (a ragged chunk of 32):
    # llava-next-34b's G = 7 at a short prefill over a ring, qwen2.5-32b's
    # decode (G = 5), stablelm-12b's G = 4 at prefill and at a windowed
    # decode over a ring of 160
    "dh128_G7_prefill": (1, 9, 14, 2, 128, 40, range(31, 40), _ring(40, 40), True, 0),
    "dh128_G5_decode": (2, 1, 10, 2, 128, 96, [79], _ring(96, 80), True, 0),
    "dh160_G4_prefill": (2, 6, 8, 2, 160, 70, range(60, 66), _ring(70, 66), True, 0),
    "dh160_G4_decode_window": (2, 1, 8, 2, 160, 160, [95], _ring(160, 96), True, 8),
}
# the shapes small enough for the kernel's order in torch
TWIN_SHAPES = ["prefill_causal_G2", "prefill_window3", "decode_ring_wrapped",
               "decode_ring_unwritten", "cuda_2", "dh37_G8", "bidir_G2", "bidir_cross_S6_T70",
               "bidir_unwritten", "dh160_G4_prefill"]


def _shape(name):
    B, S, H, KV, dh, T, _, _, causal, _ = SHAPES[name]
    return attn.AttnShape(B, S, H, KV, T, dh, causal)


def _lut(name="afm16", packed=True):
    table = lutgen.get_packed_lut(name) if packed else lutgen.get_lut(name)
    return lut_tensor(table, "cpu"), get_multiplier(name).mantissa_bits


def _plans(shape, lut):
    """The shape's own plan, then every tile the kernel takes.  The table
    form and the layout (a K chunk's dims, a V slab's keys, where the scores
    live) do not enter the walk: the K chunks and V slabs of a tile only
    split its folds, in order."""
    plans = [attn.attention_plan(shape, lut, SMS)]
    for tile in range(len(attn.ATTN_TILES)):
        plans.append(attn._tile_plan(shape, tile, "smem packed", (min(shape.dh, 64), 64, True),
                                     plans[0].path))
    return plans


def _covered(plan, shape):
    """(scores, outputs): how often the kernel's walk computes and writes
    each score (b, kv-head, group row, key) and each output (b, kv-head,
    group row, dim); group row s * G + g is position s, head kv-head * G +
    g."""
    rows = shape.S * (shape.H // shape.KV)
    slab = np.zeros((plan.rows, plan.key_slab), np.int32)    # a tile's K slab
    chunk = np.zeros((plan.rows, attn.DIM_CHUNK), np.int32)  # a tile's value chunk
    for _, rr, keys, dims in attn.attention_threads(plan):
        for r in rr:
            slab[r, list(keys)] += 1
            chunk[r, list(dims)] += 1
    scores = np.zeros((shape.B, shape.KV, rows, shape.T), np.int32)
    outs = np.zeros((shape.B, shape.KV, rows, shape.dh), np.int32)
    for _, b, kvh, r0, r1 in attn.attention_tiles(plan, shape, 7):
        for t0 in range(0, shape.T, plan.key_slab):
            t1 = min(t0 + plan.key_slab, shape.T)
            scores[b, kvh, r0:r1, t0:t1] += slab[:r1 - r0, :t1 - t0]
        for c0 in range(0, shape.dh, attn.DIM_CHUNK):
            vc = min(attn.DIM_CHUNK, shape.dh - c0)   # dims past it are not written
            outs[b, kvh, r0:r1, c0:c0 + vc] += chunk[:r1 - r0, :vc]
    return scores, outs


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_every_score_and_output_is_computed_once_under_every_plan(name):
    shape = _shape(name)
    lut, _ = _lut()
    for plan in _plans(shape, lut):
        scores, outs = _covered(plan, shape)
        assert (scores == 1).all() and (outs == 1).all(), plan


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tiles_walk_heavy_row_tiles_first_and_blocks_stride(name):
    """Tile t of the walk is row tile (row tiles - 1 - t // groups) of group
    t % groups, and block i takes tiles i, i + blocks, ..."""
    shape = _shape(name)
    lut, _ = _lut()
    plan = attn.attention_plan(shape, lut, SMS)
    tiles = attn.attention_tiles(plan, shape, 5)
    groups = shape.B * shape.KV
    assert len(tiles) == plan.tiles
    for t, (block, b, kvh, r0, _) in enumerate(tiles):
        assert block == t % 5 and b * shape.KV + kvh == t % groups
        assert r0 == (plan.tiles // groups - 1 - t // groups) * plan.rows


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_fits_a_block_and_picks_the_decode_tile_for_one_token(name):
    shape = _shape(name)
    for lut_name, packed in (("afm16", True), ("afm16", False), ("afm10", True)):
        lut, _ = _lut(lut_name, packed)
        plan = attn.attention_plan(shape, lut, SMS)
        nbytes = lut.numel() * lut.element_size()
        smem = attn._table_bytes(plan.table, packed, nbytes) + attn.attention_smem_bytes(
            plan.rows, plan.key_slab, shape.dh, shape.T, plan.dim_chunk, plan.value_slab,
            plan.scores == "shared")
        assert smem <= attn.SMEM_BLOCK_MAX, (plan, smem)
        assert (plan.path == "decode") == (shape.S == 1)
        if shape.S == 1:
            assert plan.tile == attn.DECODE_TILE
        assert plan.table.startswith("smem") == (nbytes <= 128 * 1024)


def test_plans_at_the_serving_shapes():
    """The picks of the fitted rates, which the sweeps measured fastest:
    granite-3-2b's prefill in tiles of 32 rows, two an SM beside the packed
    table; its decode and granite-moe's a tile a group; the prefill of 512
    in tiles of 16 rows with its scores in shared memory; with afm10's
    table in global memory tiles of 16 rows at the short prefill and of 4
    at 512 (one q row a warp: a gather reads one row of the table)."""
    lut, _ = _lut()
    pre = attn.attention_plan(_shape("granite_prefill"), lut, SMS)
    assert (pre.rows, pre.tiles, pre.scores, pre.table) == (32, 256, "shared", "smem packed")
    for name in ("granite_decode_160", "moe_decode"):
        plan = attn.attention_plan(_shape(name), lut, SMS)
        assert (plan.rows, plan.tiles, plan.table) == (4, 32, "smem packed")
    long = attn.attention_plan(_shape("ring_512"), lut, SMS)
    assert (long.rows, long.scores) == (16, "shared")
    lut10, _ = _lut("afm10")
    assert attn.attention_plan(_shape("granite_prefill"), lut10, SMS).rows == 16
    assert attn.attention_plan(_shape("ring_512"), lut10, SMS).rows == 4


def test_bidirectional_plans_count_every_key():
    """A bidirectional tile folds every slab of its T keys (a causal one
    about S / 2 + KB / 2): the cost the plan ranks tiles by.  At
    whisper-base's encoder (4 x 1500 over 1500 frames, 8 heads of 64) under
    afm16 that picks tiles of 64 rows, their scores (384 KiB) in the global
    scratch; a cross decode step takes the decode tile, a cross prefill of
    4 tokens tiles of 4 rows, the scores of 1500 keys in shared memory."""
    for causal, want in ((True, 1000 // 2 + 64 // 2), (False, 1536)):
        assert attn._made_keys(attn.AttnShape(4, 1000, 8, 8, 1500, 64, causal), 64) == want
    lut, _ = _lut()
    enc = attn.attention_plan(attn.AttnShape(4, 1500, 8, 8, 1500, 64, False), lut, SMS)
    assert (enc.rows, enc.scores, enc.table) == (64, "global", "smem packed")
    step = attn.attention_plan(_shape("whisper_cross_decode"), lut, SMS)
    assert (step.path, step.rows, step.scores) == ("decode", 4, "shared")
    pre = attn.attention_plan(_shape("whisper_cross_prefill"), lut, SMS)
    assert (pre.path, pre.rows, pre.scores) == ("prefill", 4, "shared")


@pytest.mark.parametrize("rows", [1, 2, 4, 8, 9, 32])
@pytest.mark.parametrize("T", [20, 96, 128, 160, 4096])
@pytest.mark.parametrize("dh", [37, 64, 128, 160, 256])
def test_attention_phase_fits_the_fold_buffers(rows, T, dh):
    """fused_attn_out_mlp's attention phase lays its tile out in the fold
    buffers of its rows: scores in shared memory up to a ring of 128 at
    granite-3-2b's 4 rows (K chunks of half a value chunk), in global
    memory past what fits."""
    lut, _ = _lut()
    plan = decode_chain.attention_phase_plan(rows, 32, 8, T, dh, lut)
    smem = attn.attention_smem_bytes(plan.rows, plan.key_slab, dh, T, plan.dim_chunk,
                                     plan.value_slab, plan.scores == "shared")
    assert smem <= decode_chain.fold_bytes(rows)
    assert plan.tiles == rows * 8 and plan.table == "smem packed"
    if rows >= 4 and T <= 128:
        assert plan.scores == "shared" and plan.dim_chunk >= min(dh, 64) // 2
        assert plan.value_slab >= 64


# The new heads' launches at the zoo's full widths: (label, AttnShape).
# llava-next-34b: 56 heads of 128 over 8 KV heads (G = 7), a prefill of
# 2880 patches and 64 text tokens into a ring of 2976 and a decode step over
# it; qwen2.5-32b (G = 5) and qwen1.5-110b (G = 8) at 4 x 64 into a ring of
# 96 and a decode step; stablelm-12b, 32 heads of 160 (G = 4), the same.
ZOO_SHAPES = [
    ("llava prefill 1 x 2944", attn.AttnShape(1, 2944, 56, 8, 2976, 128)),
    ("llava decode over 2976", attn.AttnShape(1, 1, 56, 8, 2976, 128)),
    ("qwen2.5 prefill 4 x 64", attn.AttnShape(4, 64, 40, 8, 96, 128)),
    ("qwen2.5 decode over 96", attn.AttnShape(4, 1, 40, 8, 96, 128)),
    ("qwen1.5 prefill 4 x 64", attn.AttnShape(4, 64, 64, 8, 96, 128)),
    ("stablelm prefill 4 x 64", attn.AttnShape(4, 64, 32, 8, 96, 160)),
    ("stablelm decode over 160", attn.AttnShape(4, 1, 32, 8, 160, 160)),
]


@pytest.mark.parametrize("label,shape", ZOO_SHAPES, ids=[z[0] for z in ZOO_SHAPES])
def test_heads_of_128_and_160_fit_a_block_under_every_tile_and_table(label, shape):
    """Every tile x table form the kernel may take at a zoo shape has a
    layout that fits ``SMEM_BLOCK_MAX`` beside its table, and so does the
    plan's own pick, for afm16 packed and canonical and afm10 (global
    memory).  K chunks take at most 64 dims of the head, so a head of 160
    ends on a chunk of 32.  llava's 2944-row prefill keeps its scores (R x
    2976 floats a tile) in the global scratch under the plan's pick."""
    for lut_name, packed in (("afm16", True), ("afm16", False), ("afm10", True)):
        lut, _ = _lut(lut_name, packed)
        nbytes = lut.numel() * lut.element_size()
        plan = attn.attention_plan(shape, lut, SMS)
        forms = [(plan.tile, plan.table)]
        if shape.S > 1:
            forms += [(tile, table) for tile in range(len(attn.ATTN_TILES))
                      for table in ("smem canonical", "smem packed")
                      if packed and 2 * nbytes <= 128 * 1024 or table == plan.table]
        for tile, table in forms:
            space = attn.SMEM_BLOCK_MAX - attn._table_bytes(table, packed, nbytes)
            layout = attn.attention_layout(tile, shape.dh, shape.T, space)
            assert layout is not None, (label, tile, table)
            cw, vkb, scores_smem = layout
            rows, kb = attn.tile_rows_keys(tile)
            assert cw <= attn.DIM_CHUNK and shape.dh % cw in (0, 32), (label, layout)
            assert attn.attention_smem_bytes(rows, kb, shape.dh, shape.T, *layout) <= space
            if scores_smem:
                assert 4 * rows * shape.T <= space
        if label.startswith("llava prefill"):
            assert plan.scores == "global" and plan.path == "prefill"
        assert (plan.path == "decode") == (shape.S == 1)


@pytest.mark.parametrize("rows", [1, 4, 8])
@pytest.mark.parametrize("dh,T", [(128, 96), (128, 128), (160, 96), (160, 128), (128, 2976)])
def test_attention_phase_at_the_new_heads(rows, dh, T):
    """``fused_attn_out_mlp``'s attention phase at heads of 128 (qwen2.5's
    40 / 8 heads) and 160 (stablelm's 32 / 8) in the fold buffers of its
    rows, for afm16 packed and afm10: it fits them, takes a tile for each
    4 heads of a group (G = 5 at qwen2.5: two), and keeps its scores in
    shared memory at rings of at most 128 and 4 rows or more."""
    H = 40 if dh == 128 else 32
    for lut_name in ("afm16", "afm10"):
        lut, _ = _lut(lut_name)
        plan = decode_chain.attention_phase_plan(rows, H, 8, T, dh, lut)
        smem = attn.attention_smem_bytes(plan.rows, plan.key_slab, dh, T, plan.dim_chunk,
                                         plan.value_slab, plan.scores == "shared")
        assert smem <= decode_chain.fold_bytes(rows), (lut_name, plan)
        assert plan.tiles == rows * 8 * -(-(H // 8) // 4)
        if rows >= 4 and T <= 128:
            assert plan.scores == "shared"


def _inputs(name, seed, special=False):
    B, S, H, KV, dh, T, q_pos, k_pos, causal, window = SHAPES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, dh)).astype(np.float32)
    k_pos = np.asarray(list(k_pos), np.int32)
    if special:
        for a in (q, k, v):   # zeros, -0.0 and subnormals anywhere
            pick = rng.integers(0, 8, a.shape)
            a[pick == 0] = 0.0
            a[pick == 1] = -0.0
            a[pick == 2] *= 1e-39
        unwritten = k_pos < 0   # inf and NaN only where no key is valid
        for a in (k, v):
            pick = rng.integers(0, 3, a.shape)[:, unwritten]
            a[:, unwritten] = np.where(pick == 0, np.inf, np.where(pick == 1, -np.inf, np.nan))
    arrays = [torch.from_numpy(a) for a in (q, k, v, np.asarray(list(q_pos), np.int32), k_pos)]
    return arrays, dict(causal=causal, window=window)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _twin_plans():
    """(rows, K slab keys, V slab keys) of the tiles the kernel takes, with
    the V slab of the tile's K slab and of 16 keys; then slabs of 8 keys,
    so that the shapes here have several slabs to skip or fold."""
    tiles = [attn.tile_rows_keys(tile) for tile in range(len(attn.ATTN_TILES))]
    return [(rows, kb, vkb) for rows, kb in tiles for vkb in (kb, 16)] + [(4, 8, 8), (16, 8, 4)]


@pytest.mark.parametrize("name", TWIN_SHAPES)
@pytest.mark.parametrize("special", [False, True])
def test_kernel_order_in_torch_gives_the_plain_versions_bits(name, special):
    arrays, kw = _inputs(name, seed=11, special=special)
    lut, M = _lut()
    ref = attn.approx_attention_plain(*arrays, lut, M, **kw)
    for rows, kb, vkb in _twin_plans():
        out, _ = ref_attention_tiled(*arrays, lut, M, rows=rows, key_slab=kb, value_slab=vkb,
                                     **kw)
        assert torch.equal(_bits(out), _bits(ref)), (rows, kb, vkb)


@pytest.mark.parametrize("name", TWIN_SHAPES)
def test_kernel_order_never_skips_a_valid_key(name):
    """A skipped K slab holds no valid key of its tile's rows; a skipped V
    slab has p = +0.0 on every row of its tile (so no row of it lacks a
    valid key)."""
    arrays, kw = _inputs(name, seed=12)
    q, k, v, q_pos, k_pos = arrays
    lut, M = _lut()
    G = q.shape[2] // k.shape[2]
    mask = attention_mask(q_pos.repeat_interleave(G), k_pos, **kw)
    for rows, kb, vkb in _twin_plans():
        _, skipped = ref_attention_tiled(*arrays, lut, M, rows=rows, key_slab=kb,
                                         value_slab=vkb, **kw)
        for what, _, _, r0, t0 in skipped:
            if what == "scores":
                assert not mask[r0:r0 + rows, t0:t0 + kb].any(), (r0, t0)
            else:
                assert mask[r0:r0 + rows].any(dim=1).all(), (r0, t0)


def test_row_without_a_valid_key_gets_the_mean_of_v_in_the_kernel_order():
    """A prefill longer than the ring: positions 0-3 lost their keys.  Their
    tile's V slabs are all folded (p = 1/T on every key) and the bits are
    the plain version's."""
    rng = np.random.default_rng(13)
    B, S, H, KV, dh, T = 1, 12, 4, 2, 16, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, S, H, dh), (B, T, KV, dh), (B, T, KV, dh)))
    q_pos = torch.arange(S, dtype=torch.int32)
    k_pos = torch.from_numpy(_ring(T, S).astype(np.int32))
    lut, M = _lut()
    ref = attn.approx_attention_plain(q, k, v, q_pos, k_pos, lut, M, causal=True, window=0)
    for rows in (4, 16, 64):
        out, skipped = ref_attention_tiled(q, k, v, q_pos, k_pos, lut, M, causal=True, window=0,
                                           rows=rows, key_slab=4, value_slab=4)
        assert torch.equal(_bits(out), _bits(ref))
        assert not [s for s in skipped if s[0] == "values" and s[3] < 8], skipped
    assert torch.isfinite(ref).all() and ref[0, :4].abs().amax() > 0
