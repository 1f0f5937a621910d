"""Fused LUT attention: score GEMM, scale, position mask, row softmax and
value GEMM in one CUDA launch.

``approx_attention`` computes softmax(mask(q k^T / sqrt(dh))) v with both
contractions simulated by AMSim (``csrc/approx_attention.cu``; it
replaces the TPU kernel ``repro/kernels/approx_attention.py:_attn_kernel``).
q is (B, S, H, dh), k and v (B, T, KV, dh) with H = KV * G (grouped-query
heads), q_pos (S,) and k_pos (T,) absolute positions shared by the batch,
or q_pos (B, S) and k_pos (B, T), one row of positions a batch row (the
paged serving cache, where every slot sits at its own position; the
kernel reads row b's at a batch stride, and positions that agree across
rows give the bits of shared ones).  A negative k_pos is an unwritten
ring-cache slot or paged position, masked.  On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it runs ``approx_attention_plain``,
which the kernel agrees with bit for bit:

* each score folds dh products in order from +0.0 and is divided by
  sqrt(dh) (a division, as in JAX); masked keys score ``NEG_INF``;
* the softmax subtracts the row max, takes ``exp``, and divides by the
  denominator summed in the warp order of ``common.lane_sum``;
* each output folds the T products p_t * v_t in key order from +0.0.

A row with no valid key (only reachable when a prefill longer than the
ring evicts a query's own keys) has every score at ``NEG_INF``, so its
softmax is uniform and it returns the mean of V through the LUT -- what
the JAX einsum lowering (``ops.attend_einsum``) returns.  The JAX kernel
returns zeros there instead; such rows carry no context under any
lowering.

A block of the kernel takes a tile: one group (b, kv-head), whose G query
heads share one K and one V, and R of its S x G query rows (row s * G + g
is position s, head kv-head * G + g).  It skips a K slab (64 or 128 keys)
where no row of the tile has a valid key, and a V slab where every probability
of the tile's rows is exactly +0.0.  Both are exact: a skipped score is
``NEG_INF`` either way, and a skipped product is amsim(+0, v) = +-0, which
never changes a sum that started at +0.0.  So decode cost scales with the
live keys, not the ring's capacity, and a causal prefill's tiles stop at
their diagonal.  ``ref.ref_attention_tiled`` is the kernel's order in
torch, tile by tile.

``attention_plan`` is the launch's plan, made on the host from the shape,
the table and the card's SM count: the path (tiles of 64, 32 or 16 query
rows at prefill, the heads of a group at decode), the shared-memory
layout (``attention_layout``: a K chunk's dims, a V slab's keys, the
scores in shared or global memory) and where and in which form the kernel
reads the table.  The C launch sizes the grid; ``attention_grid`` asks it
for that without launching, ``attention_tiles`` lists which block
computes which rows of which group and ``attention_threads`` which rows,
keys and dims each thread of a tile computes.  No shape needs a guard or
a fallback.

``approx_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .approx_gemm import TABLES, _ceil, _sms
from .common import (NEG_INF, SMEM_LUT_MAX_BYTES, attention_mask, call_kernel, check_contiguous,
                     check_float32, check_lut, device_float, lane_sum, lut_bytes, operand_device)
from .ref import ref_amsim_gemm

MAX_DH = 256             # head dims the kernels take
ATTN_THREADS = 256       # a block
DIM_CHUNK = 64           # dims of a value chunk (and of a K chunk at most)
# The tiles the kernel takes (csrc/approx_attention.cu with_tile, in that
# order): (RT row threads, TM rows a thread, TN keys a thread).  The KT =
# 256 / RT lanes of a row thread run along the keys (TN each: KT x TN keys
# a K slab) and along the dims of the value pass (DN = 64 / KT each); a
# tile has R = RT x TM rows.
ATTN_TILES = ((16, 4, 4), (16, 2, 4), (8, 2, 2), (4, 1, 2))
DECODE_TILE = 3          # the heads of a group (G <= 4 a tile), decode_chain's attention phase
SMEM_BLOCK_MAX = 232_448     # shared bytes a block may take on Hopper
SMEM_SM = 233_472            # shared bytes of an SM, a block's 1 KiB reserve included
MAX_BLOCKS_PER_SM = 8        # 2048 resident threads an SM, 256 a block
# Rows x keys a tile folds (scores and values) a microsecond on an SM that
# runs one tile at a time, by the form the kernel reads the table in and the
# tile (ATTN_TILES order); an SM running c >= 2 tiles at once is
# ATTN_TOGETHER[c] times as fast.  Fitted to the tile sweeps of
# ``time_chain.py --attn-sweep`` at granite-3-2b's prefill and
# granite-moe-3b-a800m's 4 x 512 prefill (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md), which they rank as measured.
ATTN_RATE = {"smem canonical": (54.0, 41.7, 47.0, 40.5),
             "smem packed": (52.2, 48.3, 42.1, 40.8),
             "global": (16.1, 12.8, 14.1, 18.6)}
ATTN_TOGETHER = {1: 1.0, 2: 1.35}
ATTN_TOGETHER_MORE = 1.5     # three tiles or more


def softmax_scores(scores: torch.Tensor, mask: torch.Tensor, dh: int) -> torch.Tensor:
    """probs = softmax(where(mask, scores / sqrt(dh), NEG_INF)) over the
    last dim, in the kernels' arithmetic: a true division by sqrt(dh), the
    row max, ``exp``, and the ``lane_sum`` denominator."""
    s = torch.where(mask, scores / device_float(float(dh), scores.device).sqrt(), NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / lane_sum(e)[..., None]


def approx_attention_plain(q, k, v, q_pos, k_pos, lut, M: int, *, causal: bool,
                           window: int):
    """The kernel's plain PyTorch version: two batched sequential-k LUT
    GEMMs around ``softmax_scores`` (the twin of ``ops.attend_einsum``
    under ``amsim_torch``)."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, dh).permute(0, 2, 1, 3, 4).reshape(B, KV, S * G, dh)
    scores = ref_amsim_gemm(qg, k.permute(0, 2, 3, 1), lut, M).reshape(B, KV, S, G, T)
    mask = attention_mask(q_pos, k_pos, causal=causal, window=window)
    # (S, T) broadcasts over (B, KV, G); a per-row (B, S, T) over (KV, G)
    mask = mask[:, None, :] if mask.ndim == 2 else mask[:, None, :, None, :]
    probs = softmax_scores(scores, mask, dh).reshape(B, KV, S * G, T)
    out = ref_amsim_gemm(probs, v.permute(0, 2, 1, 3), lut, M).reshape(B, KV, S, G, dh)
    return out.permute(0, 2, 1, 3, 4).reshape(B, S, H, dh)


def check_attention_operands(q, k, v, q_pos, k_pos):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"attention takes q (B,S,H,dh), k/v (B,T,KV,dh) with KV | H, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, T = q.shape[0], q.shape[1], k.shape[1]
    if (q_pos.shape, k_pos.shape) not in (((S,), (T,)), ((B, S), (B, T))):
        raise ValueError(f"positions must be q_pos (S,) and k_pos (T,), or (B, S) and (B, T), "
                         f"got {tuple(q_pos.shape)} and {tuple(k_pos.shape)}")
    if q.shape[3] > MAX_DH:
        raise ValueError(f"head dim {q.shape[3]} > {MAX_DH}")
    check_float32(q, k, v)


# ------------------------------------------------------------------ the plan
class AttnShape(NamedTuple):
    """An attention launch's geometry: q (B, S, H, dh), k/v (B, T, KV, dh),
    and whether its mask is causal (``dims`` drops it: the C entry points
    take the six dims, and ``causal`` apart)."""
    B: int
    S: int
    H: int
    KV: int
    T: int
    dh: int
    causal: bool = True

    @property
    def dims(self) -> tuple:
        return tuple(self[:6])


def attention_shape(q_shape, k_shape, causal: bool = True) -> AttnShape:
    B, S, H, dh = q_shape
    return AttnShape(B, S, H, k_shape[2], k_shape[1], dh, bool(causal))


def _odd(n: int) -> int:
    return n | 1


def tile_rows_keys(tile: int) -> tuple:
    """(R rows, KB keys of a K slab) of tile ``tile``."""
    rt, tm, tn = ATTN_TILES[tile]
    return rt * tm, ATTN_THREADS // rt * tn


def attention_smem_bytes(rows: int, key_slab: int, dh: int, T: int, cw: int, vkb: int,
                         scores_smem: bool) -> int:
    """A tile's shared bytes after the table (``attention.cuh``
    ``attn_smem_bytes``): the rows' positions, Q decoded (R x odd(dh) uint2
    words, at least R x KB: p of a V slab reuses it), a K chunk (KB keys x
    odd(cw)) or a V slab (vkb keys x odd(min(dh, 64))), and the scores
    (R x T floats) when in shared memory."""
    def a16(n):
        return _ceil(n, 16) * 16
    q_words = rows * max(_odd(dh), key_slab)
    kv_words = max(key_slab * _odd(cw), vkb * _odd(min(dh, DIM_CHUNK)))
    return a16(rows * 4) + 8 * q_words + 8 * kv_words + (a16(4 * rows * T) if scores_smem else 0)


def attention_layout(tile: int, dh: int, T: int, space: int):
    """(cw, vkb, scores_smem) of tile ``tile`` in ``space`` shared bytes:
    the scores in shared memory where they fit, else in a global scratch; a
    K chunk of min(dh, 64) dims and a V slab of 64 keys (of a K slab, up to
    128, where the rows' scores fit beside it), or halves or quarters of
    both where those do not fit.  None when nothing fits."""
    rows, key_slab = tile_rows_keys(tile)
    for scores_smem in (True, False):
        for shrink in (1, 2, 4):
            cw = max(1, min(dh, DIM_CHUNK) // shrink)
            for vkb in dict.fromkeys((key_slab // shrink, 64 // shrink)):
                if attention_smem_bytes(rows, key_slab, dh, T, cw, vkb, scores_smem) <= space:
                    return cw, vkb, scores_smem
    return None


@dataclass(frozen=True)
class AttnPlan:
    path: str            # "prefill" (tiles of query rows) or "decode" (the heads of a group)
    tile: int            # index into ATTN_TILES
    threads: tuple       # (RT row threads, KT lanes)
    thread_tile: tuple   # (TM rows, TN keys) a thread scores; it folds TM rows x DN dims
    rows: int            # R: query rows a tile
    key_slab: int        # KB = KT x TN: keys of a K slab
    dim_chunk: int       # cw: dims of a K chunk
    value_slab: int      # vkb: keys of a V slab
    scores: str          # "shared" or "global"
    table: str           # one of approx_gemm.TABLES
    tiles: int

    @property
    def dims(self) -> int:
        """DN: dims a thread holds in a value chunk of 64."""
        return DIM_CHUNK // self.threads[1]

    def __str__(self):
        return (f"{self.path} tiles of {self.rows} rows ({self.thread_tile[0]}x"
                f"{self.thread_tile[1]} a thread, {self.threads[0]}x{self.threads[1]} threads), "
                f"{self.tiles} tiles, K slabs of {self.key_slab} keys x {self.dim_chunk} dims, "
                f"V slabs of {self.value_slab} keys, scores in {self.scores} memory, "
                f"table {self.table}")


def _tile_plan(shape: AttnShape, tile: int, table: str, layout, path: str) -> AttnPlan:
    rt, tm, tn = ATTN_TILES[tile]
    rows, key_slab = tile_rows_keys(tile)
    tiles = shape.B * shape.KV * _ceil(shape.S * (shape.H // shape.KV), rows)
    cw, vkb, scores_smem = layout
    return AttnPlan(path, tile, (rt, ATTN_THREADS // rt), (tm, tn), rows, key_slab, cw, vkb,
                    "shared" if scores_smem else "global", table, tiles)


def _table_bytes(table: str, packed: bool, nbytes: int) -> int:
    if table == "smem canonical":
        return nbytes * (2 if packed else 1)
    return nbytes if table == "smem packed" else 0


def _made_keys(shape: AttnShape, key_slab: int) -> int:
    """Keys a prefill tile folds, on average.  Causal, where its queries are
    the last S positions of a ring: its slabs up to its last query's
    position, S / 2 + KB / 2 past the first, and at least one slab.
    Bidirectional: every slab of the T keys."""
    every = _ceil(shape.T, key_slab) * key_slab
    if not shape.causal:
        return every
    return min(every, max(key_slab, shape.S // 2 + key_slab // 2))


@functools.lru_cache(maxsize=4096)
def _attention_plan(shape: AttnShape, packed: bool, nbytes: int, sms: int) -> AttnPlan:
    stored = ("smem packed" if packed else "smem canonical") if nbytes <= SMEM_LUT_MAX_BYTES \
        else ("global packed" if packed else "global canonical")
    if shape.S == 1:
        # decode: a few products a key; staging the table as stored is cheapest
        space = SMEM_BLOCK_MAX - _table_bytes(stored, packed, nbytes)
        layout = attention_layout(DECODE_TILE, shape.dh, shape.T, space)
        return _tile_plan(shape, DECODE_TILE, stored, layout, "decode")
    tables = [stored]
    if packed and 2 * nbytes <= SMEM_LUT_MAX_BYTES:
        tables.insert(0, "smem canonical")      # expanded: no unpacking a product
    best = None
    for tile in range(len(ATTN_TILES)):
        rows, key_slab = tile_rows_keys(tile)
        for table in tables:
            table_bytes = _table_bytes(table, packed, nbytes)
            layout = attention_layout(tile, shape.dh, shape.T, SMEM_BLOCK_MAX - table_bytes)
            if layout is None:
                continue
            plan = _tile_plan(shape, tile, table, layout, "prefill")
            smem = table_bytes + attention_smem_bytes(rows, key_slab, shape.dh, shape.T, *layout)
            per_sm = _ceil(plan.tiles, sms)
            together = min(per_sm, SMEM_SM // (smem + 1024), MAX_BLOCKS_PER_SM)
            rate = (ATTN_RATE[table if table.startswith("smem") else "global"][tile]
                    * ATTN_TOGETHER.get(together, ATTN_TOGETHER_MORE))
            cost = per_sm * rows * _made_keys(shape, key_slab) / rate
            if best is None or cost < best[0]:
                best = (cost, plan)
    return best[1]


def attention_plan(shape: AttnShape, lut: torch.Tensor, sms: int) -> AttnPlan:
    """The launch plan of an attention of ``shape`` with the table ``lut``
    (kernel storage) on a card of ``sms`` SMs.  Decode (S = 1): tiles of
    the G heads of a group (4 a tile), the table as stored (in shared
    memory up to 128 KiB).  Prefill: of the tiles ``ATTN_TILES`` and the
    table forms (a packed table expanded to canonical words where twice it
    fits in 128 KiB, or as stored), the one whose busiest SM takes the
    least time: its tiles (tile t on SM t % sms) x rows x the keys a tile
    folds (``_made_keys``) at the rate of the tile and table form
    (``ATTN_RATE``), faster where the SM holds tiles together
    (``ATTN_TOGETHER``, by the blocks its shared memory fits).  The layout
    of each is ``attention_layout`` in the shared memory the table
    leaves."""
    return _attention_plan(shape, lut.dtype == torch.int16, lut_bytes(lut), sms)


def _plan_args(plan: AttnPlan, lut: torch.Tensor):
    return (int(lut.dtype == torch.int16), TABLES.index(plan.table), plan.tile, plan.dim_chunk,
            plan.value_slab, int(plan.scores == "shared"))


def attention_grid(plan: AttnPlan, shape: AttnShape, lut: torch.Tensor) -> dict:
    """The grid that an attention launch of ``plan`` at ``shape`` takes on
    the current card, without launching: ``blocks``, ``tiles`` and ``smem``
    (a block's shared bytes).  ``lut`` is the CUDA table it would read."""
    out = (ctypes.c_longlong * 3)()
    M = (lut.numel().bit_length() - 1) // 2      # the table has 2^(2M) entries
    call_kernel("approx_attention", "approx_attention_grid", lut.device, *shape.dims, M,
                *_plan_args(plan, lut), out)
    return dict(zip(("blocks", "tiles", "smem"), out))


def attention_tiles(plan: AttnPlan, shape: AttnShape, blocks: int):
    """[(block, b, kvh, r0, r1) of every tile] in the kernel's walk over a
    grid of ``blocks``: tile t is row tile (row tiles - 1 - t // groups) of
    group t % groups = b * KV + kvh, rows r0 .. r1 of the group's S x G
    (row s * G + g: position s, head kvh * G + g); block i takes tiles i,
    i + blocks, ..."""
    groups = shape.B * shape.KV
    rows = shape.S * (shape.H // shape.KV)
    rtiles = _ceil(rows, plan.rows)
    out = []
    for t in range(groups * rtiles):
        g, j = t % groups, rtiles - 1 - t // groups
        r0 = j * plan.rows
        out.append((t % blocks, g // shape.KV, g % shape.KV, r0, min(r0 + plan.rows, rows)))
    return out


def attention_threads(plan: AttnPlan):
    """[(thread, rows, keys, dims) of every thread of a tile]: the tile rows
    it holds, the keys of a K slab (offsets from the slab's first) it
    scores, and the dims of a value chunk (offsets from the chunk's first)
    it folds.  A tile covers its K slabs at 0, ``key_slab``, ... < T, its V
    slabs at 0, ``value_slab``, ... < T, and value chunks at 0, 64, ... < dh; keys
    past T, dims past the chunk and rows past the tile's last are computed
    and not written."""
    rt_n, kt_n = plan.threads
    tm, tn = plan.thread_tile
    out = []
    for tid in range(ATTN_THREADS):
        rt, kt = divmod(tid, kt_n)
        out.append((tid, tuple(rt * tm + i for i in range(tm)),
                    tuple(kt + kt_n * j for j in range(tn)),
                    tuple(kt + kt_n * j for j in range(plan.dims))))
    return out


def attention_scratch(plan: AttnPlan, T: int, sms: int, device):
    """(scratch, blocks): where ``plan`` keeps the scores in global memory,
    R x T floats for each block the launch can take (no more than its
    tiles, no more than the card holds); else a token tensor and 0."""
    if plan.scores == "shared":
        return torch.empty(1, dtype=torch.float32, device=device), 0
    blocks = min(plan.tiles, sms * MAX_BLOCKS_PER_SM)
    return torch.empty((blocks, plan.rows, T), dtype=torch.float32, device=device), blocks


def approx_attention(q, k, v, q_pos, k_pos, lut, M: int, *, causal: bool = True,
                     window: int = 0) -> torch.Tensor:
    """LUT-simulated attention -> (B, S, H, dh) float32 (see the module
    docstring for the arithmetic).  ``lut`` is the table in kernel storage
    (int16 packed, int32 canonical) on the operands' device."""
    check_attention_operands(q, k, v, q_pos, k_pos)
    check_lut(lut, M)
    device = operand_device(q, k, v, q_pos, k_pos, lut)
    if device.type == "cpu":
        return approx_attention_plain(q, k, v, q_pos, k_pos, lut, M, causal=causal,
                                      window=window)
    q_pos = q_pos.to(torch.int32)
    k_pos = k_pos.to(torch.int32)
    check_contiguous(q, k, v, q_pos, k_pos, lut)
    shape = attention_shape(q.shape, k.shape, causal)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    sms = _sms(device.index)
    plan = attention_plan(shape, lut, sms)
    scratch, scratch_blocks = attention_scratch(plan, shape.T, sms, device)
    call_kernel("approx_attention", "approx_attention_f32", device,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
                lut.data_ptr(), out.data_ptr(), scratch.data_ptr(), *shape.dims, int(causal),
                int(window), int(q_pos.ndim == 2), M, *_plan_args(plan, lut), scratch_blocks)
    approx_attention.launches += 1
    return out


approx_attention.launches = 0
