"""AMDENSE: the LUT-simulated GEMM, a CUDA kernel for Hopper.

``approx_gemm`` computes (m, k) @ (k, n) and ``approx_gemm_batched``
(B, m, k) @ (B, k, n), every product simulated by AMSim, in one launch of
the kernel of ``csrc/approx_gemm.cu`` (they replace the TPU kernels
``repro/kernels/approx_gemm.py:_amsim_kernel`` and
``_amsim_kernel_batched``).  On a CUDA tensor each launches the kernel or
raises.  On a CPU tensor it runs the kernel's plain PyTorch version,
``approx_gemm_plain`` / ``approx_gemm_batched_plain``, which folds k in the
same order, so the two agree bit for bit.

``gemm_plan`` is the launch's plan, made on the host from the shape, the
table and the card's SM count: the path (a register-tiled one, or a
column a thread for m <= ``SMALL_M`` and for products too small for any
register tile), the tile, and where and in which form the kernel reads
the table.  The C launch sizes the grid: as many blocks as fit on the
card, no more than the tiles, which they walk grid-stride.
``gemm_grid`` asks it for that grid without launching; ``gemm_tiles``
lists which block computes which tile.

``approx_gemm.launches`` and ``approx_gemm_batched.launches`` count the
kernel's launches through each wrapper.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .common import (SMEM_LUT_MAX_BYTES, call_kernel, check_contiguous, check_float32,
                     check_lut, lut_bytes, operand_device)
from .ref import ref_amsim_gemm

# The kernel's plain PyTorch version: the same sequential-k fold, batched
# over the leading dim for approx_gemm_batched.
approx_gemm_plain = ref_amsim_gemm
approx_gemm_batched_plain = ref_amsim_gemm

SMALL_M = 8                               # m up to this takes the column path
COLUMN_ROWS = (1, 2, 4, 8)                # rows a column thread holds (m rounded up)
COLUMN_THREADS = (128, 64, 32, 16)        # column path: a column a thread, widest first
TILED = ((8, 2), (4, 2), (2, 1), (1, 1))  # (TM, TN) a thread of 8 x 32: largest first
TILED_THREADS = 256
# A packed table that fits twice in shared memory is expanded to canonical
# words at staging (no unpack a product: ~17% faster at granite-3-2b's
# prefill shapes) where a block's fold is long enough to repay twice the
# staged bytes and the lower occupancy, k >= EXPAND_MIN_K; below it (the
# vision models' short GEMMs) it stays packed.
EXPAND_MIN_K = 512
# Where and in which form the kernel reads the table (csrc TableKind).
TABLES = ("smem canonical", "smem packed", "global canonical", "global packed")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class GemmPlan:
    path: str            # "tiled" or "column"
    rows: int            # tiled: TM rows a thread; column: rows a thread holds
    cols: int            # tiled: TN columns a thread; column: threads (columns) a block
    threads: int         # a block's threads
    tile: tuple          # (rows, columns) of output a tile
    tiles: int           # tiles over the whole batch
    table: str           # one of TABLES
    old_blocks: int      # tiles of the 16x16 grid this kernel replaced

    def __str__(self):
        how = (f"{self.rows}x{self.cols} a thread" if self.path == "tiled"
               else f"{self.tile[0]} rows x 1 column a thread")
        return (f"{self.path} {self.tile[0]}x{self.tile[1]} tiles ({how}), {self.tiles} tiles, "
                f"table {self.table}")


@functools.lru_cache(maxsize=4096)
def _plan(batch: int, m: int, n: int, packed: bool, nbytes: int, sms: int,
          expand: bool) -> GemmPlan:
    old = batch * _ceil(m, 16) * _ceil(n, 16)
    want = min(old, sms)                 # every SM the 16x16 grid kept busy
    if nbytes <= SMEM_LUT_MAX_BYTES:
        canonical = not packed or (expand and 2 * nbytes <= SMEM_LUT_MAX_BYTES)
        table = TABLES[0] if canonical else TABLES[1]
    else:
        table = TABLES[3] if packed else TABLES[2]
    path = "column"
    if m > SMALL_M:
        for rows, cols in TILED:
            tile = (8 * rows, 32 * cols)
            tiles = batch * _ceil(m, tile[0]) * _ceil(n, tile[1])
            if tiles >= want:
                path, threads = "tiled", TILED_THREADS
                break
    if path == "column":
        # The widest block, then the most rows a thread (all m up to
        # SMALL_M); rows of 1 split a narrow product such as the router
        # into short independent sums.  16 threads and 8 rows give at
        # least the 16x16 grid's tiles.
        top = next(r for r in COLUMN_ROWS if r >= min(m, SMALL_M))
        for threads, rows in ((t, r) for t in COLUMN_THREADS
                              for r in reversed(COLUMN_ROWS) if r <= top):
            tiles = batch * _ceil(m, rows) * _ceil(n, threads)
            if tiles >= want:
                break
        cols, tile = threads, (min(m, rows), threads)
    return GemmPlan(path, rows, cols, threads, tile, tiles, table, old)


def gemm_plan(batch: int, m: int, k: int, n: int, lut: torch.Tensor, sms: int) -> GemmPlan:
    """The launch plan of a (batch, m, k) @ (batch, k, n) product with the
    table ``lut`` (kernel storage) on a card of ``sms`` SMs.

    m <= ``SMALL_M`` takes the column path, else the tiled path with the
    largest register tile whose tiles still reach every SM that the old
    16x16 grid kept busy (``min(old_blocks, sms)``), or the column path in
    groups of 8 rows where no register tile does.  The launch gives the
    tiles at least one block an SM, so its blocks reach as many SMs."""
    return _plan(batch, m, n, lut.dtype == torch.int16, lut_bytes(lut), sms,
                 k >= EXPAND_MIN_K)


def gemm_grid(plan: GemmPlan, batch: int, m: int, n: int, lut: torch.Tensor) -> dict:
    """The grid that a launch of ``plan`` at these shapes takes on the
    current card, without launching: ``blocks``, ``tiles`` and ``smem``
    (a block's shared bytes).  ``lut`` is the CUDA table it would read."""
    out = (ctypes.c_longlong * 3)()
    M = (lut.numel().bit_length() - 1) // 2      # the table has 2^(2M) entries
    call_kernel("approx_gemm", "approx_gemm_grid", lut.device, batch, m, n, M,
                int(lut.dtype == torch.int16), TABLES.index(plan.table),
                int(plan.path == "column"), plan.rows, plan.cols, out)
    return dict(zip(("blocks", "tiles", "smem"), out))


def gemm_tiles(plan: GemmPlan, batch: int, m: int, n: int, blocks: int):
    """[(block, batch element, row0, row1, col0, col1)] of every tile, in the
    kernel's walk over a grid of ``blocks``: tile t is batch t // (tiles of
    a product), row tile (t % that) // column tiles, column tile t % column
    tiles; block b takes tiles b, b + blocks, ..."""
    bm, bn = plan.tile
    tm, tn = _ceil(m, bm), _ceil(n, bn)
    out = []
    for t in range(batch * tm * tn):
        e, rest = divmod(t, tm * tn)
        r0, c0 = (rest // tn) * bm, (rest % tn) * bn
        out.append((t % blocks, e, r0, min(r0 + bm, m), c0, min(c0 + bn, n)))
    return out


def live_row_tiles(a: torch.Tensor, plan: GemmPlan) -> tuple[int, int]:
    """(row tiles of a (B, m, k) or (m, k) that hold a row with a non-zero
    exponent field, all row tiles): the kernel computes the first kind and
    writes +0.0 over the others without reading B."""
    a = a.reshape(-1, *a.shape[-2:])
    bm = plan.tile[0]
    live = ((a.contiguous().view(torch.int32) >> 23) & 0xFF).ne(0).any(dim=-1)
    pad = (-live.shape[1]) % bm
    tiles = torch.nn.functional.pad(live, (0, pad)).reshape(live.shape[0], -1, bm).any(dim=-1)
    return int(tiles.sum()), tiles.numel()


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(fn: str, a, b, lut, M, out, batch, m, k, n):
    plan = gemm_plan(batch, m, k, n, lut, _sms(out.device.index))
    call_kernel("approx_gemm", fn, out.device,
                a.data_ptr(), b.data_ptr(), lut.data_ptr(), out.data_ptr(),
                *((batch,) if fn == "approx_gemm_batched_f32" else ()), m, k, n, M,
                int(lut.dtype == torch.int16), TABLES.index(plan.table),
                int(plan.path == "column"), plan.rows, plan.cols)


def approx_gemm(a: torch.Tensor, b: torch.Tensor, lut: torch.Tensor, M: int) -> torch.Tensor:
    """LUT-simulated GEMM: a (m, k) @ b (k, n) -> (m, n), f32 accumulate.

    ``lut`` is the table in kernel storage (``common.lut_tensor``): int16
    for the packed layout, int32 for the canonical one, on the operands'
    device.
    """
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"approx_gemm takes (m, k) @ (k, n), got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    check_float32(a, b)
    check_lut(lut, M)
    device = operand_device(a, b, lut)
    if device.type == "cpu":
        return approx_gemm_plain(a, b, lut, M)
    check_contiguous(a, b, lut)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    _launch("approx_gemm_f32", a, b, lut, M, out, 1, m, k, n)
    approx_gemm.launches += 1
    return out


approx_gemm.launches = 0


def approx_gemm_batched(a: torch.Tensor, b: torch.Tensor, lut: torch.Tensor,
                        M: int) -> torch.Tensor:
    """Batched LUT-simulated GEMM: a (B, m, k) @ b (B, k, n) -> (B, m, n),
    f32 accumulate, one launch for the whole batch with one LUT placement
    (the MoE expert banks: (E, C, d) @ (E, d, F))."""
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"approx_gemm_batched takes (B, m, k) @ (B, k, n), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    check_float32(a, b)
    check_lut(lut, M)
    device = operand_device(a, b, lut)
    if device.type == "cpu":
        return approx_gemm_batched_plain(a, b, lut, M)
    check_contiguous(a, b, lut)
    batch, m, k = a.shape
    n = b.shape[2]
    out = torch.empty((batch, m, n), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    _launch("approx_gemm_batched_f32", a, b, lut, M, out, batch, m, k, n)
    approx_gemm_batched.launches += 1
    return out


approx_gemm_batched.launches = 0
