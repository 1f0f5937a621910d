"""AMCONV2D: the LUT-simulated NHWC convolution and its weight gradient,
two CUDA kernels.

``approx_conv2d_fused`` computes an implicit-GEMM conv with every product
simulated by AMSim (``csrc/approx_conv.cu``; it replaces the TPU kernel
``repro/kernels/approx_conv.py:_amconv_kernel``).  The data gradient dx
runs through it too, as a stride-1 conv of the dilated error
(``ops.py``).  ``approx_conv2d_dw`` computes the weight gradient
(``csrc/approx_conv_dw.cu``; it replaces ``_amconv_dw_kernel``).
Activations are NHWC and weights HWIO, as in the JAX package.  On a CUDA
tensor each wrapper launches its kernel or raises; on a CPU tensor it
runs its plain version (``approx_conv2d_plain``, ``approx_conv2d_dw_plain``:
im2col with (ki, kj, c) columns, then the sequential-k GEMM), which folds
in the kernel's order.

The kernels stage no image, so they take every conv shape: the port needs
no ``fused_supported`` guard and no im2col fallback.

``dw_plan`` is the dw launch's plan, made on the host from the shape, the
table and the card's SM count: the output tile (one tap, TC channels x TO
output channels), hence the path (tiled, or split where the tile holds
fewer outputs than the block has threads), and where and in which form
the kernel reads the table.  The C launch sizes the grid; ``dw_grid`` asks
it for that grid without launching, ``dw_tiles`` lists which block
computes which tile and ``dw_chunks`` the positions each chunk stages.

``approx_conv2d_fused.launches`` and ``approx_conv2d_dw.launches`` count
the kernels' launches.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .approx_gemm import TABLES, _ceil, _sms
from .common import (SMEM_LUT_MAX_BYTES, call_kernel, check_contiguous, check_float32,
                     check_lut, lut_bytes, lut_in_smem, operand_device)
from .ref import ref_amsim_gemm, ref_im2col


# ------------------------------------------------------------------ padding
def conv_pads(h: int, w: int, kh: int, kw: int, stride: int,
              padding) -> tuple[int, int, int, int]:
    """(top, bottom, left, right) pads with XLA's conv semantics.

    "SAME" gives ceil(in / stride) outputs and splits the total pad with
    the extra one low=floor, high=remainder, as ``lax.padtype_to_pads``
    does (asymmetric for even kernels and for stride 2 on even inputs);
    "VALID" pads nothing.  An explicit 4-tuple is passed through.
    """
    if not isinstance(padding, str):
        pt, pb, pl, pr = padding
        return (int(pt), int(pb), int(pl), int(pr))
    mode = padding.upper()
    if mode == "VALID":
        return (0, 0, 0, 0)
    if mode != "SAME":
        raise ValueError(f"padding must be 'SAME', 'VALID' or a 4-tuple, got {padding!r}")
    pads = []
    for size, k in ((h, kh), (w, kw)):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


def conv_out_shape(h: int, w: int, kh: int, kw: int, stride: int,
                   pads: tuple[int, int, int, int]) -> tuple[int, int]:
    pt, pb, pl, pr = pads
    return ((h + pt + pb - kh) // stride + 1,
            (w + pl + pr - kw) // stride + 1)


# ------------------------------------------------------------------ forward
def approx_conv2d_plain(x, w, lut, M: int, stride: int, pads):
    """The kernel's plain PyTorch version: im2col + sequential-k GEMM."""
    n, h, wid, _ = x.shape
    kh, kw, _, o = w.shape
    oh, ow = conv_out_shape(h, wid, kh, kw, stride, pads)
    cols = ref_im2col(x, kh, kw, stride, pads)
    return ref_amsim_gemm(cols, w.reshape(-1, o), lut, M).reshape(n, oh, ow, o)


def approx_conv2d_fused(x: torch.Tensor, w: torch.Tensor, lut: torch.Tensor, M: int, *,
                        stride: int = 1, padding="SAME") -> torch.Tensor:
    """Implicit-GEMM LUT-simulated conv2d: x (N,H,W,C), w (KH,KW,C,O) ->
    (N,OH,OW,O), f32 accumulate.

    ``padding`` is "SAME"/"VALID" or explicit (top, bottom, left, right).
    ``lut`` is the table in kernel storage (int16 packed, int32 canonical).
    """
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"approx_conv2d_fused takes x (N,H,W,C) and w (KH,KW,C,O), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    check_float32(x, w)
    check_lut(lut, M)
    n, h, wid, c = x.shape
    kh, kw, _, o = w.shape
    pads = conv_pads(h, wid, kh, kw, stride, padding)
    if min(pads) < 0:
        raise ValueError(f"pads must be >= 0, got {pads}")
    oh, ow = conv_out_shape(h, wid, kh, kw, stride, pads)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"empty conv output {(oh, ow)} for {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, stride {stride}, pads {pads}")
    device = operand_device(x, w, lut)
    if device.type == "cpu":
        return approx_conv2d_plain(x, w, lut, M, stride, pads)
    check_contiguous(x, w, lut)
    out = torch.empty((n, oh, ow, o), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    call_kernel("approx_conv", "approx_conv2d_f32", device,
                x.data_ptr(), w.data_ptr(), lut.data_ptr(), out.data_ptr(),
                n, h, wid, c, kh, kw, o, stride, pads[0], pads[2], oh, ow, M,
                int(lut.dtype == torch.int16), int(lut_in_smem(lut)), lut_bytes(lut))
    approx_conv2d_fused.launches += 1
    return out


approx_conv2d_fused.launches = 0


# ---------------------------------------------------------- weight gradient
def approx_conv2d_dw_plain(x, g, lut, M: int, kh: int, kw: int, stride: int, pads):
    """The dw kernel's plain PyTorch version: cols^T @ g as a sequential-k
    GEMM, k = (n, oy, ox) row-major."""
    c = x.shape[3]
    o = g.shape[3]
    cols = ref_im2col(x, kh, kw, stride, pads)
    return ref_amsim_gemm(cols.T, g.reshape(-1, o), lut, M).reshape(kh, kw, c, o)


DW_THREADS = 256          # a block's multiplying threads: a tile of as many outputs is tiled
DW_SPLIT_OUTPUTS = (32, 16, 8)   # outputs of a split tile, largest first
DW_SPLIT_COLS = 8         # TO of a split tile
DW_TILED_COLS = 32        # TO of a tiled tile, at most
DW_TILES_PER_SM = 4       # split tiles wanted an SM


def dw_chunk(outputs: int) -> int:
    """Positions a chunk of a tile of ``outputs``: 128 on the split path
    (4, 8 or 16 products a multiplying thread), 32 on the tiled path."""
    return 32 if outputs >= DW_THREADS else 128


def _pow2_at_least(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


@dataclass(frozen=True)
class DwPlan:
    path: str            # "tiled" (a thread an output) or "split" (owners add)
    tile: tuple          # (TC channels, TO output channels) of one tap
    outputs: int         # TC x TO
    chunk: int           # positions a chunk
    tiles: int           # kh * kw * ceil(c / TC) * ceil(o / TO)
    table: str           # one of approx_gemm.TABLES

    def __str__(self):
        return (f"{self.path} {self.tile[0]}x{self.tile[1]} tiles of a tap, {self.tiles} tiles, "
                f"chunks of {self.chunk} positions, table {self.table}")


@functools.lru_cache(maxsize=4096)
def _dw_plan(taps: int, c: int, o: int, packed: bool, nbytes: int, sms: int) -> DwPlan:
    if taps * c * o >= DW_THREADS * sms:
        to = min(DW_TILED_COLS, max(8, _pow2_at_least(o)))
        tc = DW_THREADS // to
    else:
        for outputs in DW_SPLIT_OUTPUTS:
            to = DW_SPLIT_COLS
            tc = outputs // to
            if tc > _pow2_at_least(c):
                continue          # the tile would be mostly past the channels
            if taps * _ceil(c, tc) * _ceil(o, to) >= DW_TILES_PER_SM * sms:
                break
    tiles = taps * _ceil(c, tc) * _ceil(o, to)
    outputs = tc * to
    # The table as stored: a packed one expanded to canonical words would
    # leave room for fewer blocks an SM beside the staging buffers.
    if nbytes <= SMEM_LUT_MAX_BYTES:
        table = TABLES[1] if packed else TABLES[0]
    else:
        table = TABLES[3] if packed else TABLES[2]
    return DwPlan("tiled" if outputs >= DW_THREADS else "split", (tc, to), outputs,
                  dw_chunk(outputs), tiles, table)


def dw_plan(kh: int, kw: int, c: int, o: int, lut: torch.Tensor, sms: int) -> DwPlan:
    """The launch plan of a kh x kw weight gradient of c input and o output
    channels with the table ``lut`` (kernel storage) on a card of ``sms``
    SMs.

    Where the outputs fill a tile of ``DW_THREADS`` on every SM, the tiled
    path (TO = o rounded up to a power of 2 in 8 .. ``DW_TILED_COLS``);
    else the split path, TO = ``DW_SPLIT_COLS``, the largest of
    ``DW_SPLIT_OUTPUTS`` whose tiles reach ``DW_TILES_PER_SM`` an SM, or
    the smallest.  The fold's length does not enter: each output's sum is
    one chain however it is tiled."""
    return _dw_plan(kh * kw, c, o, lut.dtype == torch.int16, lut_bytes(lut), sms)


def dw_grid(plan: DwPlan, kh: int, kw: int, c: int, o: int, lut: torch.Tensor) -> dict:
    """The grid that a dw launch of ``plan`` at these shapes takes on the
    current card, without launching: ``blocks``, ``tiles`` and ``smem`` (a
    block's shared bytes).  ``lut`` is the CUDA table it would read."""
    out = (ctypes.c_longlong * 3)()
    M = (lut.numel().bit_length() - 1) // 2      # the table has 2^(2M) entries
    call_kernel("approx_conv_dw", "approx_conv_dw_grid", lut.device, kh, kw, c, o, M,
                int(lut.dtype == torch.int16), TABLES.index(plan.table), *plan.tile, out)
    return dict(zip(("blocks", "tiles", "smem"), out))


def dw_tiles(plan: DwPlan, kh: int, kw: int, c: int, o: int, blocks: int):
    """[(block, ki, kj, c0, c1, o0, o1) of every tile] in the kernel's walk
    over a grid of ``blocks``: tile t is tap t // (channel tiles x column
    tiles), channel tile (t // column tiles) % channel tiles, column tile
    t % column tiles; block b takes tiles b, b + blocks, ..."""
    tc, to = plan.tile
    ct, ot = _ceil(c, tc), _ceil(o, to)
    out = []
    for t in range(kh * kw * ct * ot):
        tap, rest = divmod(t, ct * ot)
        c0, o0 = (rest // ot) * tc, (rest % ot) * to
        out.append((t % blocks, tap // kw, tap % kw, c0, min(c0 + tc, c), o0, min(o0 + to, o)))
    return out


def dw_chunks(plan: DwPlan, n: int, oh: int, ow: int):
    """[[(n, oy, ox) or None of each of a chunk's positions] of every chunk]
    as the kernel's x staging walks them: a chunk slot's position is divided
    out for chunk 0, then advanced by the chunk's length with a carry into
    the row and one into the image; None past the last position."""
    kc, hw = plan.chunk, oh * ow
    step_n, step_y, step_x = kc // hw, kc % hw // ow, kc % hw % ow
    slots = [[pl // hw, pl % hw // ow, pl % hw % ow] for pl in range(kc)]
    chunks = []
    for _ in range(_ceil(n * hw, kc)):
        chunks.append([tuple(s) if s[0] < n else None for s in slots])
        for s in slots:
            s[2] += step_x
            if s[2] >= ow:
                s[2] -= ow
                s[1] += 1
            s[1] += step_y
            if s[1] >= oh:
                s[1] -= oh
                s[0] += 1
            s[0] += step_n
    return chunks


def approx_conv2d_dw(x: torch.Tensor, g: torch.Tensor, lut: torch.Tensor, M: int, *,
                     kh: int, kw: int, stride: int = 1, padding="SAME") -> torch.Tensor:
    """LUT-simulated conv weight gradient (paper Fig. 8b): x (N,H,W,C) and
    the upstream error g (N,OH,OW,O) -> dw (KH,KW,C,O), with
    dw[ki,kj,c,o] = sum_{n,oy,ox} amsim(x[n, oy*s+ki-pt, ox*s+kj-pl, c],
    g[n,oy,ox,o]) folded in (n, oy, ox) order from +0.0.

    ``padding`` is the forward conv's: "SAME"/"VALID" or explicit (top,
    bottom, left, right).  ``lut`` is the table in kernel storage.
    """
    if x.ndim != 4 or g.ndim != 4 or x.shape[0] != g.shape[0]:
        raise ValueError(f"approx_conv2d_dw takes x (N,H,W,C) and g (N,OH,OW,O), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    check_float32(x, g)
    check_lut(lut, M)
    n, h, wid, c = x.shape
    o = g.shape[3]
    pads = conv_pads(h, wid, kh, kw, stride, padding)
    if min(pads) < 0:
        raise ValueError(f"pads must be >= 0, got {pads}")
    oh, ow = conv_out_shape(h, wid, kh, kw, stride, pads)
    if (oh, ow) != tuple(g.shape[1:3]):
        raise ValueError(f"g is {tuple(g.shape)} but the conv of {tuple(x.shape)} with a "
                         f"{kh}x{kw} kernel, stride {stride}, pads {pads} gives {(oh, ow)}")
    device = operand_device(x, g, lut)
    if device.type == "cpu":
        return approx_conv2d_dw_plain(x, g, lut, M, kh, kw, stride, pads)
    check_contiguous(x, g, lut)
    if n * oh * ow > 2**30 or kh * kw * c * o > 2**30:
        raise ValueError(f"approx_conv2d_dw folds at most 2^30 positions into at most 2^30 "
                         f"outputs (32-bit indices), got {n * oh * ow} and {kh * kw * c * o}")
    out = torch.empty((kh, kw, c, o), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    plan = dw_plan(kh, kw, c, o, lut, _sms(device.index))
    call_kernel("approx_conv_dw", "approx_conv2d_dw_f32", device,
                x.data_ptr(), g.data_ptr(), lut.data_ptr(), out.data_ptr(),
                n, h, wid, c, kh, kw, o, stride, pads[0], pads[2], oh, ow, M,
                int(lut.dtype == torch.int16), TABLES.index(plan.table), *plan.tile)
    approx_conv2d_dw.launches += 1
    return out


approx_conv2d_dw.launches = 0
