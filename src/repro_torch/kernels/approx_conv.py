"""AMCONV2D: the LUT-simulated NHWC convolution and its weight gradient,
two CUDA kernels.

``approx_conv2d_fused`` computes an implicit-GEMM conv with every product
simulated by AMSim (``csrc/approx_conv.cu``; it replaces the TPU kernel
``repro/kernels/approx_conv.py:_amconv_kernel``).  It takes an input
dilation, as XLA's ``lhs_dilation``: the data gradient dx runs through it
as a stride-1 conv of the error dilated by the forward stride (``ops.py``),
and the kernel reads the error undilated, visiting only the taps that land
on its real values.  ``approx_conv2d_dw`` computes the weight gradient
(``csrc/approx_conv_dw.cu``; it replaces ``_amconv_dw_kernel``).
Activations are NHWC and weights HWIO, as in the JAX package.  On a CUDA
tensor each wrapper launches its kernel or raises; on a CPU tensor it
runs its plain version (``approx_conv2d_plain``, ``approx_conv2d_dw_plain``:
the dilation materialised, im2col with (ki, kj, c) columns, then the
sequential-k GEMM), which folds in the kernel's order.

The kernels take every conv shape: the port needs no ``fused_supported``
guard and no im2col fallback.

``conv_plan`` and ``dw_plan`` are the launches' plans, made on the host
from the shape, the table and the card's SM count.  ``conv_plan`` picks
the register tile (TM positions x 8 output channels a thread) and the
warps' layout, hence the output tile, and where and in which form the
kernel reads the table; ``dw_plan`` the output tile (one tap, TC channels x
TO output channels), hence the path (tiled, or split where the tile holds
fewer outputs than the block has threads), and the table.  The C launches
size the grids; ``conv_grid`` and ``dw_grid`` ask them for it without
launching, ``conv_tiles`` and ``dw_tiles`` list which block computes which
tile, ``conv_classes`` the parity classes a dilated conv's outputs fall
into, and ``dw_chunks`` the positions each dw chunk stages.

``approx_conv2d_fused.launches`` and ``approx_conv2d_dw.launches`` count
the kernels' launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
import weakref
from dataclasses import dataclass
from typing import NamedTuple

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
def dilate(x: torch.Tensor, d: int) -> torch.Tensor:
    """x (N,H,W,C) with d - 1 zeros inserted between its rows and columns."""
    if d == 1:
        return x
    n, h, w, c = x.shape
    out = x.new_zeros((n, (h - 1) * d + 1, (w - 1) * d + 1, c))
    out[:, ::d, ::d, :] = x
    return out


def approx_conv2d_plain(x, w, lut, M: int, stride: int, pads, input_dilation: int = 1):
    """The kernel's plain PyTorch version: the dilation materialised, then
    im2col + sequential-k GEMM."""
    x = dilate(x, input_dilation)
    n, h, wid, _ = x.shape
    kh, kw, _, o = w.shape
    oh, ow = conv_out_shape(h, wid, kh, kw, stride, pads)
    cols = ref_im2col(x, kh, kw, stride, pads)
    return ref_amsim_gemm(cols, w.reshape(-1, o), lut, M).reshape(n, oh, ow, o)


class ConvShape(NamedTuple):
    """A conv launch's geometry: x (n, h, w, c) undilated, its dilation,
    w (kh, kw, c, o), the stride, the top and left pads of the dilated
    input and the output's (oh, ow)."""
    n: int
    h: int
    w: int
    c: int
    kh: int
    kw: int
    o: int
    stride: int
    dilation: int
    pt: int
    pl: int
    oh: int
    ow: int


class ClassAxis(NamedTuple):
    """One axis of a parity class r: its outputs r + dp * q for q < q_n,
    its live taps k0, k0 + dilation, ... (t_n of them), and the x index of
    output q at live tap t: q * sp + b + t."""
    q_n: int
    t_n: int
    k0: int
    b: int


def _class_axis(r, out, k, pad, stride, dil, dp) -> ClassAxis:
    q_n = _ceil(out - r, dp) if r < out else 0
    k0 = (pad - r * stride) % dil
    t_n = _ceil(k - k0, dil) if k0 < k else 0
    return ClassAxis(q_n, t_n, k0, (r * stride + k0 - pad) // dil)


def _class_period(shape: ConvShape) -> int:
    return shape.dilation // math.gcd(shape.stride, shape.dilation)


def conv_classes(shape: ConvShape):
    """[(ry, rx, y axis, x axis) of each parity class, in the kernel's
    order]: with dilation d the outputs fall into (d / gcd(stride, d))^2
    classes by (oy, ox) modulo that; the outputs of one class meet the real
    values of the dilated input at the same taps (``ClassAxis``).  One
    class when d = 1."""
    dp = _class_period(shape)
    out = []
    for ry in range(dp):
        ay = _class_axis(ry, shape.oh, shape.kh, shape.pt, shape.stride, shape.dilation, dp)
        for rx in range(dp):
            ax = _class_axis(rx, shape.ow, shape.kw, shape.pl, shape.stride, shape.dilation, dp)
            out.append((ry, rx, ay, ax))
    return out


def conv_shape(x_shape, w_shape, stride: int, pads, input_dilation: int = 1) -> ConvShape:
    n, h, wid, c = x_shape
    kh, kw, _, o = w_shape
    hd, wd = (h - 1) * input_dilation + 1, (wid - 1) * input_dilation + 1
    oh, ow = conv_out_shape(hd, wd, kh, kw, stride, pads)
    return ConvShape(n, h, wid, c, kh, kw, o, stride, input_dilation, pads[0], pads[2], oh, ow)


CONV_TN = 8          # output channels a thread
CONV_WARPS = 8       # warps a block
# (TM positions a thread, WN warps along the output channels): every tile
# the kernel takes, largest register tile first.
CONV_TILES = ((2, 8), (2, 4), (2, 2), (1, 8), (1, 4), (1, 2), (1, 1))


@dataclass(frozen=True)
class ConvPlan:
    tile: tuple          # (TM positions, TN output channels) a thread
    warps: tuple         # (WM along the positions, WN along the output channels)
    block: tuple         # (BM, BN) = (WM x 32 x TM, WN x TN): a tile's outputs
    classes: int         # parity classes of the outputs (1 without dilation)
    tiles: int
    table: str           # one of approx_gemm.TABLES

    def __str__(self):
        return (f"{self.tile[0]}x{self.tile[1]} a thread, warps {self.warps[0]}x{self.warps[1]}, "
                f"tiles of {self.block[0]}x{self.block[1]}, {self.classes} class"
                f"{'es' if self.classes > 1 else ''}, {self.tiles} tiles, table {self.table}")


# Clocks an SM spends a product at each tile (TM, WN), by the form in which
# the kernel reads the table, where the busiest SM holds two tiles or more;
# a tile alone on its SM (8 warps) takes CONV_ALONE times as long.  Fitted
# to the tile sweeps of ``time_chain.py --conv-sweep`` at the resnet-mini
# and LeNet-5 shapes, batch 64: afm16 expanded to canonical words in shared
# memory and afm10 in global memory on the final kernel, afm16 kept packed
# on the kernel before its registers were capped (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md).  A global table's gathers miss L1 where few warps share
# w's rows, hence its higher clocks; there a column past the last output
# channel (w staged as +0.0: its row stays in L1) is not counted.
CONV_CLOCKS = {
    "smem canonical": {(2, 8): 0.147, (2, 4): 0.146, (2, 2): 0.172, (1, 8): 0.174,
                       (1, 4): 0.173, (1, 2): 0.184, (1, 1): 0.219},
    "smem packed": {(2, 8): 0.177, (2, 4): 0.195, (2, 2): 0.216, (1, 8): 0.190, (1, 4): 0.226,
                    (1, 2): 0.204, (1, 1): 0.263},
    "global": {(2, 8): 0.879, (2, 4): 0.587, (2, 2): 0.344, (1, 8): 1.004, (1, 4): 0.794,
               (1, 2): 0.518, (1, 1): 0.424},
}
CONV_ALONE = {"smem canonical": 1.2, "smem packed": 1.2, "global": 1.25}


def _plan_tiles(shape: ConvShape, bm: int, bn: int):
    """[(ry, rx, p0, o0, products) of each tile in the kernel's order]."""
    out, otiles = [], _ceil(shape.o, bn)
    for ry, rx, ay, ax in conv_classes(shape):
        work = bm * bn * ay.t_n * ax.t_n * shape.c
        for r in range(_ceil(shape.n * ay.q_n * ax.q_n, bm) * otiles):
            out.append((ry, rx, r // otiles * bm, r % otiles * bn, work))
    return out


@functools.lru_cache(maxsize=4096)
def _conv_plan(shape: ConvShape, packed: bool, nbytes: int, sms: int) -> ConvPlan:
    # where and in which form the kernel reads the table: canonical words in
    # shared memory where they fit (a packed table expanded: no unpacking a
    # product), else the packed table there, else global memory as stored
    if (2 if packed else 1) * nbytes <= SMEM_LUT_MAX_BYTES:
        table = TABLES[0]
    elif nbytes <= SMEM_LUT_MAX_BYTES:
        table = TABLES[1]
    else:
        table = TABLES[3] if packed else TABLES[2]
    kind = table if table.startswith("smem") else "global"
    best = None
    for tm, wn in CONV_TILES:
        bm, bn = CONV_WARPS // wn * 32 * tm, wn * CONV_TN
        tiles = _plan_tiles(shape, bm, bn)
        # tile t runs on SM t % sms (blocks run grid-stride)
        work, count = [0] * sms, [0] * sms
        for t, (_, _, _, o0, products) in enumerate(tiles):
            if kind == "global":
                products = products * min(bn, shape.o - o0) // bn
            work[t % sms] += products + bm * bn
            count[t % sms] += 1
        cost = max(work) * CONV_CLOCKS[kind][tm, wn] * (CONV_ALONE[kind] if max(count) == 1
                                                       else 1)
        if best is None or cost < best[0]:
            best = (cost, tm, wn, bm, bn, len(tiles))
    _, tm, wn, bm, bn, tiles = best
    return ConvPlan((tm, CONV_TN), (CONV_WARPS // wn, wn), (bm, bn),
                    len(conv_classes(shape)), tiles, table)


def conv_plan(shape: ConvShape, lut: torch.Tensor, sms: int) -> ConvPlan:
    """The launch plan of the conv ``shape`` with the table ``lut`` (kernel
    storage) on a card of ``sms`` SMs: of the tiles ``CONV_TILES``, the one
    whose busiest SM takes the fewest clocks, when tile t runs on SM t %
    sms, a tile computes all of its BM x BN outputs at its class's live
    taps, and a product costs ``CONV_CLOCKS`` (``CONV_ALONE`` times that on
    an SM with one tile).  The table is read as canonical words from
    shared memory where those fit (a packed one expanded), else packed from
    there, else from global memory as stored (transposed:
    ``transposed_lut``)."""
    return _conv_plan(shape, lut.dtype == torch.int16, lut_bytes(lut), sms)


# id(table) -> (a weak reference to it, its version, its transposed copy);
# an entry goes with its table.
_TRANSPOSED: dict = {}


def transposed_lut(lut: torch.Tensor) -> torch.Tensor:
    """The table with its two mantissa indices swapped (entry (mb, ma) at
    (mb << M) | ma), as the conv kernel reads a table from global memory;
    made once a table (and again if the table is written)."""
    key = id(lut)
    held = _TRANSPOSED.get(key)
    if held is None or held[0]() is not lut or held[1] != lut._version:
        side = 1 << ((lut.numel().bit_length() - 1) // 2)
        ref = weakref.ref(lut, lambda _, k=key: _TRANSPOSED.pop(k, None))
        held = (ref, lut._version, lut.view(side, side).t().contiguous().view(-1))
        _TRANSPOSED[key] = held
    return held[2]


def _plan_args(plan: ConvPlan, lut: torch.Tensor):
    return (int(lut.dtype == torch.int16), TABLES.index(plan.table), *plan.tile, plan.warps[1])


def conv_grid(plan: ConvPlan, shape: ConvShape, lut: torch.Tensor) -> dict:
    """The grid that a conv launch of ``plan`` at ``shape`` takes on the
    current card, without launching: ``blocks``, ``tiles`` and ``smem`` (a
    block's shared bytes).  ``lut`` is the CUDA table it would read."""
    out = (ctypes.c_longlong * 3)()
    M = (lut.numel().bit_length() - 1) // 2      # the table has 2^(2M) entries
    call_kernel("approx_conv", "approx_conv_grid", lut.device, *shape, M,
                *_plan_args(plan, lut), out)
    return dict(zip(("blocks", "tiles", "smem"), out))


def conv_tiles(plan: ConvPlan, shape: ConvShape, blocks: int):
    """[(block, ry, rx, p0, p1, o0, o1) of every tile] in the kernel's walk
    over a grid of ``blocks``: the classes in ``conv_classes`` order, in
    each its positions (n, qy, qx) row-major in tiles of BM, each of those
    in column tiles of BN; block b takes tiles b, b + blocks, ..."""
    bm, bn = plan.block
    sizes = {(ry, rx): shape.n * ay.q_n * ax.q_n for ry, rx, ay, ax in conv_classes(shape)}
    return [(t % blocks, ry, rx, p0, min(p0 + bm, sizes[ry, rx]), o0, min(o0 + bn, shape.o))
            for t, (ry, rx, p0, o0, _) in enumerate(_plan_tiles(shape, bm, bn))]


def class_outputs(shape: ConvShape, ry: int, rx: int):
    """[(n, oy, ox)] of the outputs of class (ry, rx), in the order of its
    positions."""
    dp = _class_period(shape)
    ay, ax = next(c[2:] for c in conv_classes(shape) if c[:2] == (ry, rx))
    return [(i, ry + dp * qy, rx + dp * qx)
            for i in range(shape.n) for qy in range(ay.q_n) for qx in range(ax.q_n)]


def approx_conv2d_fused(x: torch.Tensor, w: torch.Tensor, lut: torch.Tensor, M: int, *,
                        stride: int = 1, padding="SAME", input_dilation: int = 1) -> torch.Tensor:
    """Implicit-GEMM LUT-simulated conv2d: x (N,H,W,C), w (KH,KW,C,O) ->
    (N,OH,OW,O), f32 accumulate.

    ``input_dilation`` inserts d - 1 zeros between x's rows and columns
    before the conv, as XLA's ``lhs_dilation``; the kernel never reads or
    multiplies them.  ``padding`` is "SAME"/"VALID" (of the dilated input)
    or explicit (top, bottom, left, right).  ``lut`` is the table in kernel
    storage (int16 packed, int32 canonical).
    """
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"approx_conv2d_fused takes x (N,H,W,C) and w (KH,KW,C,O), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if stride < 1 or input_dilation < 1:
        raise ValueError(f"stride and input_dilation must be >= 1, got {stride} and "
                         f"{input_dilation}")
    check_float32(x, w)
    check_lut(lut, M)
    n, h, wid, c = x.shape
    kh, kw, _, o = w.shape
    hd, wd = (h - 1) * input_dilation + 1, (wid - 1) * input_dilation + 1
    pads = conv_pads(hd, wd, kh, kw, stride, padding)
    if min(pads) < 0:
        raise ValueError(f"pads must be >= 0, got {pads}")
    oh, ow = conv_out_shape(hd, wd, kh, kw, stride, pads)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"empty conv output {(oh, ow)} for {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, stride {stride}, input dilation "
                         f"{input_dilation}, pads {pads}")
    device = operand_device(x, w, lut)
    if device.type == "cpu":
        return approx_conv2d_plain(x, w, lut, M, stride, pads, input_dilation)
    check_contiguous(x, w, lut)
    out = torch.empty((n, oh, ow, o), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    if c == 0:
        return out.zero_()
    if max(x.numel(), w.numel(), out.numel()) >= 2**31:
        raise ValueError(f"approx_conv2d_fused takes tensors of fewer than 2^31 elements (32-bit "
                         f"indices), got {tuple(x.shape)}, {tuple(w.shape)} -> {tuple(out.shape)}")
    shape = conv_shape(x.shape, w.shape, stride, pads, input_dilation)
    plan = conv_plan(shape, lut, _sms(device.index))
    table = lut if plan.table.startswith("smem") else transposed_lut(lut)
    call_kernel("approx_conv", "approx_conv2d_f32", device,
                x.data_ptr(), w.data_ptr(), table.data_ptr(), out.data_ptr(), *shape, M,
                *_plan_args(plan, lut))
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
