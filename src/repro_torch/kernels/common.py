"""What the LUT kernels share on the host side: LUT placement, operand
checks, the checked call into a kernel library, the attention mask and
the kernels' order of a float32 sum.

The gather brick itself (``repro/kernels/common.py:_gather_gemm_tile``)
is the device function ``amsim::mul`` in ``csrc/amsim.cuh``; the GEMM
kernel has its own form of it, ``product`` in ``csrc/approx_gemm.cu``,
on operands decoded once (its torch twin: ``ref.ref_kernel_product``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

# Largest LUT staged in a block's shared memory: packed tables up to M=8
# (128 KiB), canonical up to M=7 (64 KiB).  Larger tables are read from
# global memory.  Hopper gives a block at most 227 KiB.
SMEM_LUT_MAX_BYTES = 128 * 1024

NEG_INF = -1e30          # the score of a masked key (every lowering)
POS_PAD = -(2 ** 30)     # the position of an unwritten ring-cache slot
LANES = 32               # a warp: the width of the kernels' row sums


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                   window: int) -> torch.Tensor:
    """(..., S, T) bool validity mask -- THE attention mask, shared by the
    kernels' plain versions and the einsum lowering (the CUDA kernels test
    the same three conditions per key).  A key is valid iff its absolute
    position is non-negative (negative = unwritten ring slot or paged
    position), not after the query (``causal``) and inside the sliding
    ``window`` (0 = off).

    Positions are 1-D (``(S,)``/``(T,)`` -> ``(S, T)``, the ring cache's
    shared layout) or carry a leading batch dim (``(B, S)``/``(B, T)`` ->
    ``(B, S, T)``) for the paged serving cache, where every slot sits at
    its own decode position."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    shape = torch.broadcast_shapes(qp.shape, kp.shape)
    mask = (kp >= 0).expand(shape)
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    return mask


@functools.lru_cache(maxsize=None)
def device_float(value: float, device: torch.device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``, made once.  The plain versions
    divide by such tensors: on the card a Python scalar divisor becomes a
    multiplication by its reciprocal, and a tensor made per call would cost
    a host-to-device copy that waits for the card."""
    return torch.tensor(value, dtype=torch.float32).to(device)


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in the order of the kernels' warp sums.

    Lane l of a warp adds x[l], x[l + 32], ... in order from +0.0; then
    the 32 lane sums meet in a butterfly, lane l adding lane l ^ 16, l ^ 8,
    ..., l ^ 1 (``__shfl_xor_sync``).  The rmsnorm sum of squares and the
    softmax denominator of the attention and decode-chain kernels are
    summed this way, so their plain versions agree with them bit for bit.
    """
    n = x.shape[-1]
    x = F.pad(x, (0, (-n) % LANES))
    if x.is_cuda:
        # A CUDA scan over a dim that is not the innermost runs one thread a
        # column, in order from +0.0 in float32: every lane's sum in order,
        # in one launch.  (A CPU scan accumulates in double: the loop below.)
        # That order is not documented by PyTorch: the card test
        # test_lane_sum_scan_is_the_loop fails if it stops matching the loop.
        lanes = torch.cumsum(x.reshape(*x.shape[:-1], -1, LANES), dim=-2)[..., -1, :]
    else:
        lanes = torch.zeros((*x.shape[:-1], LANES), dtype=x.dtype, device=x.device)
        for j in range(0, x.shape[-1], LANES):
            lanes = lanes + x[..., j:j + LANES]
    off = LANES // 2
    while off:
        lanes = lanes[..., :off] + lanes[..., off:2 * off]
        off //= 2
    return lanes[..., 0]


def live_elements(t: torch.Tensor) -> torch.Tensor:
    """Whether each element of the float32 ``t`` has a non-zero exponent
    field: AMSim makes every product of another (+-0, a subnormal) a
    signed zero, whatever the other operand is."""
    return ((t.contiguous().view(torch.int32) >> 23) & 0xFF) != 0


def best_chunk(chunk: int, total: int) -> int:
    """The divisor of ``total`` closest to ``chunk`` in log-space, at most
    ``2 * chunk``; ties prefer the larger divisor (a prime ``total`` gives
    1).  The JAX package's ``best_chunk``: here it snaps the attention
    backward's query chunk to a divisor of the sequence."""
    total = max(1, int(total))
    chunk = max(1, int(chunk))
    best, best_cost = 1, float("inf")
    for d in range(1, int(total ** 0.5) + 1):
        if total % d:
            continue
        for cand in (d, total // d):
            if cand > 2 * chunk:
                continue
            cost = max(cand, chunk) / min(cand, chunk)
            if cost < best_cost or (cost == best_cost and cand > best):
                best, best_cost = cand, cost
    return best


def lut_tensor(lut: np.ndarray, device) -> torch.Tensor:
    """A numpy LUT in kernel storage on ``device``: int16 bits of a packed
    uint16 table, int32 bits of a canonical uint32 one."""
    lut = np.ascontiguousarray(lut)
    view = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}.get(lut.dtype)
    if view is None:
        raise TypeError(f"LUT must be uint16 or uint32, got {lut.dtype}")
    return torch.from_numpy(lut.view(view)).to(device)


def lut_bytes(lut: torch.Tensor) -> int:
    return lut.numel() * lut.element_size()


def lut_in_smem(lut: torch.Tensor) -> bool:
    """Whether the kernels stage this table in shared memory."""
    return lut_bytes(lut) <= SMEM_LUT_MAX_BYTES


def check_lut(lut: torch.Tensor, M: int):
    if not 1 <= M <= 12:
        raise ValueError(f"LUT mantissa bits must be in [1,12], got {M}")
    if lut.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"LUT must be int16 (packed) or int32 (canonical), got {lut.dtype}")
    if lut.ndim != 1 or lut.numel() != 1 << (2 * M):
        raise ValueError(f"LUT for M={M} needs {1 << (2 * M)} entries, got {tuple(lut.shape)}")


def check_float32(*tensors):
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"operands must be float32, got {t.dtype}")


def operand_device(*tensors) -> torch.device:
    """The one device all operands lie on; raises if they differ or if it
    is neither the CPU nor a CUDA card."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return device


def check_contiguous(*tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors only")


def call_kernel(library: str, fn: str, device: torch.device, *args):
    """Call ``fn`` of ``library`` on the current stream of ``device`` and
    raise if the launch was refused."""
    lib = _build.library(library)
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: {lib.amsim_error_string(err).decode()}")
