"""What the LUT kernels share on the host side: LUT placement, operand
checks and the checked call into a kernel library.

The gather brick itself (``repro/kernels/common.py:_gather_gemm_tile``)
is the device function ``amsim::mul`` in ``csrc/amsim.cuh``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

# Largest LUT staged in a block's shared memory: packed tables up to M=8
# (128 KiB), canonical up to M=7 (64 KiB).  Larger tables are read from
# global memory.  Hopper gives a block at most 227 KiB.
SMEM_LUT_MAX_BYTES = 128 * 1024


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
