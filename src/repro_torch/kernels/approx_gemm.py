"""AMDENSE: the LUT-simulated GEMM, a CUDA kernel for Hopper.

``approx_gemm`` computes (m, k) @ (k, n) and ``approx_gemm_batched``
(B, m, k) @ (B, k, n), every product simulated by AMSim, in one launch of
the kernel of ``csrc/approx_gemm.cu`` (they replace the TPU kernels
``repro/kernels/approx_gemm.py:_amsim_kernel`` and
``_amsim_kernel_batched``).  On a CUDA tensor each launches the kernel or
raises.  On a CPU tensor it runs the kernel's plain PyTorch version,
``approx_gemm_plain`` / ``approx_gemm_batched_plain``, which folds k in the
same order, so the two agree bit for bit.

``approx_gemm.launches`` and ``approx_gemm_batched.launches`` count the
kernel's launches through each wrapper.
"""
from __future__ import annotations

import torch

from .common import (call_kernel, check_contiguous, check_float32, check_lut,
                     lut_bytes, lut_in_smem, operand_device)
from .ref import ref_amsim_gemm

# The kernel's plain PyTorch version: the same sequential-k fold, batched
# over the leading dim for approx_gemm_batched.
approx_gemm_plain = ref_amsim_gemm
approx_gemm_batched_plain = ref_amsim_gemm


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
    call_kernel("approx_gemm", "approx_gemm_f32", device,
                a.data_ptr(), b.data_ptr(), lut.data_ptr(), out.data_ptr(),
                m, k, n, M, int(lut.dtype == torch.int16), int(lut_in_smem(lut)),
                lut_bytes(lut))
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
    call_kernel("approx_gemm", "approx_gemm_batched_f32", device,
                a.data_ptr(), b.data_ptr(), lut.data_ptr(), out.data_ptr(),
                batch, m, k, n, M, int(lut.dtype == torch.int16), int(lut_in_smem(lut)),
                lut_bytes(lut))
    approx_gemm_batched.launches += 1
    return out


approx_gemm_batched.launches = 0
