"""Fused LUT attention: score GEMM, scale, position mask, row softmax and
value GEMM in one CUDA launch.

``approx_attention`` computes softmax(mask(q k^T / sqrt(dh))) v with both
contractions simulated by AMSim (``csrc/approx_attention.cu``; it
replaces the TPU kernel ``repro/kernels/approx_attention.py:_attn_kernel``).
q is (B, S, H, dh), k and v (B, T, KV, dh) with H = KV * G (grouped-query
heads), q_pos (S,) and k_pos (T,) absolute positions (negative k_pos =
an unwritten ring-cache slot, masked).  On a CUDA tensor it launches the
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

The kernel skips masked keys in the score pass and keys whose probability
is exactly zero in the value pass.  Both are exact: a skipped score is
``NEG_INF`` either way, and a skipped product is amsim(+0, v) = ±0, which
never changes a sum that started at +0.0.  So decode cost scales with the
live keys, not the ring's capacity.  There is no size guard: scores go
to a global-memory scratch, one row of T floats per resident warp.

``approx_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from .common import (NEG_INF, attention_mask, call_kernel, check_contiguous, check_float32,
                     check_lut, device_float, lane_sum, lut_bytes, lut_in_smem, operand_device)
from .ref import ref_amsim_gemm

MAX_DH = 256             # head dims a warp's eight output registers cover
WARPS_PER_BLOCK = 8      # csrc/amsim.cuh kThreads / 32
MAX_WARPS_PER_SM = 64    # 2048 resident threads an SM on Hopper


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
    mask = attention_mask(q_pos, k_pos, causal=causal, window=window)[:, None, :]
    probs = softmax_scores(scores, mask, dh).reshape(B, KV, S * G, T)
    out = ref_amsim_gemm(probs, v.permute(0, 2, 1, 3), lut, M).reshape(B, KV, S, G, dh)
    return out.permute(0, 2, 1, 3, 4).reshape(B, S, H, dh)


def check_attention_operands(q, k, v, q_pos, k_pos):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"attention takes q (B,S,H,dh), k/v (B,T,KV,dh) with KV | H, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q_pos.shape != (q.shape[1],) or k_pos.shape != (k.shape[1],):
        raise ValueError(f"positions must be q_pos (S,) and k_pos (T,), got "
                         f"{tuple(q_pos.shape)} and {tuple(k_pos.shape)}")
    if q.shape[3] > MAX_DH:
        raise ValueError(f"head dim {q.shape[3]} > {MAX_DH}")
    check_float32(q, k, v)


def scratch_warps(device: torch.device, rows: int) -> int:
    """Warps the score scratch needs rows for: one per warp the kernel can
    keep resident, no more than there are query rows (rounded up to whole
    blocks)."""
    cap = torch.cuda.get_device_properties(device).multi_processor_count * MAX_WARPS_PER_SM
    return min(cap, -(-rows // WARPS_PER_BLOCK) * WARPS_PER_BLOCK)


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
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    warps = scratch_warps(device, B * S * H)
    scratch = torch.empty((warps, T), dtype=torch.float32, device=device)
    call_kernel("approx_attention", "approx_attention_f32", device,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
                lut.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                B, S, H, KV, T, dh, int(causal), int(window), warps, M,
                int(lut.dtype == torch.int16), int(lut_in_smem(lut)), lut_bytes(lut))
    approx_attention.launches += 1
    return out


approx_attention.launches = 0
