"""Int8 gradient compression with error feedback: the port of
``repro.distributed.compression``.

Gradients are block-quantised to int8 (blocks of 256 values, one float32
scale each, ~3.9x fewer bytes than float32) before the data-parallel
all-reduce, and the quantisation error is carried into the next step
(error feedback), so the noise acts as a bounded delay, not a bias.
``compressed_all_reduce`` is JAX's ``compressed_psum``: the block scales
are all-reduced by MAX into one wire scale, the int8 payload is summed as
int32 (exact in any order, below 2^23 ranks) and dequantised with the
shared scale, then divided by the number of ranks.  As in the JAX package,
nothing on the training path calls it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

BLOCK = 256


def _blockify(x: torch.Tensor):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), pad


def _block_scale(blocks: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0, min=1e-12)


def quantize_int8(x: torch.Tensor, scale: torch.Tensor | None = None):
    """x -> (q int8 blocks (n, 256), float32 scale a block (n, 1), pad)."""
    blocks, pad = _blockify(x.to(torch.float32))
    if scale is None:
        scale = _block_scale(blocks)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, pad: int, shape) -> torch.Tensor:
    x = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        x = x[:-pad]
    return x.reshape(shape)


def init_ef_state(params: dict) -> dict:
    """Zero error-feedback state for a {name: tensor} tree."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def compressed_all_reduce(grads: dict, ef_state: dict, mesh, axes="data"):
    """The mean of ``grads`` ({name: tensor}) over the ranks along ``axes``
    with int8 compression and error feedback; returns (mean grads, new
    error-feedback state)."""
    n = mesh.axes_size(axes)
    means, new_ef = {}, {}
    for name, g in grads.items():
        g_eff = g.to(torch.float32) + ef_state[name]
        blocks, pad = _blockify(g_eff)
        scale = mesh.all_reduce(_block_scale(blocks), axes, op=dist.ReduceOp.MAX)
        q, _, _ = quantize_int8(g_eff, scale)
        new_ef[name] = g_eff - dequantize_int8(q, scale, pad, g.shape)
        summed = mesh.all_reduce(q.to(torch.int32), axes, op=dist.ReduceOp.SUM)
        means[name] = dequantize_int8(summed, scale, pad, g.shape) / n
    return means, new_ef
