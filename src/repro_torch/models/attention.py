"""GQA attention with RoPE and a ring KV cache, every contraction routed
through the policy.

The port of the single-device, self-attention part of
``repro.models.attention``: projections "qkv"/"wo" go through
``layers.linear``; the score/value contractions take the fused attention
kernel under an ``amsim`` leaf and the grouped-query einsum lowering
(``ops.attend_einsum``) otherwise.  The decode chain hands in its own
projections (``qkv=``), takes the pre-``wo`` context (``project_out=False``)
or stops after rope and the cache write (``capture_attend=True``).

The einsum lowering runs a query chunk (``cfg.q_chunk``) at a time when
the sequence splits into such chunks; the kernel takes every shape, and
its backward chunks its own recompute (``ops.policy_attention``).  Not
ported (no path of the port needs them yet): the paged cache,
cross-attention and full-head / sharded attention.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import NumericsPolicy
from repro_torch.kernels.common import POS_PAD
from repro_torch.kernels.ops import attend_einsum, fused_attention_enabled, policy_attention
from .layers import init_linear, linear


def init_attention(cfg: ArchConfig, *, generator: torch.Generator) -> dict:
    d, dh = cfg.d_model, cfg.head_dim
    return {
        "wq": init_linear(d, cfg.n_heads * dh, generator=generator, bias=cfg.qkv_bias),
        "wk": init_linear(d, cfg.n_kv_heads * dh, generator=generator, bias=cfg.qkv_bias),
        "wv": init_linear(d, cfg.n_kv_heads * dh, generator=generator, bias=cfg.qkv_bias),
        "wo": init_linear(cfg.n_heads * dh, d, generator=generator),
    }


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: str) -> torch.Tensor:
    """The inverse-frequency table of one (head_dim, theta), made once per
    device."""
    exps = -torch.arange(0, half, dtype=torch.float32) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32), exps).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, dh) at positions (S,)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, float(theta), str(x.device))
    ang = (positions[:, None].to(torch.float32) * freqs[None, :])[None, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """A ring KV cache: k/v (B, max_len, KV, dh), the absolute position of
    every slot (``POS_PAD``: unwritten) and the tokens written so far."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, device=device), "v": torch.zeros(shape, device=device),
            "pos": torch.full((max_len,), POS_PAD, dtype=torch.int32, device=device),
            "len": 0}


def _ring_write(cache: dict, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor) -> dict:
    """Write the S new keys and values at slots len % Tmax, ... (wrapping),
    in place, with their absolute positions.  A block longer than the ring
    keeps its last Tmax tokens (the wrap would overwrite the earlier ones);
    queries whose own keys were evicted so see no valid key."""
    tmax = cache["k"].shape[1]
    S = k.shape[1]
    if S > tmax:
        k, v, q_pos = k[:, -tmax:], v[:, -tmax:], q_pos[-tmax:]
    slot = (cache["len"] + max(0, S - tmax)) % tmax
    n = k.shape[1]
    if slot + n <= tmax:
        idx = slice(slot, slot + n)
    else:
        idx = (slot + torch.arange(n, device=k.device)) % tmax
    cache["k"][:, idx] = k
    cache["v"][:, idx] = v
    cache["pos"][idx] = q_pos
    return {**cache, "len": cache["len"] + S}


def attention(p, x: torch.Tensor, cfg: ArchConfig, policy: NumericsPolicy, *, cache=None,
              window: int = 0, qkv=None, project_out: bool = True,
              capture_attend: bool = False):
    """Self-attention of x (B, S, d).  Returns (out, cache).

    cache: a ring cache (``init_cache``), updated in place; the returned
           dict carries the new length.
    qkv:   (q, k, v) projections (B, S, H, dh) / (B, S, KV, dh) before
           rope, made by the decode chain's first launch.
    project_out: False returns the context (B, S, H*dh) before ``wo``.
    capture_attend: True stops after rope and the cache write and returns
           ((q, k, v, q_pos, k_pos), cache): the roped queries, the whole
           cache after the write and both position vectors, for the chain
           launch that runs the attention core itself.
    """
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if qkv is not None:
        q, k, v = qkv
    else:
        q = linear(p["wq"], x, policy, site="qkv").reshape(B, S, H, dh)
        k = linear(p["wk"], x, policy, site="qkv").reshape(B, S, KV, dh)
        v = linear(p["wv"], x, policy, site="qkv").reshape(B, S, KV, dh)
    start = cache["len"] if cache is not None else 0
    q_pos = torch.arange(start, start + S, dtype=torch.int32, device=x.device)
    q = rope(q, q_pos, cfg.rope_theta)
    k = rope(k, q_pos, cfg.rope_theta)
    if cache is not None:
        cache = _ring_write(cache, k, v, q_pos)
        k, v, k_pos = cache["k"], cache["v"], cache["pos"]
    else:
        k_pos = q_pos
    if capture_attend:
        return (q, k, v, q_pos, k_pos), cache
    if fused_attention_enabled(policy):
        out = policy_attention(q, k, v, q_pos, k_pos, policy, True, window)
    elif S > cfg.q_chunk and S % cfg.q_chunk == 0:
        # The einsum lowering a query chunk at a time, as the JAX package's
        # q-chunk scan: it holds (B, KV, G, q_chunk, T) scores, not S rows'.
        c = cfg.q_chunk
        out = torch.cat([attend_einsum(q[:, i:i + c], k, v, q_pos[i:i + c], k_pos, policy,
                                       causal=True, window=window) for i in range(0, S, c)],
                        dim=1)
    else:
        out = attend_einsum(q, k, v, q_pos, k_pos, policy, causal=True, window=window)
    out = out.reshape(B, S, H * dh)
    if not project_out:
        return out, cache
    return linear(p["wo"], out, policy, site="wo"), cache
