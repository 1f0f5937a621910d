"""GQA attention with RoPE and a ring or paged KV cache, every contraction
routed through the policy.

The port of the single-device part of ``repro.models.attention``:
self-attention, causal or bidirectional (``causal=False``, the encoder's),
and cross-attention (``kv_src``: K/V projected from the encoder states,
no rope, keys at positions 0 .. Tsrc - 1).  Projections "qkv"/"wo" go through
``layers.linear``; the score/value contractions take the fused attention
kernel under an ``amsim`` leaf (its plain version, in the same structure,
under ``amsim_torch``) and the grouped-query einsum lowering
(``ops.attend_einsum``) otherwise.  The decode chain hands in its own
projections (``qkv=``), takes the pre-``wo`` context (``project_out=False``)
or stops after rope and the cache write (``capture_attend=True``).

The einsum lowering runs a query chunk (``cfg.q_chunk``) at a time when
the sequence splits into such chunks; the kernel takes every shape, and
its backward chunks its own recompute (``ops.policy_attention``).

Under an ambient mesh (``launch/mesh.py``) q/k/v are column-parallel and
wo row-parallel products, and a rank holds H / model query and KV /
model KV heads (the widths of its projections say how many) and its
batch rows; the attention runs through ``shard_fused.parallel_attention``,
the kernel on this rank's heads, with no collective.

The paged serving cache (``serve/paged_cache.py``, JAX
``_paged_cache_update``) gives every batch row its own position: q_pos
and k_pos are (B, S) and (B, T), and the same two lowerings take them
(the kernel reads each row's positions, the einsum masks per row).  A
cache stored in ``cfg.cache_dtype`` (bfloat16 halves it) is read back as
float32 before any lowering, as the JAX kernels' wrappers cast it.  Not
ported (no path of the port needs it yet): full-head attention.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import NumericsPolicy
from repro_torch.distributed import shard_fused as sf
from repro_torch.kernels.common import POS_PAD
from repro_torch.kernels.ops import attend_einsum, one_call_attention_enabled, policy_attention
from repro_torch.launch.mesh import current_mesh
from .layers import init_linear, linear

TRASH_PAGE = 0   # the pools' reserved page (serve/paged_cache.TRASH_PAGE)


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
    """Rotary embedding of x (B, S, H, dh) at positions (S,) or (B, S)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, float(theta), str(x.device))
    ang = positions[..., None].to(torch.float32) * freqs      # (S, half) or (B, S, half)
    ang = ang[None, :, None, :] if positions.ndim == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def cache_dtype(cfg: ArchConfig) -> torch.dtype:
    """The KV cache's storage type, ``cfg.cache_dtype`` ("float32",
    "bfloat16", ...)."""
    return getattr(torch, cfg.cache_dtype)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """A ring KV cache: k/v (B, max_len, KV, dh) in ``cfg.cache_dtype``, the
    absolute position of every slot (``POS_PAD``: unwritten) and the
    tokens written so far."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = cache_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
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
    cache["k"][:, idx] = k.to(cache["k"].dtype)
    cache["v"][:, idx] = v.to(cache["v"].dtype)
    cache["pos"][idx] = q_pos
    return {**cache, "len": cache["len"] + S}


def _paged_cache_update(cache: dict, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor):
    """Write the S new keys and values of every slot through its page
    table, in place, and gather each slot's contiguous view (JAX
    ``_paged_cache_update``).

    ``cache``: ``pool_k``/``pool_v`` (n_pages, page_size, KV, dh), page 0
    the trash page; ``ptab`` (B, n_ptab) int32 (0 = unallocated);
    ``start`` (B,) the tokens already resident; ``live`` (B,) bool.  A
    write of a dead slot or of a position outside 0 .. Tcap - 1 (Tcap =
    n_ptab x page_size; a padded prefill can run past it) goes to the
    trash page at offset 0, and so does a position whose table entry is
    unallocated (a padded prefill's tail): many writes may land on one
    trash key, and on the card which of them stays is not defined, so
    every write to the trash page carries zeros.  The trash page thus stays
    zero: a trash key is always masked, and a row with no valid key (a
    dead slot), whose kernel output is the mean of V over its keys, reads
    zeros there, the same on every run.  Token t of a slot holds position
    t, so key positions are derived, not stored: t is valid iff the slot
    is live and t < start + S.

    Returns (k_view (B, Tcap, KV, dh), v_view, k_pos (B, Tcap)), the views
    in the pools' type."""
    pool_k, pool_v = cache["pool_k"], cache["pool_v"]
    ptab, live, start = cache["ptab"], cache["live"], cache["start"]
    B, S = q_pos.shape
    page_size, n_ptab = pool_k.shape[1], ptab.shape[1]
    tcap = n_ptab * page_size
    ok = live[:, None] & (q_pos >= 0) & (q_pos < tcap)
    page = torch.gather(ptab, 1, torch.clamp(q_pos // page_size, 0, n_ptab - 1).long())
    page = torch.where(ok, page, TRASH_PAGE).long()
    off = torch.where(ok, q_pos % page_size, 0).long()
    kept = (page != TRASH_PAGE)[..., None, None]
    pool_k[page, off] = torch.where(kept, k, 0.0).to(pool_k.dtype)
    pool_v[page, off] = torch.where(kept, v, 0.0).to(pool_v.dtype)
    k_view = pool_k[ptab.long()].reshape(B, tcap, *pool_k.shape[2:])
    v_view = pool_v[ptab.long()].reshape(B, tcap, *pool_v.shape[2:])
    t = torch.arange(tcap, dtype=torch.int32, device=q_pos.device)[None]
    valid = live[:, None] & (t < (start + S)[:, None])
    k_pos = torch.where(valid, t, POS_PAD).to(torch.int32)
    return k_view, v_view, k_pos


def attention(p, x: torch.Tensor, cfg: ArchConfig, policy: NumericsPolicy, *, kv_src=None,
              causal: bool = True, use_rope: bool = True, cache=None, window: int = 0,
              qkv=None, project_out: bool = True, capture_attend: bool = False):
    """Attention of x (B, S, d).  Returns (out, cache).

    kv_src: (B, Tsrc, d) encoder states for cross-attention: K/V are
           projected from them, rope is not applied and the keys sit at
           positions 0 .. Tsrc - 1 (``causal=False`` expected).  Takes no
           paged cache and no ``qkv=``.
    causal: False attends to every valid key (the encoder, cross-attention).
    use_rope: False skips rope on q and k (rope never applies under kv_src).

    cache: a ring cache (``init_cache``), updated in place; the returned
           dict carries the new length.  Or a paged cache (a dict with a
           ``ptab``: ``_paged_cache_update``), whose pools are updated in
           place; every row then sits at its own position (q_pos (B, S) =
           start + 0 .. S - 1) and masks per row.
    qkv:   (q, k, v) projections (B, S, H, dh) / (B, S, KV, dh) before
           rope, made by the decode chain's first launch.
    project_out: False returns the context (B, S, H*dh) before ``wo``.
    capture_attend: True stops after rope and the cache write and returns
           ((q, k, v, q_pos, k_pos), cache): the roped queries, the whole
           cache after the write (float32) and both positions, for the
           chain launch that runs the attention core itself.
    """
    B, S, _ = x.shape
    dh = cfg.head_dim
    if qkv is not None:
        if kv_src is not None:
            raise ValueError("qkv= is decoder self-attention only (no kv_src)")
        q, k, v = qkv
    else:
        src = x if kv_src is None else kv_src
        T = src.shape[1]
        # -1: this rank's heads under a mesh (all of them on one device)
        q = linear(p["wq"], x, policy, site="qkv", kind="column").reshape(B, S, -1, dh)
        k = linear(p["wk"], src, policy, site="qkv", kind="column").reshape(B, T, -1, dh)
        v = linear(p["wv"], src, policy, site="qkv", kind="column").reshape(B, T, -1, dh)
    H = q.shape[2]
    paged = cache is not None and "ptab" in cache
    if paged:
        if kv_src is not None:
            raise ValueError("paged KV caches are decoder-self-attention only (no "
                             "cross-attention)")
        q_pos = cache["start"][:, None] + torch.arange(S, dtype=torch.int32,
                                                       device=x.device)[None]
    else:
        start = cache["len"] if cache is not None else 0
        q_pos = torch.arange(start, start + S, dtype=torch.int32, device=x.device)
    if use_rope and kv_src is None:
        q = rope(q, q_pos, cfg.rope_theta)
        k = rope(k, q_pos, cfg.rope_theta)
    if paged:
        k, v, k_pos = _paged_cache_update(cache, k, v, q_pos)
    elif cache is not None:
        cache = _ring_write(cache, k, v, q_pos)
        k, v, k_pos = cache["k"], cache["v"], cache["pos"]
    elif kv_src is not None:
        k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
    else:
        k_pos = q_pos
    k, v = k.to(torch.float32), v.to(torch.float32)
    if capture_attend:
        return (q, k, v, q_pos, k_pos), cache
    mesh = current_mesh()
    if mesh is not None:
        out = sf.parallel_attention(q, k, v, q_pos, k_pos, policy, causal=causal, window=window,
                                    heads_split=sf.spec_of(p["wq"].w)[1] == "model",
                                    mesh=mesh)
    elif one_call_attention_enabled(policy):
        out = policy_attention(q, k, v, q_pos, k_pos, policy, causal, window)
    elif S > cfg.q_chunk and S % cfg.q_chunk == 0:
        # The einsum lowering a query chunk at a time, as the JAX package's
        # q-chunk scan: it holds (B, KV, G, q_chunk, T) scores, not S rows'.
        c = cfg.q_chunk
        out = torch.cat([attend_einsum(q[:, i:i + c], k, v, q_pos[..., i:i + c], k_pos, policy,
                                       causal=causal, window=window) for i in range(0, S, c)],
                        dim=1)
    else:
        out = attend_einsum(q, k, v, q_pos, k_pos, policy, causal=causal, window=window)
    out = out.reshape(B, S, H * dh)
    if not project_out:
        return out, cache
    return linear(p["wo"], out, policy, site="wo", kind="row"), cache
