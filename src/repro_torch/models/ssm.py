"""Mamba2 (SSD, state-space duality) block, its GEMMs routed through the
policy: the port of ``repro.models.ssm``.

Chunked SSD (arXiv:2405.21060): within a chunk of Q steps the output is
an attention-like masked product; across chunks a (heads, p, N) state is
carried by a linear recurrence.  The in/out projections and the four
chunk einsums (scores, intra-chunk values, chunk states, inter-chunk
output) resolve under site "ssm": under ``amsim`` the projections run the
GEMM kernel and the einsums the batched GEMM kernel.

With a cache (serving) the block runs the per-token recurrence, whose two
einsums are exact float32 ``torch.einsum``s outside the policy, as in JAX;
its state is O(1) in the sequence length.

n_groups=1 (the Mamba2 default): B and C are shared across heads.

Under an ambient mesh (``launch/mesh.py``) a rank holds its blocks of
``conv_w``/``conv_b`` (channels) and ``A_log``/``D``/``dt_bias`` (heads)
over "model" (JAX's rules) and gathers them at use
(``shard_fused.whole_param``); ``in_proj``/``out_proj`` carry no Megatron
role, as in JAX (in_proj's output is [z, x, B, C, dt], which a column split
would not cut at head boundaries), so they take the replicated dispatch.
The layer then runs whole on this rank's batch rows, bitwise the
single-device layer's; its cache's ``ssm`` heads and ``conv`` channels
are this rank's blocks over "model" (``sharding.cache_specs``), gathered
for the step and cut again after it.

One deliberate difference from JAX: the intra-chunk decay factor is
``exp(where(mask, decay, -inf))`` where JAX takes ``where(mask, exp(decay),
0)``.  The forward values are the same element for element; JAX's
gradient is NaN wherever ``decay`` above the diagonal overflows ``exp``
(a chunk whose summed log-decay passes ~88, which full-width models reach
at Q = 256), and the port's is finite there and JAX's elsewhere.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import NumericsPolicy
from repro_torch.distributed.shard_fused import whole_param
from repro_torch.kernels.ops import exact_fp32, policy_einsum
from repro_torch.launch.mesh import current_mesh
from .layers import Linear, Norm, init_linear, linear, rmsnorm


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nheads, conv_ch


def init_mamba2(cfg: ArchConfig, *, generator: torch.Generator) -> dict:
    """JAX-layout parameters of one Mamba2 block on the generator's device,
    with the JAX package's scales and constants."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    dev = generator.device
    d_proj = 2 * d_in + 2 * s.n_groups * s.d_state + nheads    # z, x, B, C, dt
    return {
        "in_proj": init_linear(cfg.d_model, d_proj, generator=generator),
        "conv_w": torch.randn((s.conv_kernel, conv_ch), generator=generator, device=dev)
        * (1.0 / s.conv_kernel) ** 0.5,
        "conv_b": torch.zeros((conv_ch,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, dtype=torch.float32)).to(dev),
        "D": torch.ones((nheads,), device=dev),
        "dt_bias": torch.full((nheads,), -2.0, device=dev),
        "norm": {"g": torch.ones((d_in,), device=dev)},
        "out_proj": init_linear(d_in, cfg.d_model, generator=generator),
    }


def mamba2_shapes(cfg: ArchConfig) -> dict:
    """{name: shape} of ``init_mamba2``'s tree, dotted, without allocating it."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    d_proj = 2 * d_in + 2 * s.n_groups * s.d_state + nheads
    return {"in_proj.w": (cfg.d_model, d_proj), "conv_w": (s.conv_kernel, conv_ch),
            "conv_b": (conv_ch,), "A_log": (nheads,), "D": (nheads,), "dt_bias": (nheads,),
            "norm.g": (d_in,), "out_proj.w": (d_in, cfg.d_model)}


class Mamba2(nn.Module):
    """One Mamba2 block's parameters under JAX's names: ``in_proj``,
    ``conv_w`` (K, ch), ``conv_b``, ``A_log``, ``D``, ``dt_bias`` (nh,),
    ``norm`` and ``out_proj``."""

    def __init__(self, in_proj: dict, conv_w, conv_b, A_log, D, dt_bias, norm: dict,
                 out_proj: dict):
        super().__init__()
        self.in_proj = Linear(**in_proj)
        self.conv_w = nn.Parameter(conv_w)
        self.conv_b = nn.Parameter(conv_b)
        self.A_log = nn.Parameter(A_log)
        self.D = nn.Parameter(D)
        self.dt_bias = nn.Parameter(dt_bias)
        self.norm = Norm(**norm)
        self.out_proj = Linear(**out_proj)


class SSMLayer(nn.Module):
    """One layer of an SSM or hybrid stack: ``mamba`` and its pre-norm
    ``n1``."""

    def __init__(self, mamba: dict, n1: dict):
        super().__init__()
        self.mamba = Mamba2(**mamba)
        self.n1 = Norm(**n1)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``, with no
    threshold (torch's ``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv_window(full: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise conv1d of the (B, K-1+L, ch) window ``full`` with w (K, ch)
    -> (B, L, ch): the K shifted products summed in JAX's order, then the
    bias."""
    K = w.shape[0]
    L = full.shape[1] - (K - 1)
    return sum(full[:, i:i + L, :] * w[i] for i in range(K)) + b


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d of x (B, L, ch): the window zero-padded."""
    return _conv_window(torch.nn.functional.pad(x, (0, 0, w.shape[0] - 1, 0)), w, b)


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    """(z, x, B, C, dt) of the in_proj output."""
    s, d_in, nheads, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, nheads], dim=-1)


def mamba2(p: Mamba2, u: torch.Tensor, cfg: ArchConfig, policy: NumericsPolicy, *,
           cache: dict | None = None):
    """u (B, L, d) -> (y (B, L, d), cache).

    cache: ``init_ssm_cache``'s {"ssm": (B, nh, p, N), "conv": (B, K-1,
    ch)}; its entries are replaced with the state after the L tokens (the
    per-token recurrence).  Without a cache: the chunked SSD, L a multiple
    of ``cfg.ssm.chunk``."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    B_, L, _ = u.shape
    hp, N, Q = s.head_dim, s.d_state, s.chunk

    zxbcdt = linear(p.in_proj, u, policy, site="ssm")
    z, xs, Bc, Cc, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xs, Bc, Cc], dim=-1)
    conv_w, conv_b = whole_param(p.conv_w), whole_param(p.conv_b)
    held = None if cache is None else _whole_cache(cache, nheads, conv_ch)

    if cache is not None:
        # Decode: prepend the conv state, run the conv over the K-1+L window.
        full = torch.cat([held["conv"], xbc], dim=1)
        xbc = _conv_window(full, conv_w, conv_b)
        new_conv = full[:, -(s.conv_kernel - 1):, :]
    else:
        xbc = _causal_conv(xbc, conv_w, conv_b)
    xbc = silu(xbc)
    xs = xbc[..., :d_in].reshape(B_, L, nheads, hp)
    Bc = xbc[..., d_in:d_in + N]                        # (B, L, N)  G=1
    Cc = xbc[..., d_in + N:]                            # (B, L, N)

    dt = softplus(dt + whole_param(p.dt_bias))          # (B, L, nh)
    A = -torch.exp(whole_param(p.A_log))                # (nh,)
    dA = dt * A                                         # (B, L, nh)  log-decay
    xdt = xs * dt[..., None]                            # (B, L, nh, p)

    if cache is not None:
        # state <- state * exp(dA) + B (x dt);  y = C . state, token by token
        exact_fp32()
        state, ys = held["ssm"], []
        for t in range(L):
            state = state * torch.exp(dA[:, t])[:, :, None, None]
            state = state + torch.einsum("bn,bhp->bhpn", Bc[:, t], xdt[:, t])
            ys.append(torch.einsum("bn,bhpn->bhp", Cc[:, t], state))
        y = torch.stack(ys, dim=1)                      # (B, L, nh, p)
        _put_cache(cache, state, new_conv, nheads, conv_ch)
    else:
        y = ssd_chunked(xdt, Bc, Cc, dA, Q, policy)

    y = y + whole_param(p.D)[None, None, :, None] * xs   # skip connection
    y = y.reshape(B_, L, d_in) * silu(z)
    y = rmsnorm(p.norm, y, cfg.norm_eps)
    return linear(p.out_proj, y, policy, site="ssm"), cache


def _whole_cache(cache: dict, nheads: int, conv_ch: int) -> dict:
    """The cache's ``ssm`` (B, nh, p, N) and ``conv`` (B, K-1, ch) with
    every head and channel: a rank's blocks over "model" gathered under a
    mesh."""
    mesh = current_mesh()
    out = dict(cache)
    if mesh is not None and cache["ssm"].shape[1] != nheads:
        out["ssm"] = mesh.all_gather(cache["ssm"], "model", dim=1)
    if mesh is not None and cache["conv"].shape[2] != conv_ch:
        out["conv"] = mesh.all_gather(cache["conv"], "model", dim=2)
    return out


def _put_cache(cache: dict, state, conv, nheads: int, conv_ch: int) -> None:
    """Replace the cache's entries with the state after the step, cut to
    this rank's blocks where the cache holds blocks."""
    mesh = current_mesh()
    if cache["ssm"].shape[1] != nheads:
        state = mesh.block(state, "model", 1).contiguous()
    if cache["conv"].shape[2] != conv_ch:
        conv = mesh.block(conv, "model", 2).contiguous()
    cache["ssm"], cache["conv"] = state, conv


def masked_decay(decay: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """exp(decay) on the mask, 0 off it, as ``exp(where(mask, decay, -inf))``:
    the values of JAX's ``where(mask, exp(decay), 0)``, but a finite
    gradient where ``decay`` off the mask overflows ``exp``."""
    return torch.exp(torch.where(mask, decay, -math.inf))


def ssd_chunked(xdt, Bc, Cc, dA, Q: int, policy: NumericsPolicy):
    """The SSD scan (JAX ``_ssd_chunked``). xdt (B, L, nh, p), Bc/Cc (B, L,
    N), dA (B, L, nh) -> (B, L, nh, p).

    JAX's values without its dead products: the chunk states are made for
    every chunk but the last, and a row of one chunk runs the scores and
    intra-chunk products alone."""
    B_, L, nh, hp = xdt.shape
    N = Bc.shape[-1]
    if L % Q:
        raise ValueError(f"the SSD scan takes whole chunks: sequence {L} is not a multiple of "
                         f"the chunk {Q}")
    c = L // Q
    xc = xdt.reshape(B_, c, Q, nh, hp)
    Bcc = Bc.reshape(B_, c, Q, N)
    Ccc = Cc.reshape(B_, c, Q, N)
    dAc = dA.reshape(B_, c, Q, nh)
    cum = torch.cumsum(dAc, dim=2)                      # (B, c, Q, nh)

    # Intra-chunk: an attention-like masked product.
    scores = policy_einsum("bcln,bcsn->bcls", Ccc, Bcc, policy, site="ssm")
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # l, s -> (B, c, Q, Q, nh)
    li = torch.arange(Q, device=xdt.device)
    mask = (li[:, None] >= li[None, :])[None, None, :, :, None]
    Tm = masked_decay(decay, mask) * scores[..., None]      # (B, c, Q, Q, nh)
    y_intra = policy_einsum("bclsh,bcshp->bclhp", Tm, xc, policy, site="ssm")
    if c == 1:
        # The state entering the only chunk is zero: JAX's inter-chunk product
        # adds zeros (a LUT product with a zero operand is a zero), and its
        # chunk state feeds nothing.
        return y_intra.reshape(B_, L, nh, hp)

    # Chunk states: S_c = sum_s exp(cum_last - cum_s) B_s x_s^T, for every
    # chunk but the last (the state after it feeds nothing).
    to_end = torch.exp(cum[:, :-1, -1:, :] - cum[:, :-1])      # (B, c-1, Q, nh)
    Sc = policy_einsum("bcsn,bcshp->bchpn", Bcc[:, :-1], xc[:, :-1] * to_end[..., None], policy,
                       site="ssm")

    # Inter-chunk recurrence over c, in order: the state entering each chunk.
    seg = torch.exp(cum[:, :-1, -1, :])                 # (B, c-1, nh) chunk decay
    h = torch.zeros((B_, nh, hp, N), dtype=torch.float32, device=xdt.device)
    hs = [h]
    for t in range(c - 1):
        h = h * seg[:, t][:, :, None, None] + Sc[:, t]
        hs.append(h)
    hs = torch.stack(hs, dim=1)                         # (B, c, nh, p, N)
    y_inter = policy_einsum("bcln,bchpn->bclhp", Ccc, hs, policy, site="ssm")
    y_inter = y_inter * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(B_, L, nh, hp)


def init_ssm_cache(cfg: ArchConfig, batch: int, device) -> dict:
    """A zero recurrent state: {"ssm": (B, nh, p, N), "conv": (B, K-1, ch)}."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    return {"ssm": torch.zeros((batch, nheads, s.head_dim, s.d_state), device=device),
            "conv": torch.zeros((batch, s.conv_kernel - 1, conv_ch), device=device)}
