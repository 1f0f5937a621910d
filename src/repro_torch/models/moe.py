"""Mixture-of-Experts FFN: top-k routing, capacity-based static dispatch.

The port of ``repro.models.moe``: every token picks its top-k experts
from a policy-routed router GEMM (site "router"); each (token, choice)
takes a slot in its expert's capacity buffer (E, C, d) by its rank in
token-major order, and slots past the capacity C are dropped; the expert
FFNs run over the stacked banks, and each token sums its k gated expert
outputs.  The capacity is ``round_up(max(int(T*k*cf/E), 1), 8)``, with
Python's ``int`` truncation, as in the JAX package, so the same tokens
drop.

Under an ``amsim`` (``amsim_torch``) leaf for wg/wu/wd and a capacity of
at most ``ops.MOE_FFN_MAX_C`` rows, the expert FFN is one stacked
expert-bank launch (its plain version); otherwise it is ``mlp.ffn`` over
the banks, three E-batched products (under ``amsim`` the batched GEMM
kernel).  The two give the same bits.

The combine folds each token's k contributions in choice order from +0.0,
so it is deterministic on the card (an ``index_add_`` would add with
atomics in no fixed order); it is the order of XLA's CPU scatter-add.
A llama4-style MoE FFN then adds its shared experts' FFN over every token
(``ffn`` at sites wg/wu/wd, per op also in a decode step), as JAX does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import NumericsPolicy
from repro_torch.kernels import ops
from .layers import init_linear, linear
from .mlp import ffn, init_ffn


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def capacity(cfg: ArchConfig, tokens: int) -> int:
    """Capacity rows per expert for a batch of ``tokens`` tokens."""
    m = cfg.moe
    return _round_up(max(int(tokens * m.top_k * m.capacity_factor / m.n_experts), 1), 8)


def init_moe(cfg: ArchConfig, *, generator: torch.Generator) -> dict:
    """The router (d, E), the stacked expert banks wg/wu (E, d, F), wd
    (E, F, d) (wu/wd only for gelu), and, with ``n_shared_experts``, the
    always-on ``shared`` FFN of width F x n_shared, with the JAX package's
    scales.  Each bank is allocated once and drawn expert by expert in
    place (e0.wg, e0.wu, e0.wd, e1.wg, ...: the draws of ``init_ffn`` for
    each expert in turn), so that a bank of 128 x 5120 x 8192 is never held
    twice; then the router, then the shared FFN."""
    m, d, dev = cfg.moe, cfg.d_model, generator.device
    dims = {"wg": (d, m.d_ff), "wu": (d, m.d_ff), "wd": (m.d_ff, d)}
    names = ("wg", "wu", "wd") if cfg.act == "swiglu" else ("wu", "wd")
    banks = {n: torch.empty((m.n_experts, *dims[n]), device=dev) for n in names}
    for e in range(m.n_experts):
        for n in names:
            banks[n][e].normal_(generator=generator).mul_((1.0 / dims[n][0]) ** 0.5)
    p = {"router": init_linear(d, m.n_experts, generator=generator),
         "experts": {n: {"w": w} for n, w in banks.items()}}
    if m.n_shared_experts:
        p["shared"] = init_ffn(d, m.d_ff * m.n_shared_experts, cfg.act, generator=generator)
    return p


def route(router, xf: torch.Tensor, cfg: ArchConfig, policy: NumericsPolicy):
    """xf (T, d) -> (router probs (T, E), renormalised gates (T, k), chosen
    experts (T, k)), the top-k of the float32 softmax of the router GEMM.
    Among equal probabilities the lower expert index comes first, as in
    ``jax.lax.top_k`` (``torch.topk`` fixes no order for ties): the first k
    of a stable descending sort."""
    logits = linear(router, xf, policy, site="router")
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gate, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, sel = gate[:, :cfg.moe.top_k], sel[:, :cfg.moe.top_k]
    return probs, gate / gate.sum(dim=-1, keepdim=True), sel


def moe_ffn(p, x: torch.Tensor, cfg: ArchConfig, policy: NumericsPolicy):
    """x (B, S, d) -> (y (B, S, d), aux loss scalar).  ``p`` has
    ``router`` (a ``layers.Linear``), ``experts`` (wg/wu/wd ``Linear``s
    holding the banks) and, with shared experts, ``shared`` (wg/wu/wd of
    one FFN over every token, per op at sites wg/wu/wd in every mode)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    C = capacity(cfg, T)
    xf = x.reshape(T, d)

    probs, gate, sel = route(p["router"], xf, cfg, policy)

    # Slot of each (token, choice): its rank within its expert in
    # token-major order (an exclusive prefix sum of the one-hot choices).
    e_flat = sel.reshape(-1)                                        # (T*k,)
    onehot = F.one_hot(e_flat, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    slot = pos.gather(1, e_flat[:, None])[:, 0]
    keep = slot < C
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = xf.new_zeros((E, C, d))
    buf[e_flat[keep], slot[keep]] = xf[tok[keep]]

    ew = p["experts"]
    if (cfg.act == "swiglu" and all(ew[s].b is None for s in ("wg", "wu", "wd"))
            and ops.decode_moe_ffn_enabled(policy, C)):
        out = ops.decode_moe_ffn(buf, ew["wg"].w, ew["wu"].w, ew["wd"].w, policy)
    else:
        out = ffn(ew, buf, policy, cfg.act)                         # batched over E

    got = out[e_flat, slot.clamp(max=C - 1)]                        # (T*k, d)
    got = torch.where(keep[:, None], got, 0.0)
    contrib = (got * gate.reshape(-1)[:, None]).reshape(T, k, d)
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]
    if "shared" in p:       # the always-on shared experts, after the routed sum (JAX's order)
        y = y + ffn(p["shared"], xf, policy, cfg.act)

    # Switch-style load-balance loss: E * sum_e f_e * P_e / k.
    assign_frac = F.one_hot(sel, E).to(torch.float32).sum(1).mean(0)
    router_frac = probs.mean(0)
    aux = E * torch.sum(assign_frac * router_frac) / k
    return y.reshape(B, S, d), aux
