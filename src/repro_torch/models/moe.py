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

Under an ambient mesh (``launch/mesh.py``) the routing is the whole
batch's, as GSPMD's is in JAX: each rank routes its own rows (the router is
replicated), then ``whole_routing`` gathers every data rank's choices and
router probabilities, so the capacity comes from the whole T, a token's
slot is its rank in token-major order over the whole batch (the lower data
ranks' tokens first) and the aux loss takes its means over the whole
batch.  A rank's buffer holds its own tokens at those slots.  The experts
are split over "model" (expert parallelism): each rank runs the banks of
its E / model experts on its block of the buffer (the batched GEMM kernel;
the stacked expert-bank launch stays off under an active mesh, as in JAX),
and the outputs are gathered over "model" before the combine.  Experts are
a parallel axis of the batched kernel, so the mesh's output is bitwise the
single-device layer's; the buffer's gradient is gathered over "model" in
the backward, so its scatter to the tokens is the single-device one, and
each bank's gradient is its rank's own, summed over the data axes.  A bank
held whole (the kill switch's gathered layer) runs as on one device on this
rank's buffer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import NumericsPolicy
from repro_torch.distributed import shard_fused as sf
from repro_torch.kernels import ops
from repro_torch.launch.mesh import current_mesh, single_device
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


def whole_routing(probs: torch.Tensor, sel: torch.Tensor, layer=None):
    """(router probabilities (T_all, E), choices (T_all, k) of the whole
    batch, the index of this rank's first token in it) from this rank's
    own (T, E) and (T, k): themselves without a mesh or data split; under
    one, every data rank's in rank order (the probabilities gathered
    differentiably: their gradient reaches each rank's own rows).
    ``layer`` names the MoE layer (its router weight's id), for the
    k-split oracle's stand-in (``distributed/oracle.py``)."""
    mesh = current_mesh()
    if mesh is None or mesh.data_size == 1:
        return probs, sel, 0
    axes = mesh.data_axes
    return (sf.gather(probs, mesh, axes, 0), mesh.all_gather(sel, axes, dim=0),
            mesh.index(axes) * sel.shape[0])


class _Bank:
    """A bank's ``Linear`` as ``ffn`` reads it: ``w``, no ``b``."""

    def __init__(self, w):
        self.w, self.b = w, None


def _banks_expert_parallel(ew, buf, cfg: ArchConfig, policy: NumericsPolicy, mesh):
    """The banks of this rank's E / model experts on its block of the
    buffer (E, C, d), the outputs gathered over "model"; each bank's
    gradient summed over the data axes, the buffer's gathered over
    "model"."""
    own = sf.scatter(buf, mesh, "model", 0)
    banks = {n: _Bank(sf.data_parallel(lin.w)) for n, lin in ew.items()}
    with single_device():
        out = ffn(banks, own, policy, cfg.act)                      # batched over E / model
    return sf.gather(out, mesh, "model", 0)


def expert_banks(ew, buf, cfg: ArchConfig, policy: NumericsPolicy):
    """Every expert's FFN on its rows of the buffer (E, C, d) -> (E, C, d):
    under a mesh that splits the experts, this rank's banks
    (``_banks_expert_parallel``); else the stacked expert-bank launch where
    it engages, or the E-batched products."""
    mesh = current_mesh()
    if mesh is not None and sf.spec_of(ew["wu"].w)[0] == "model":
        return _banks_expert_parallel(ew, buf, cfg, policy, mesh)
    if (cfg.act == "swiglu" and all(ew[s].b is None for s in ("wg", "wu", "wd"))
            and ops.decode_moe_ffn_enabled(policy, buf.shape[1])):
        return ops.decode_moe_ffn(buf, ew["wg"].w, ew["wu"].w, ew["wd"].w, policy)
    return ffn(ew, buf, policy, cfg.act)                            # batched over E


def moe_ffn(p, x: torch.Tensor, cfg: ArchConfig, policy: NumericsPolicy):
    """x (B, S, d) -> (y (B, S, d), aux loss scalar).  ``p`` has
    ``router`` (a ``layers.Linear``), ``experts`` (wg/wu/wd ``Linear``s
    holding the banks) and, with shared experts, ``shared`` (wg/wu/wd of
    one FFN over every token, per op at sites wg/wu/wd in every mode).
    Under a mesh ``x`` is this rank's rows and the routing the whole
    batch's (``whole_routing``)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    xf = x.reshape(T, d)

    probs, gate, sel = route(p["router"], xf, cfg, policy)
    probs_all, sel_all, first = whole_routing(probs, sel, id(p["router"].w))
    C = capacity(cfg, sel_all.shape[0])

    # Slot of each (token, choice): its rank within its expert in
    # token-major order over the whole batch (an exclusive prefix sum of
    # the one-hot choices); this rank's tokens' slots.
    e_all = sel_all.reshape(-1)                                     # (T_all*k,)
    onehot = F.one_hot(e_all, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    slot = pos.gather(1, e_all[:, None])[first * k:(first + T) * k, 0]
    e_flat = sel.reshape(-1)                                        # (T*k,)
    keep = slot < C
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = xf.new_zeros((E, C, d))
    buf[e_flat[keep], slot[keep]] = xf[tok[keep]]

    out = expert_banks(p["experts"], buf, cfg, policy)
    got = out[e_flat, slot.clamp(max=C - 1)]                        # (T*k, d)
    got = torch.where(keep[:, None], got, 0.0)
    contrib = (got * gate.reshape(-1)[:, None]).reshape(T, k, d)
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]
    if "shared" in p:       # the always-on shared experts, after the routed sum (JAX's order)
        y = y + ffn(p["shared"], xf, policy, cfg.act)

    # Switch-style load-balance loss: E * sum_e f_e * P_e / k, the means
    # over the whole batch.
    assign_frac = F.one_hot(sel_all, E).to(torch.float32).sum(1).mean(0)
    router_frac = probs_all.mean(0)
    aux = E * torch.sum(assign_frac * router_frac) / k
    return y.reshape(B, S, d), aux
