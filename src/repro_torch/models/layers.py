"""Primitive layers, every multiplication routed through a NumericsPolicy.

The AMDENSE analogue (paper §VI-C): ``linear`` sends its GEMM through
``ops.policy_matmul`` under the layer's numerics site, and ``unembed``
(the tied LM head) under site "unembed".  Weights keep the JAX layout,
(d_in, d_out) applied as ``x @ w + b``.  Elementwise products (norm
scales, activations) stay native, as in the JAX package.

``linear`` takes the layer's Megatron role (``kind``: "column", "row" or
None, mirroring ``distributed/sharding._RULES``): under an ambient mesh
its product goes through ``distributed/shard_fused.parallel_matmul``, the
column- or row-parallel kernels per rank or the replicated dispatch.  The
tied head is a column-parallel product of ``emb.T``; granite-3-2b's odd
vocab shards the table over d instead, so there it takes the replicated
dispatch on the whole table, gathered once per weight version, and the
lookup reads the whole table too.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.policy import NumericsPolicy
from repro_torch.distributed import shard_fused as sf
from repro_torch.distributed.sharding import gather_tensor
from repro_torch.kernels.ops import rmsnorm_expr
from repro_torch.launch.mesh import current_mesh


class Linear(nn.Module):
    """A dense layer's parameters: ``w`` (d_in, d_out) and optional ``b``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = None if b is None else nn.Parameter(b)


def init_linear(d_in: int, d_out: int, *, generator: torch.Generator, bias: bool = False,
                scale: float | None = None) -> dict:
    """JAX-layout parameters of a dense layer on the generator's device:
    w ~ N(0, 1/d_in)."""
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    device = generator.device
    p = {"w": torch.randn((d_in, d_out), generator=generator, device=device) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def linear(p: Linear, x: torch.Tensor, policy: NumericsPolicy,
           site: str | None = None, kind: str | None = None) -> torch.Tensor:
    y = sf.parallel_matmul(x, p.w, policy, kind, site)
    if p.b is not None:
        y = y + sf.data_parallel(p.b)
    return y


class Norm(nn.Module):
    """An rmsnorm scale ``g`` (d,)."""

    def __init__(self, g: torch.Tensor):
        super().__init__()
        self.g = nn.Parameter(g)


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return rmsnorm_expr(x, sf.data_parallel(p.g), eps)


class Embedding(nn.Module):
    """A token embedding ``emb`` (vocab, d) and, for the tied LM head
    (``tied``), its transpose ``emb_t`` (d, vocab), made contiguous: the
    head's GEMM takes contiguous operands, and transposing per decode step
    would copy the whole table (400 MB at granite-3-2b) every step.
    ``emb_t`` is a buffer made again from ``emb`` when ``emb`` has changed
    in place since it was made (an optimizer step, a checkpoint restore), as
    its version counter tells.  An untied model keeps none (5 GB at
    qwen1.5-110b's vocab of 152064).  Under a mesh the table is this rank's
    block, and ``whole(transposed)`` gives the gathered table (or its
    transpose), kept in the same way per weight version."""

    def __init__(self, emb: torch.Tensor, tied: bool):
        super().__init__()
        self.emb = nn.Parameter(emb)
        if tied:
            self.register_buffer("emb_t", emb.detach().T.contiguous(), persistent=False)
        self._emb_t_of = self.emb._version
        self._whole = {}        # transposed? -> ((version, storage), the gathered table)

    def transposed(self) -> torch.Tensor:
        if self._emb_t_of != self.emb._version:
            with torch.no_grad():
                self.emb_t = self.emb.detach().T.contiguous()
            self._emb_t_of = self.emb._version
        return self.emb_t

    def whole(self, mesh, transposed: bool) -> torch.Tensor:
        key = (self.emb._version, self.emb.data_ptr())
        held = self._whole.get(transposed)
        if held is None or held[0] != key:
            full = gather_tensor(self.emb.detach(), sf.spec_of(self.emb), mesh)
            held = self._whole[transposed] = (key, full.T.contiguous() if transposed else full)
        return held[1]


def _grad_of(p: Embedding) -> bool:
    return torch.is_grad_enabled() and p.emb.requires_grad


def embed(p: Embedding, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``ids``.  Under a mesh the lookup reads the whole table:
    gathered per weight version, or, under grad, gathered differentiably
    (its gradient summed over the data axes)."""
    mesh = current_mesh()
    if mesh is None or not any(a is not None for a in sf.spec_of(p.emb)):
        return sf.data_parallel(p.emb)[ids]
    if _grad_of(p):
        return sf.gather_param(sf.data_parallel(p.emb), mesh, sf.spec_of(p.emb))[ids]
    return p.whole(mesh, transposed=False)[ids]


def unembed(p: Embedding, x: torch.Tensor, policy: NumericsPolicy) -> torch.Tensor:
    """Tied LM head: x @ emb^T under numerics site "unembed", a
    column-parallel product under a mesh (its output the vocab block of
    the table's spec).  Under grad the product takes ``emb.T`` itself, so
    that its dw reaches ``emb``."""
    mesh = current_mesh()
    if mesh is not None:
        spec = sf.spec_of(p.emb)[::-1]
        full = None if _grad_of(p) or spec == (None, None) else p.whole(mesh, transposed=True)
        return sf.parallel_matmul(x, p.emb.T, policy, "column", "unembed", w_spec=spec,
                                  w_full=full)
    w = p.emb.T if _grad_of(p) else p.transposed()
    return sf.parallel_matmul(x, w, policy, "column", "unembed")
