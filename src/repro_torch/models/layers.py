"""Primitive layers, every multiplication routed through a NumericsPolicy.

The AMDENSE analogue (paper §VI-C): ``linear`` sends its GEMM through
``ops.policy_matmul`` under the layer's numerics site, and ``unembed``
(the tied LM head) under site "unembed".  Weights keep the JAX layout,
(d_in, d_out) applied as ``x @ w + b``.  Elementwise products (norm
scales, activations) stay native, as in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.policy import NumericsPolicy
from repro_torch.kernels.ops import policy_matmul, rmsnorm_expr


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
           site: str | None = None) -> torch.Tensor:
    y = policy_matmul(x, p.w, policy, site)
    if p.b is not None:
        y = y + p.b
    return y


class Norm(nn.Module):
    """An rmsnorm scale ``g`` (d,)."""

    def __init__(self, g: torch.Tensor):
        super().__init__()
        self.g = nn.Parameter(g)


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return rmsnorm_expr(x, p.g, eps)


class Embedding(nn.Module):
    """A token embedding ``emb`` (vocab, d) and, for the tied LM head
    (``tied``), its transpose ``emb_t`` (d, vocab), made contiguous: the
    head's GEMM takes contiguous operands, and transposing per decode step
    would copy the whole table (400 MB at granite-3-2b) every step.
    ``emb_t`` is a buffer made again from ``emb`` when ``emb`` has changed
    in place since it was made (an optimizer step, a checkpoint restore), as
    its version counter tells.  An untied model keeps none (5 GB at
    qwen1.5-110b's vocab of 152064)."""

    def __init__(self, emb: torch.Tensor, tied: bool):
        super().__init__()
        self.emb = nn.Parameter(emb)
        if tied:
            self.register_buffer("emb_t", emb.detach().T.contiguous(), persistent=False)
        self._emb_t_of = self.emb._version

    def transposed(self) -> torch.Tensor:
        if self._emb_t_of != self.emb._version:
            with torch.no_grad():
                self.emb_t = self.emb.detach().T.contiguous()
            self._emb_t_of = self.emb._version
        return self.emb_t


def embed(p: Embedding, ids: torch.Tensor) -> torch.Tensor:
    return p.emb[ids]


def unembed(p: Embedding, x: torch.Tensor, policy: NumericsPolicy) -> torch.Tensor:
    """Tied LM head: x @ emb^T under numerics site "unembed".  Under grad
    the product takes ``emb.T`` itself, so that its dw reaches ``emb``."""
    w = p.emb.T if torch.is_grad_enabled() and p.emb.requires_grad else p.transposed()
    return policy_matmul(x, w, policy, "unembed")
