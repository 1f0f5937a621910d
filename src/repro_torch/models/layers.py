"""Primitive layers, every multiplication routed through a NumericsPolicy.

The AMDENSE analogue (paper §VI-C): ``linear`` sends its GEMM through
``ops.policy_matmul`` under the layer's numerics site.  Weights keep the
JAX layout, (d_in, d_out) applied as ``x @ w + b``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.policy import NumericsPolicy
from repro_torch.kernels.ops import policy_matmul


class Linear(nn.Module):
    """A dense layer's parameters: ``w`` (d_in, d_out) and optional ``b``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = None if b is None else nn.Parameter(b)


def init_linear(d_in: int, d_out: int, *, generator: torch.Generator, bias: bool = False,
                scale: float | None = None) -> dict:
    """JAX-layout parameters of a dense layer on the CPU: w ~ N(0, 1/d_in)."""
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    p = {"w": torch.randn((d_in, d_out), generator=generator) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,))
    return p


def linear(p: Linear, x: torch.Tensor, policy: NumericsPolicy,
           site: str | None = None) -> torch.Tensor:
    y = policy_matmul(x, p.w, policy, site)
    if p.b is not None:
        y = y + p.b
    return y
