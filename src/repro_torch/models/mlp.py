"""Feed-forward blocks: SwiGLU and GELU, policy-routed GEMMs."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.policy import NumericsPolicy
from repro_torch.kernels.decode_chain import silu
from .layers import init_linear, linear


def init_ffn(d: int, d_ff: int, act: str = "swiglu", *, generator: torch.Generator) -> dict:
    names = ("wg", "wu", "wd") if act == "swiglu" else ("wu", "wd")
    dims = {"wg": (d, d_ff), "wu": (d, d_ff), "wd": (d_ff, d)}
    return {n: init_linear(*dims[n], generator=generator) for n in names}


def ffn(p, x: torch.Tensor, policy: NumericsPolicy, act: str = "swiglu") -> torch.Tensor:
    """The FFN of a block; its sites ("wg"/"wu"/"wd") name the projections.
    ``p`` maps those names to ``layers.Linear``s.  With (E, d, F) expert
    banks and x (E, C, d) it is every expert's FFN at once: each projection
    is one E-batched product.  The Megatron roles: wg/wu column-parallel,
    wd row-parallel (under a mesh, ``distributed/shard_fused``)."""
    if act == "swiglu":
        return linear(p["wd"], silu(linear(p["wg"], x, policy, site="wg", kind="column"))
                      * linear(p["wu"], x, policy, site="wu", kind="column"), policy,
                      site="wd", kind="row")
    return linear(p["wd"], F.gelu(linear(p["wu"], x, policy, site="wu", kind="column"),
                                  approximate="tanh"), policy, site="wd", kind="row")
