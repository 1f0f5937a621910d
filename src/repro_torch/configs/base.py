"""Language-model architecture configs: the fields serving and training read.

The port's twin of ``repro.configs.base``: a frozen ``ArchConfig`` per
architecture, registered by name (``get_arch``), and ``reduced`` for the
smoke-test shape the JAX package's tests use.  The dense (q/k/v biases
too), MoE (an MoE FFN in every layer, no shared expert), SSM (Mamba2),
hybrid (Mamba2 with a weight-shared attention block) and encoder-decoder
(whisper-style, the audio frontend a stub: the encoder takes precomputed
frame embeddings) families are ported, and a decoder-only LM with frontend
tokens (llava: precomputed patch embeddings prepended to the text,
``lm_forward(embeds=)``).  An MoE stack has an MoE FFN in every layer or,
llama4-style (``interleave=2``), in every second one: (dense, MoE) pairs;
its MoE FFN may add always-on shared experts.  Every JAX arch is
registered.  JAX's ``fsdp`` is carried (the sharding rules read it; FSDP
placement itself is a later slice); its ``scan_layers`` and ``scan_block``
hints are not: the port loops over its layers (a llama4 stack over its
pairs).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden width
    interleave: int = 1          # MoE every `interleave`-th layer (1 = all)
    n_shared_experts: int = 0    # llama4-style always-on shared expert(s)
    capacity_factor: float = 1.25

    def __post_init__(self):
        if self.interleave not in (1, 2):
            # JAX stacks the il - 1 dense layers of a block under "dense" with
            # an extra axis; no registered config has such a block.
            raise NotImplementedError(
                f"interleave={self.interleave}: only an MoE FFN in every layer (1) or in "
                f"every second one, (dense, MoE) pairs (2), is ported")


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int                 # N
    head_dim: int = 64           # p
    expand: int = 2              # d_inner = expand * d_model
    conv_kernel: int = 4
    n_groups: int = 1
    chunk: int = 256             # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0          # hybrid: the shared attention block after every k-th layer
    n_enc_layers: int = 0        # encdec: encoder depth (n_layers = decoder)
    sliding_window: int = 0      # 0 = full attention
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"          # swiglu | gelu
    # Modality frontend stubs: the number of precomputed embedding positions
    # (audio frames of an encdec encoder; image patches of a decoder-only LM).
    n_frontend_tokens: int = 0
    frontend: str = "none"       # none | audio | vision
    # Training (the JAX package's defaults):
    remat: bool = True           # recompute each block's activations in the backward
    optimizer: str = "adamw"     # adamw | adafactor | sgdm
    q_chunk: int = 1024          # attention query-chunk length of the einsum lowering
    fsdp: bool = False           # the sharding rules' "F": the other matrix dim over "data"
    cache_dtype: str = "float32"  # KV-cache storage type ("bfloat16" halves it; the
                                  # kernels read float32 views of it)

    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm", "hybrid", "encdec"):
            raise NotImplementedError(f"only the dense, moe, ssm, hybrid and encdec families "
                                      f"are ported, not {self.family!r}")
        if (self.family == "encdec") != (self.n_enc_layers > 0):
            raise ValueError(f"family {self.family!r} and n_enc_layers={self.n_enc_layers} "
                             f"disagree")
        if (self.family == "moe") != (self.moe is not None):
            raise ValueError(f"family {self.family!r} and moe={self.moe!r} disagree")
        if self.moe is not None and self.n_layers % self.moe.interleave:
            raise ValueError(f"n_layers={self.n_layers} is not a multiple of the MoE "
                             f"interleave {self.moe.interleave}: the stack is whole "
                             f"(dense, MoE) pairs")
        if (self.family in ("ssm", "hybrid")) != (self.ssm is not None):
            raise ValueError(f"family {self.family!r} and ssm={self.ssm!r} disagree")
        if (self.family == "hybrid") != (self.attn_every > 0):
            raise ValueError(f"family {self.family!r} and attn_every={self.attn_every} "
                             f"disagree")

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0


ARCH_REGISTRY: dict[str, ArchConfig] = {}
# Modules that register an architecture when imported.
_ARCH_MODULES = ("granite_3_2b", "granite_moe_3b_a800m", "mamba2_780m", "zamba2_1_2b",
                 "whisper_base", "llava_next_34b", "qwen2_5_32b", "qwen1_5_110b", "stablelm_12b",
                 "llama4_maverick_400b_a17b")


def register(cfg: ArchConfig) -> ArchConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    for module in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{module}")
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def cut(cfg: ArchConfig, *, n_layers: int | None = None,
        n_experts: int | None = None) -> ArchConfig:
    """``cfg`` at another depth and, for an MoE arch, with its routed
    experts cut to ``n_experts`` (llama4 trains with 16 on one card, the
    count of Llama-4-Scout); the widths stay.  A llama4 depth must be whole
    (dense, MoE) pairs."""
    changes = {} if n_layers is None else {"n_layers": n_layers}
    if n_experts is not None:
        if cfg.moe is None:
            raise ValueError(f"{cfg.name} has no experts to cut")
        changes["moe"] = dataclasses.replace(cfg.moe, n_experts=n_experts)
    return dataclasses.replace(cfg, **changes) if changes else cfg


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Smoke-test variant: same family and topology, tiny widths (the
    values of ``repro.configs.base.reduced``)."""
    base = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=min(cfg.n_heads, 4) or 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 0,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        d_head=32 if cfg.n_heads else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_frontend_tokens=min(cfg.n_frontend_tokens, 8),
        fsdp=False,
    )
    if cfg.moe is not None:
        base["moe"] = dataclasses.replace(cfg.moe, n_experts=min(cfg.moe.n_experts, 8),
                                          top_k=min(cfg.moe.top_k, 2), d_ff=64)
    if cfg.ssm is not None:
        base["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=8)
    if cfg.attn_every:
        base["attn_every"] = 2
        base["n_layers"] = 4
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
