"""Language-model architecture configs: the fields the dense serving path reads.

The port's twin of ``repro.configs.base``: a frozen ``ArchConfig`` per
architecture, registered by name (``get_arch``), and ``reduced`` for the
smoke-test shape the JAX package's tests use.  Only the dense family is
ported; MoE, SSM, hybrid and encoder-decoder fields come with their
slices.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    sliding_window: int = 0      # 0 = full attention
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"          # swiglu | gelu

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0


ARCH_REGISTRY: dict[str, ArchConfig] = {}
# Modules that register an architecture when imported.
_ARCH_MODULES = ("granite_3_2b",)


def register(cfg: ArchConfig) -> ArchConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    for module in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{module}")
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Smoke-test variant: same family and topology, tiny widths (the
    values of ``repro.configs.base.reduced``)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"only the dense family is ported, not {cfg.family!r}")
    base = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=256,
        vocab=512,
        d_head=32,
    )
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
