"""Optimizers, schedules and clipping: the twin of ``repro.optim.optimizers``.

Functional, as in the JAX package: ``make_optimizer(name, ...)`` returns
an ``Optimizer`` with ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``.  Parameter, gradient
and state trees are nested dicts and lists of tensors (a model's
``dict(named_parameters())`` is one).  ``apply_updates`` adds the updates
to the parameters in place, under ``torch.no_grad()``: a model's
``nn.Parameter``s stay the same objects, where JAX returns a new tree.

SGD-momentum is the paper's optimizer.  AdamW and Adafactor come with the
LM slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


@torch.no_grad()
def apply_updates(params, updates):
    """``params += updates`` leaf by leaf, in place; returns ``params``."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u.to(p.dtype))
    return params


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


# ---------------------------------------------------------------- schedules
def cosine_schedule(base_lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def constant_schedule(base_lr: float):
    return lambda step: torch.tensor(base_lr, dtype=torch.float32)


# ---------------------------------------------------------------- momentum
def sgdm(lr, momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    """SGD with momentum, as the JAX package writes it:
    ``mu = momentum * mu + g`` and ``p += -lr * (mu + weight_decay * p)``
    (``torch.optim.SGD`` adds the decay to g before the momentum instead)."""
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params), "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        upd = tree_map(lambda m, p: -lr_t * (m + weight_decay * p), mu, params)
        return upd, {"mu": mu, "step": step}

    return Optimizer(init, update)


def make_optimizer(name: str, lr=1e-3, **kw) -> Optimizer:
    if name == "sgdm":
        return sgdm(lr, **kw)
    if name in ("adamw", "adafactor"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet: it comes with the slice that ports "
            f"attention and the LM zoo; the port has 'sgdm'")
    raise ValueError(f"unknown optimizer {name!r}")
