"""Optimizers, schedules and clipping: the twin of ``repro.optim.optimizers``.

Functional, as in the JAX package: ``make_optimizer(name, ...)`` returns
an ``Optimizer`` with ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``.  Parameter, gradient
and state trees are nested dicts and lists of tensors (a model's
``dict(named_parameters())`` is one).  ``apply_updates`` adds the updates
to the parameters in place, under ``torch.no_grad()``: a model's
``nn.Parameter``s stay the same objects, where JAX returns a new tree.

SGD-momentum is the paper's optimizer; AdamW and Adafactor train the LMs
(the granite configs take AdamW).  AdamW updates its moments in place,
so a full-width step holds the parameters, gradients, two moments and the
updates (five copies of the model), not seven.  The JAX package keeps an
LM's layers stacked on a leading axis, and Adafactor couples the elements
of a leaf (its factors, its update clip); ``stacks`` names the port's
per-layer tensors that form one JAX leaf, so that Adafactor computes on
the same stacked tensors as there.

Under an ambient mesh (``launch/mesh.py``) every optimizer runs on this
rank's blocks of the parameters (``param.spec``, placed by
``distributed/sharding.py``), and the few sums that cross a block go over
"model" in rank order: the global norm's squares (a sharded leaf's once a
block, a replicated leaf's once) and Adafactor's factor means and update
RMS over a split dim.  The data ranks hold the same gradients (summed by
the sharded ops), so nothing crosses the data axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.launch.mesh import current_mesh


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
    """``params += updates`` leaf by leaf (dict leaves paired by key), in
    place; returns ``params``."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params


def _split(spec) -> bool:
    return any(a is not None for a in spec)


def global_norm(tree, specs: dict | None = None) -> torch.Tensor:
    """The norm of every leaf together.  Under a mesh ``tree`` is a flat
    {name: this rank's block} dict and ``specs`` its {name: spec}: the
    split leaves' squares are summed over "model" in rank order, the
    replicated leaves' counted once."""
    mesh = current_mesh()
    if mesh is None or specs is None:
        return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                              for leaf in tree_leaves(tree)))
    split = whole = 0.0
    for name, leaf in tree.items():
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        if _split(specs.get(name, ())):
            split = split + sq
        else:
            whole = whole + sq
    if isinstance(split, torch.Tensor):
        split = mesh.ordered_sum(split, "model")
    return torch.sqrt(split + whole)


def clip_by_global_norm(grads, max_norm: float, specs: dict | None = None):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(grads, specs)
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


# ---------------------------------------------------------------- adamw
def _power(base: float, step: int) -> torch.Tensor:
    """base ** step in float32, as JAX's ``base ** step.astype(float32)``."""
    return torch.pow(torch.tensor(base, dtype=torch.float32),
                     torch.tensor(step, dtype=torch.float32))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root: the float64 root rounded
    to float32, which for a square root is the float32 root (53 >= 2 x 24
    + 2 bits).  XLA's and CUDA's float32 sqrt round correctly; torch's
    vectorised CPU sqrt is off by an ulp on ~0.6% of inputs."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW as the JAX package writes it: ``m = b1 m + (1 - b1) g``, ``v =
    b2 v + (1 - b2) g^2``, ``p += -lr ((m / c1) / (sqrt(v / c2) + eps) +
    weight_decay p)`` with ``c = 1 - b ** step``.  The moments are updated
    in place: the state passed in is the state returned."""
    def init(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params), "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        c1, c2 = 1 - _power(b1, step), 1 - _power(b2, step)

        def leaf(g, m, v, p):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            return -lr_t * ((m / c1) / (_sqrt(v / c2) + eps) + weight_decay * p)

        upd = tree_map(leaf, grads, state["m"], state["v"], params)
        return upd, {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init, update)


# ---------------------------------------------------------------- adafactor
def _stacked(tree: dict, stacks: dict) -> dict:
    """{JAX leaf name: tensor} of a flat {name: tensor} tree: each stack's
    members stacked on a new leading axis in order, every other tensor
    alone under its own name."""
    members = {n for names in stacks.values() for n in names}
    out = {name: torch.stack([tree[n] for n in names]) for name, names in stacks.items()}
    out.update({n: t for n, t in tree.items() if n not in members})
    return out


def adafactor(lr, eps: float = 1e-30, clip_threshold: float = 1.0, decay: float = 0.8,
              weight_decay: float = 0.0, stacks: dict | None = None) -> Optimizer:
    """Factored second moment without momentum (Shazeer & Stern 2018), as
    the JAX package writes it: a leaf of 2 or more dims keeps row and
    column factors over its last two dims, a vector its full second
    moment; the update is clipped by its RMS over the whole leaf.

    Parameters, gradients and updates are flat {name: tensor} dicts.
    ``stacks`` ({JAX leaf name: [member names in layer order]}, from
    ``models.transformer.lm_stacks``) makes each stack one leaf, as the JAX
    package's layer-stacked tree: a per-layer gain (d,) is then an (L, d)
    matrix, factored, and the clip RMS is taken over every layer.  The
    state ``f`` is keyed by JAX leaf name."""
    stacks = stacks or {}

    def specs_of(params: dict) -> dict:
        """{leaf name: spec} of the stacked leaves (a member's spec behind
        the layer axis); empty without a mesh."""
        if current_mesh() is None:
            return {}
        out = {n: tuple(getattr(p, "spec", ())) for n, p in params.items()}
        for name, names in stacks.items():
            member = tuple(getattr(params[names[0]], "spec", ()))
            out[name] = (None, *member) if member else ()
        return out

    def init(params):
        def leaf(p):
            if p.ndim >= 2:
                return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                         device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}
        return {"f": {n: leaf(p) for n, p in _stacked(params, stacks).items()}, "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        beta = 1.0 - _power(float(step), -decay)
        specs = specs_of(params)
        mesh = current_mesh()

        def mean(t, dim, axes):
            """torch.mean over ``dim``, across the blocks when the dim is
            split over ``axes``."""
            if mesh is None or axes is None:
                return torch.mean(t, dim=dim)
            return mesh.ordered_sum(torch.sum(t, dim=dim), axes) / (
                t.shape[dim] * mesh.axes_size(axes))

        def leaf(g, f, p, spec=()):
            # In place where a temporary of the leaf's size would be freed
            # at once: the same values, and a leaf of 5 GB (qwen1.5-110b's
            # head) holds two such temporaries at a time, not five.
            g = g.to(torch.float32)
            g2 = torch.square(g).add_(eps)
            spec = tuple(spec) + (None,) * (g.ndim - len(tuple(spec)))
            if g.ndim >= 2:
                r = beta * f["r"] + (1 - beta) * mean(g2, -1, spec[-1])
                c = beta * f["c"] + (1 - beta) * mean(g2, -2, spec[-2])
                del g2
                rc = mean(r, -1, spec[-2])[..., None]
                vhat = (r[..., None] / torch.clamp(rc[..., None], min=eps)) * c[..., None, :]
                u = vhat.clamp_(min=eps).rsqrt_().mul_(g)
                nf = {"r": r, "c": c}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp(v, min=eps))
                nf = {"v": v}
            if mesh is not None and _split(spec):
                total = mesh.ordered_sum(torch.sum(torch.square(u)), "model")
                ms = total / (u.numel() * mesh.model_size)
            else:
                ms = torch.mean(torch.square(u))
            rms = torch.sqrt(ms + 1e-12)
            u = u.div_(torch.clamp(rms / clip_threshold, min=1.0))
            return u.add_(weight_decay * p).mul_(-lr_t), nf

        g_s, p_s = _stacked(grads, stacks), _stacked(params, stacks)
        out = {n: leaf(g_s[n], state["f"][n], p_s[n], specs.get(n, ())) for n in g_s}
        upd = {}
        for n, (u, _) in out.items():
            upd.update(zip(stacks[n], u.unbind(0)) if n in stacks else [(n, u)])
        return {n: upd[n] for n in grads}, {"f": {n: nf for n, (_, nf) in out.items()},
                                            "step": step}

    return Optimizer(init, update)


def make_optimizer(name: str, lr=1e-3, *, stacks: dict | None = None, **kw) -> Optimizer:
    """The optimizer ``name`` at learning rate (or schedule) ``lr``.
    ``stacks`` (see :func:`adafactor`) matters to adafactor only: sgdm and
    adamw couple no elements of a leaf."""
    if name == "sgdm":
        return sgdm(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, stacks=stacks, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
