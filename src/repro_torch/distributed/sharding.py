"""Sharding rules: parameter, optimizer-state, batch and cache specs, and
the cut and gather of tensors by them.  The port of
``repro.distributed.sharding``.

A spec is a plain tuple with one entry per dimension: None (replicated),
an axis name, or a tuple of axis names (the data axes of a multi-pod
mesh).  The rules are the JAX package's, matched on the JAX pytree's
"/"-path of each tensor: Megatron tensor parallelism over "model"
(column-parallel wq/wk/wv/wg/wu and the head: output dim; row-parallel
wo/wd: input dim; the embedding: vocab; MoE experts: expert dim; Mamba
heads), and, under ``cfg.fsdp``, the other matrix dim over "data" ("F").
A dim whose axis does not divide it hands the axis to another dim that it
divides (``_fix_divisibility``): granite-3-2b's vocab of 49155 shards its
embedding over d instead.

The port keeps an LM's layers unstacked (``layers.3.attn.wq.w``), where
the JAX package stacks them on a leading axis (``layers/attn/wq/w`` of
(L, d, n)).  The rules run on the stacked shape, exactly as there, and a
layer's spec is the stacked spec without its leading entry.  Placing a
tensor (``shard_model``) takes this rank's block of each dim;
``gather_tensor`` puts the full tensor back together.  FSDP ("data" on a
parameter dim) and a stack sharded over its layers are not placed: they
raise ``NotImplementedError``.
"""
from __future__ import annotations

import re

import torch

from repro_torch.configs.base import ArchConfig

# (regex on the "/"-joined path) -> (the spec of the last dims); "F" is the
# FSDP axis ("data" under cfg.fsdp, else None).  The JAX package's rules.
_RULES = [
    (r"experts/w[gu]/w$", ("model", "F", None)),   # (E, d, f): EP + fsdp(d)
    (r"experts/wd/w$", ("model", None, "F")),      # (E, f, d)
    (r"router/w$", (None, None)),                  # replicate router
    (r"(wq|wk|wv|wg|wu)/w$", ("F", "model")),      # column-parallel
    (r"(wo|wd)/w$", ("model", "F")),               # row-parallel
    (r"in_proj/w$", ("F", "model")),
    (r"out_proj/w$", ("model", "F")),
    (r"(wq|wk|wv|wg|wu|in_proj)/b$", ("model",)),
    (r"(wo|wd|out_proj)/b$", (None,)),
    (r"embed/emb$", ("model", "F")),               # vocab-parallel embedding
    (r"head/w$", ("F", "model")),
    (r"head/b$", ("model",)),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"(A_log|D|dt_bias)$", ("model",)),
    (r"(norm|n1|n2|n3|final_norm|enc_norm)/(g|b)$", (None,)),
]


def data_axes(mesh):
    """Every non-"model" axis: a name, or a tuple of names when there are
    several (the entry a spec takes)."""
    axes = tuple(a for a in mesh.axis_names if a != "model")
    return axes if len(axes) > 1 else axes[0]


def batch_spec(mesh) -> tuple:
    return (data_axes(mesh),)


def _axis_size(mesh, a) -> int:
    if a is None:
        return 1
    n = 1
    for x in (a if isinstance(a, tuple) else (a,)):
        n *= mesh.shape[x]
    return n


def _fix_divisibility(entries, shape, mesh) -> tuple:
    """Drop or move the axes whose size does not divide their dim: the
    axis goes to the last unassigned dim it divides, if any."""
    entries = list(entries)
    for i, a in enumerate(entries):
        if a is None or shape[i] % _axis_size(mesh, a) == 0:
            continue
        entries[i] = None
        for j in range(len(entries) - 1, -1, -1):
            if j != i and entries[j] is None and shape[j] % _axis_size(mesh, a) == 0:
                entries[j] = a
                break
    return tuple(entries)


def _spec(path: str, shape, fsdp: bool, mesh) -> tuple:
    for pat, tail in _RULES:
        if re.search(pat, path):
            tail = tuple(("data" if fsdp else None) if t == "F" else t for t in tail)
            entries = (None,) * (len(shape) - len(tail)) + tail
            return entries if mesh is None else _fix_divisibility(entries, shape, mesh)
    return ()


def _stacks_of(cfg: ArchConfig) -> dict:
    if cfg.family == "encdec":
        from repro_torch.models.encdec import encdec_stacks
        return encdec_stacks(cfg)
    from repro_torch.models.transformer import lm_stacks
    return lm_stacks(cfg)


def lm_param_specs(shapes: dict, cfg: ArchConfig, mesh=None, *, stacked: bool = False) -> dict:
    """The spec of every tensor of ``shapes`` ({port name: shape}, as
    ``lm_param_shapes`` / ``encdec_param_shapes`` give it).  With
    ``stacked`` the specs of the JAX package's leaves instead, keyed by
    the dotted JAX name (``layers.attn.wq.w`` for the stack of every
    layer's ``layers.<i>.attn.wq.w``), equal to ``lm_param_pspecs``."""
    stacks = _stacks_of(cfg)
    out, members = {}, set()
    for jname, names in stacks.items():
        shape = (len(names), *shapes[names[0]])
        spec = _spec(jname.replace(".", "/"), shape, cfg.fsdp, mesh)
        members.update(names)
        if stacked:
            out[jname] = spec
        else:
            # a stack sharded over its layers keeps a "layers" mark, which
            # placing refuses
            member = () if not spec else (
                spec[1:] if spec[0] is None else ("layers", *spec[1:]))
            out.update({n: member for n in names})
    for name, shape in shapes.items():
        if name not in members:
            out[name] = _spec(name.replace(".", "/"), tuple(shape), cfg.fsdp, mesh)
    return out


def opt_state_specs(opt_name: str, param_specs: dict) -> dict:
    """The optimizer state's specs, mirroring ``Optimizer.init``: adamw's
    m and v and sgdm's mu take their parameters' specs (keyed by port
    name); adafactor's factors are keyed by JAX leaf name, so it takes the
    stacked specs, and a factor drops the spec entry of the dim it
    reduces."""
    if opt_name == "adamw":
        return {"m": dict(param_specs), "v": dict(param_specs), "step": ()}
    if opt_name == "sgdm":
        return {"mu": dict(param_specs), "step": ()}
    if opt_name == "adafactor":
        def leaf(spec):
            if len(spec) >= 2:
                return {"r": spec[:-1], "c": spec[:-2] + spec[-1:]}
            return {"v": spec}
        return {"f": {n: leaf(s) for n, s in param_specs.items()}, "step": ()}
    raise ValueError(opt_name)


def cache_specs(caches, mesh, batch: int):
    """The decode caches' specs, in the caches' own structure (a list is a
    stack of layers, whose spec comes from the stacked shape as in JAX).
    Ring ``k``/``v`` (B, T, KV, dh): KV heads over "model", batch over the
    data axes when they divide it, else the sequence (SP); paged pools
    KV heads over "model", pages not sharded; Mamba2 ``ssm`` heads and
    ``conv`` channels over "model"; every other entry replicated."""
    daxes = data_axes(mesh)
    dsize = _axis_size(mesh, daxes)
    sharded = batch % dsize == 0 and batch >= dsize

    def spec(path: str, shape) -> tuple:
        lead = len(shape)
        if re.search(r"pool_(k|v)$", path) and lead >= 4:
            tail = (None, None, "model", None)
        elif re.search(r"(^|/)(k|v)$", path) and lead >= 4:
            tail = (daxes, None, "model", None) if sharded else (None, daxes, "model", None)
        elif re.search(r"ssm$", path) and lead >= 4:
            tail = (daxes if sharded else None, "model", None, None)
        elif re.search(r"conv$", path) and lead >= 3:
            tail = (daxes if sharded else None, None, "model")
        else:
            return ()
        return _fix_divisibility((None,) * (lead - len(tail)) + tail, shape, mesh)

    def walk(node, path, stack):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k, stack) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(v, f"{path}/{i}" if path else str(i), stack)
                         for i, v in enumerate(node))
        if isinstance(node, list):
            return [walk(v, path, len(node)) for v in node]
        if not isinstance(node, torch.Tensor):
            return ()
        shape = tuple(node.shape) if stack is None else (stack, *node.shape)
        s = spec(path, shape)
        return s if stack is None or not s else s[1:]

    return walk(caches, "", None)


# ----------------------------------------------------------- cut and gather
def _entries(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def shard_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (a view)."""
    for dim, axes in enumerate(_entries(spec, t.ndim)):
        if axes is not None:
            t = mesh.block(t, axes, dim)
    return t


def gather_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's block under ``spec``:
    an all-gather along each sharded dim."""
    for dim, axes in enumerate(_entries(spec, t.ndim)):
        if axes is not None:
            t = mesh.all_gather(t, axes, dim=dim)
    return t


def _map2(fn, tree, specs):
    """``fn(tensor, spec)`` over the tensors of ``tree``; ``specs`` has the
    tree's structure with a spec where the tree has a tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, s) for v, s in zip(tree, specs))
    return tree


def shard_tree(tree, specs, mesh):
    """``shard_tensor`` over a tree (nested dicts, lists and tuples) and
    its tree of specs; each block a copy of its own."""
    return _map2(lambda t, s: shard_tensor(t, s, mesh).clone(), tree, specs)


def gather_tree(tree, specs, mesh):
    """``gather_tensor`` over a tree; ``gather_tree(shard_tree(t))`` is t."""
    return _map2(lambda t, s: gather_tensor(t, s, mesh), tree, specs)


def check_placeable(name: str, spec):
    """Raise unless the port can place a tensor of this spec: FSDP ("data"
    on a dim) and a stack sharded over its layers wait for a later slice."""
    for axes in spec:
        named = axes if isinstance(axes, tuple) else (axes,)
        if "layers" in named:
            raise NotImplementedError(f"{name}: a stack sharded over its layers is not placed "
                                      f"by the port")
        if any(a is not None and a != "model" for a in named):
            raise NotImplementedError(f"{name}: spec {spec} shards a parameter over the data "
                                      f"axes (FSDP, cfg.fsdp), a later slice of the port")


def shard_model(model: torch.nn.Module, specs: dict, mesh) -> torch.nn.Module:
    """Cut every parameter of ``model`` (full tensors) to this rank's block
    under ``specs`` ({parameter name: spec}), in place, and record each
    spec on its parameter (``param.spec``), which the sharded ops read."""
    for name, p in model.named_parameters():
        spec = tuple(specs.get(name, ()))
        check_placeable(name, spec)
        block = shard_tensor(p.data, spec, mesh)
        if block.shape != p.shape:
            p.data = block.contiguous().clone()
        p.spec = spec
    return model


def cut_part(prefix: str, part, specs: dict, mesh):
    """This rank's blocks of a freshly drawn part of a parameter tree
    (nested dicts and lists of full tensors under the dotted ``prefix``),
    each copied out so that the full tensor can go."""
    if isinstance(part, dict):
        return {k: cut_part(f"{prefix}.{k}", v, specs, mesh) for k, v in part.items()}
    if isinstance(part, list):
        return [cut_part(f"{prefix}.{i}", v, specs, mesh) for i, v in enumerate(part)]
    spec = tuple(specs.get(prefix, ()))
    check_placeable(prefix, spec)
    return shard_tensor(part, spec, mesh).clone()


def tag_specs(model: torch.nn.Module, specs: dict) -> torch.nn.Module:
    """Record each parameter's spec (``param.spec``) on a model whose
    parameters already are this rank's blocks."""
    for name, p in model.named_parameters():
        spec = tuple(specs.get(name, ()))
        check_placeable(name, spec)
        p.spec = spec
    return model
