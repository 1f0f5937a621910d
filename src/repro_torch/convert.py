"""Carry parameters and optimizer states of the JAX package's models across
to the port, and back.

The port keeps the JAX layouts (NHWC, HWIO, (d_in, d_out)) and pytree
names, so carrying weights across is a copy: no transpose, no reorder.
An LM's layer-stacked leaves (an encoder-decoder's ``enc_layers`` and
``dec_layers``) are unstacked into one module per layer, and stacked
again on the way back.  Optimizer states follow their parameters:
sgdm's ``mu`` and adamw's ``m``/``v`` are trees of the parameters' shape;
adafactor's factors are keyed by JAX leaf name in the port
(``optim.adafactor``), so they carry across by name.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.paper_models import VisionConfig
from repro_torch.device import resolve_device
from repro_torch.models.encdec import EncDec, encdec_param_shapes
from repro_torch.models.transformer import LM, lm_param_shapes
from repro_torch.models.vision import VisionModel, init_tree


def _to_tensors(tree):
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _shapes(tree, prefix=""):
    """{dotted name: shape} of every leaf of a nested dict/list tree."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for key, sub in items:
            out.update(_shapes(sub, f"{prefix}{key}."))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


def _check_shapes(got: dict, want: dict, name: str):
    if got != want:
        raise ValueError(f"parameter tree does not fit {name}: "
                         f"missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}, shapes differ at "
                         f"{sorted(k for k in set(got) & set(want) if got[k] != want[k])}")


def vision_params_from_jax(tree: dict, cfg: VisionConfig, device=None) -> VisionModel:
    """The port's model holding the parameters of a JAX ``init_vision``
    pytree (numpy or JAX array leaves), on ``device`` (default: the card).

    Covers ``{"dense"}``, ``{"convs", "dense"}`` and ``{"stem", "stages",
    "head"}``; raises if the tree's names or shapes are not those ``cfg``
    gives.
    """
    device = resolve_device(device)
    tensors = _to_tensors(tree)
    want = _shapes(init_tree(cfg, torch.Generator().manual_seed(0)))
    _check_shapes(_shapes(tensors), want, cfg.name)
    return VisionModel(cfg, tensors).to(device)


def lm_params_from_jax(tree: dict, cfg: ArchConfig, device=None, mesh=None) -> LM:
    """The port's LM holding the parameters of a JAX ``init_lm`` pytree of
    the dense, MoE, SSM or hybrid family (numpy or JAX array leaves, layers
    stacked on a leading axis; the q/k/v biases ``b`` of a ``qkv_bias``
    config beside their ``w``; an MoE layer's router ``w`` (d, E) and expert
    banks (E, d, F) / (E, F, d); llama4's ``dense`` and ``moe_layer``
    subtrees stacked over its (dense, MoE) pairs; a Mamba2 layer's
    ``conv_w`` (K, ch); the hybrid's ``shared_attn``, one layer, unstacked),
    on ``device``
    (default: the card).  The tied head's
    ``emb.T`` is made contiguous here, once.  Raises if the tree's names or
    shapes are not those ``cfg`` gives.  With a ``mesh`` (``launch/mesh.py``)
    every parameter is then cut to this rank's block
    (``distributed.sharding.shard_model``)."""
    model = _model_from_jax(LM, lm_param_shapes, tree, cfg, device)
    if mesh is None:
        return model
    from repro_torch.distributed.sharding import lm_param_specs, shard_model
    return shard_model(model, lm_param_specs(lm_param_shapes(cfg), cfg, mesh), mesh)


def encdec_params_from_jax(tree: dict, cfg: ArchConfig, device=None) -> EncDec:
    """The port's encoder-decoder holding the parameters of a JAX
    ``init_encdec`` pytree (``enc_layers`` and ``dec_layers`` stacked on a
    leading axis), on ``device`` (default: the card).  Raises if the tree's
    names or shapes are not those ``cfg`` gives."""
    return _model_from_jax(EncDec, encdec_param_shapes, tree, cfg, device)


def _model_from_jax(cls, param_shapes, tree: dict, cfg: ArchConfig, device):
    device = resolve_device(device)
    flat = _lm_tree_to_flat(tree)
    _check_shapes({k: v.shape for k, v in flat.items()}, param_shapes(cfg), cfg.name)
    return cls(cfg, _nest({k: torch.from_numpy(v) for k, v in flat.items()})).to(device)


def _nest(flat: dict) -> dict:
    """A nested dict/list tree of a {dotted name: leaf} dict (a digit key
    is a list index; list items come in order)."""
    tree: dict = {}
    for name, leaf in flat.items():
        keys = [int(k) if k.isdigit() else k for k in name.split(".")]
        node = tree
        for key, nxt in zip(keys[:-1], keys[1:]):
            empty = [] if isinstance(nxt, int) else {}
            if isinstance(key, int):
                if key == len(node):
                    node.append(empty)
            else:
                node.setdefault(key, empty)
            node = node[key]
        node[keys[-1]] = leaf
    return tree


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def vision_params_to_numpy(model: VisionModel) -> dict:
    """The JAX-layout pytree (nested dicts and lists of numpy float32
    arrays) of a port model: the inverse of ``vision_params_from_jax``."""
    return _nest({name: _numpy(p) for name, p in model.named_parameters()})


def _stack(layers: list):
    if isinstance(layers[0], dict):
        return {k: _stack([lp[k] for lp in layers]) for k in layers[0]}
    return np.stack(layers)


def _dotted(tree, prefix="", stop=lambda node: False) -> dict:
    """{dotted name: leaf} of a nested dict tree; a node for which ``stop``
    holds counts as a leaf."""
    if isinstance(tree, dict) and not stop(tree):
        out = {}
        for k, v in tree.items():
            out.update(_dotted(v, f"{prefix}{k}.", stop))
        return out
    return {prefix[:-1]: tree}


# The subtrees whose leaves the JAX package stacks over layers.
_STACKED = ("layers", "enc_layers", "dec_layers")


def _lm_tree_to_flat(tree: dict) -> dict:
    """{port parameter name: numpy float32 copy} of a JAX layer-stacked LM
    or encoder-decoder tree, layers in order."""
    flat = _dotted({k: v for k, v in tree.items() if k not in _STACKED})
    for top in (k for k in _STACKED if k in tree):
        layers = _dotted(tree[top])
        for i in range(len(next(iter(layers.values())))):
            flat.update({f"{top}.{i}.{k}": v[i] for k, v in layers.items()})
    return {k: np.array(v, dtype=np.float32) for k, v in flat.items()}


def lm_tree_to_numpy(flat: dict) -> dict:
    """The JAX layer-stacked tree (numpy leaves) of a {port parameter name:
    tensor} dict: an LM's or an encoder-decoder's parameters, their
    gradients or a moment."""
    tree = _nest({name: _numpy(t) for name, t in flat.items()})
    for top in (k for k in _STACKED if k in tree):
        tree[top] = _stack(tree[top])
    return tree


def lm_params_to_numpy(model: LM, mesh=None) -> dict:
    """The JAX ``init_lm`` pytree (numpy float32 leaves, layers stacked) of
    a port LM: the inverse of ``lm_params_from_jax``.  With a ``mesh`` the
    model holds this rank's blocks, which every rank gathers
    (``distributed.sharding.gather_tensor``; a collective)."""
    params = dict(model.named_parameters())
    if mesh is not None:
        from repro_torch.distributed.sharding import gather_tensor
        params = {n: gather_tensor(p.detach(), getattr(p, "spec", ()), mesh)
                  for n, p in params.items()}
    return lm_tree_to_numpy(params)


def encdec_params_to_numpy(model: EncDec) -> dict:
    """The JAX ``init_encdec`` pytree (numpy float32 leaves, layers stacked)
    of a port encoder-decoder: the inverse of ``encdec_params_from_jax``."""
    return lm_tree_to_numpy(dict(model.named_parameters()))


def _is_factors(node) -> bool:
    return isinstance(node, dict) and set(node) in ({"r", "c"}, {"v"})


def lm_opt_state_from_jax(state: dict, device=None) -> dict:
    """The port's optimizer state (``optim.optimizers``: sgdm, adamw or
    adafactor) of a JAX one over an LM's or an encoder-decoder's
    layer-stacked parameters, on ``device`` (default: the card)."""
    device = resolve_device(device)
    to_t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)  # noqa: E731
    out = {"step": int(np.asarray(state["step"]))}
    for key in ("mu", "m", "v"):
        if key in state:
            out[key] = {k: to_t(v) for k, v in _lm_tree_to_flat(state[key]).items()}
    if "f" in state:
        out["f"] = {k: {n: to_t(a) for n, a in f.items()}
                    for k, f in _dotted(state["f"], stop=_is_factors).items()}
    return out


def lm_opt_state_to_numpy(state: dict) -> dict:
    """The JAX optimizer state (numpy leaves, layers stacked) of a port
    one: the inverse of ``lm_opt_state_from_jax``."""
    out = {"step": np.asarray(state["step"], dtype=np.int32)}
    for key in ("mu", "m", "v"):
        if key in state:
            out[key] = lm_tree_to_numpy(state[key])
    if "f" in state:
        out["f"] = _nest({k: {n: _numpy(t) for n, t in f.items()}
                          for k, f in state["f"].items()})
    return out
