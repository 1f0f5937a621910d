"""Carry parameters of the JAX package's models across to the port, and back.

The port keeps the JAX layouts (NHWC, HWIO, (d_in, d_out)) and pytree
names, so carrying weights across is a copy: no transpose, no reorder.
An LM's layer-stacked leaves are unstacked into one module per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.paper_models import VisionConfig
from repro_torch.device import resolve_device
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


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def lm_params_from_jax(tree: dict, cfg: ArchConfig, device=None) -> LM:
    """The port's LM holding the parameters of a JAX ``init_lm`` pytree of
    the dense or MoE family (numpy or JAX array leaves, layers stacked on a
    leading axis; an MoE layer's router ``w`` (d, E) and expert banks
    (E, d, F) / (E, F, d)), on ``device`` (default: the card).  The tied head's
    ``emb.T`` is made contiguous here, once.  Raises if the tree's names or
    shapes are not those ``cfg`` gives."""
    device = resolve_device(device)
    layers = tree["layers"]
    n_layers = len(next(iter(layers["n1"].values())))
    port = {k: v for k, v in tree.items() if k != "layers"}
    port["layers"] = [_unstack(layers, i) for i in range(n_layers)]
    tensors = _to_tensors(port)
    _check_shapes(_shapes(tensors), lm_param_shapes(cfg), cfg.name)
    return LM(cfg, tensors).to(device)


def vision_params_to_numpy(model: VisionModel) -> dict:
    """The JAX-layout pytree (nested dicts and lists of numpy float32
    arrays) of a port model: the inverse of ``vision_params_from_jax``."""
    tree: dict = {}
    for name, p in model.named_parameters():
        keys = [int(k) if k.isdigit() else k for k in name.split(".")]
        node = tree
        for key, nxt in zip(keys[:-1], keys[1:]):
            empty = [] if isinstance(nxt, int) else {}
            if isinstance(key, int):
                if key == len(node):  # list items come in order
                    node.append(empty)
            else:
                node.setdefault(key, empty)
            node = node[key]
        node[keys[-1]] = p.detach().cpu().numpy().copy()
    return tree
