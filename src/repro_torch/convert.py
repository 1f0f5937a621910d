"""Carry parameters of the JAX package's models across to the port, and back.

The port keeps the JAX layouts (NHWC, HWIO, (d_in, d_out)) and pytree
names, so carrying weights across is a copy: no transpose, no reorder.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.paper_models import VisionConfig
from repro_torch.device import resolve_device
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
    got = _shapes(tensors)
    if got != want:
        raise ValueError(f"parameter tree does not fit {cfg.name}: "
                         f"missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}, shapes differ at "
                         f"{sorted(k for k in set(got) & set(want) if got[k] != want[k])}")
    return VisionModel(cfg, tensors).to(device)


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
