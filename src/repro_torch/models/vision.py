"""The paper's own evaluation models (§VII): LeNet-300-100, LeNet-5, ResNet.

Every conv goes through ``ops.approx_conv2d`` (AMCONV2D) and every dense
layer through ``layers.linear`` (AMDENSE), so under ``mode="amsim"`` a
resnet-mini forward is 15 launches of the conv kernel and one of the GEMM
kernel, and a training step adds 14 conv-kernel launches for dx (the
stem's input needs none), 15 of the dw kernel and 2 GEMM launches.  Layouts are the JAX package's: activations NHWC, conv weights
HWIO, dense weights (d_in, d_out); the parameter names are its pytree's
(``dense``; ``convs``; ``stem``/``stages``/``head`` with blocks
``c1``/``c2``/``proj``), so ``convert.vision_params_from_jax`` is a copy.

Under an ambient mesh (``launch/mesh.py``) a model runs data-parallel:
each rank its batch rows, the convs through
``distributed/shard_fused.parallel_conv2d`` (the kernels per rank, dw
summed over the data axes in rank order), the dense layers through
``linear`` (``kind`` None: replicated weights, as JAX's) and every bias's
gradient summed the same way.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.paper_models import VisionConfig
from repro_torch.core.policy import NumericsPolicy
from repro_torch.device import resolve_device
from repro_torch.distributed.shard_fused import data_parallel, data_total, parallel_conv2d
from repro_torch.launch.mesh import current_mesh
from .layers import Linear, init_linear, linear


class Conv(nn.Module):
    """A conv layer's parameters: ``w`` (KH, KW, C, O) and ``b`` (O,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x, policy, stride=1, padding="SAME"):
        return parallel_conv2d(x, self.w, stride, padding, policy) + data_parallel(self.b)


class Block(nn.Module):
    """A residual block: c1 (stride s), c2, and a 1x1 ``proj`` shortcut
    where the channel count changes."""

    def __init__(self, c1: dict, c2: dict, proj: dict | None = None):
        super().__init__()
        self.c1 = Conv(**c1)
        self.c2 = Conv(**c2)
        self.proj = None if proj is None else Conv(**proj)


def _avgpool(x, k=2):
    """k x k mean pool with stride k over NHWC (VALID)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def _dense_stack(layers, h, policy):
    for i, lp in enumerate(layers):
        last = i == len(layers) - 1
        h = linear(lp, h, policy, site="head" if last else "dense")
        if not last:
            h = torch.relu(h)
    return h


class VisionModel(nn.Module):
    """One of the paper's vision models, built from a JAX-layout tree of
    tensors (``init_vision`` or ``convert.vision_params_from_jax``)."""

    def __init__(self, cfg: VisionConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        if cfg.kind in ("mlp", "cnn"):
            if cfg.kind == "cnn":
                self.convs = nn.ModuleList(Conv(**p) for p in tree["convs"])
            self.dense = nn.ModuleList(Linear(**p) for p in tree["dense"])
        elif cfg.kind == "resnet":
            self.stem = Conv(**tree["stem"])
            self.stages = nn.ModuleList(
                nn.ModuleList(Block(**blk) for blk in blocks) for blocks in tree["stages"])
            self.head = Linear(**tree["head"])
        else:
            raise ValueError(cfg.kind)

    def forward(self, x: torch.Tensor, policy: NumericsPolicy) -> torch.Tensor:
        """x (B, H, W, C) f32 in [0,1] -> logits (B, n_classes)."""
        kind = self.cfg.kind
        if kind == "mlp":
            return _dense_stack(self.dense, x.reshape(x.shape[0], -1), policy)
        if kind == "cnn":
            h = x
            for conv in self.convs:
                h = _avgpool(torch.relu(conv(h, policy)))
            return _dense_stack(self.dense, h.reshape(h.shape[0], -1), policy)
        h = torch.relu(self.stem(x, policy))
        for si, blocks in enumerate(self.stages):
            for bi, blk in enumerate(blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                r = torch.relu(blk.c1(h, policy, stride=stride))
                r = blk.c2(r, policy)
                sc = h
                if blk.proj is not None:
                    sc = blk.proj(h, policy, stride=stride)
                elif stride != 1:
                    sc = _avgpool(h, stride)
                h = torch.relu(r + sc)
        return linear(self.head, h.mean(dim=(1, 2)), policy, site="head")


def _init_conv(g, kh, kw, cin, cout):
    scale = (1.0 / (kh * kw * cin)) ** 0.5
    return {"w": torch.randn((kh, kw, cin, cout), generator=g) * scale,
            "b": torch.zeros((cout,))}


def init_tree(cfg: VisionConfig, generator: torch.Generator) -> dict:
    """JAX-layout parameters on the CPU, with the JAX package's scales."""
    g = generator
    if cfg.kind == "mlp":
        dims = [cfg.input_hw * cfg.input_hw * cfg.input_ch, *cfg.hidden, cfg.n_classes]
        return {"dense": [init_linear(i, o, generator=g, bias=True)
                          for i, o in zip(dims[:-1], dims[1:])]}
    if cfg.kind == "cnn":
        convs, cin = [], cfg.input_ch
        for ch in cfg.channels:
            convs.append(_init_conv(g, 5, 5, cin, ch))
            cin = ch
        hw = cfg.input_hw // (2 ** len(cfg.channels))
        dims = [hw * hw * cin, *cfg.hidden, cfg.n_classes]
        return {"convs": convs,
                "dense": [init_linear(i, o, generator=g, bias=True)
                          for i, o in zip(dims[:-1], dims[1:])]}
    if cfg.kind == "resnet":
        tree = {"stem": _init_conv(g, 3, 3, cfg.input_ch, cfg.channels[0])}
        stages, cin = [], cfg.channels[0]
        for ch in cfg.channels:
            blocks = []
            for _ in range(cfg.blocks_per_stage):
                blk = {"c1": _init_conv(g, 3, 3, cin, ch), "c2": _init_conv(g, 3, 3, ch, ch)}
                if cin != ch:
                    blk["proj"] = _init_conv(g, 1, 1, cin, ch)
                blocks.append(blk)
                cin = ch
            stages.append(blocks)
        tree["stages"] = stages
        tree["head"] = init_linear(cin, cfg.n_classes, generator=g, bias=True)
        return tree
    raise ValueError(cfg.kind)


def init_vision(cfg: VisionConfig, *, generator: torch.Generator | None = None,
                device=None) -> VisionModel:
    """Random parameters drawn from ``generator`` (default: seed 0) on the
    CPU, then moved to ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    return VisionModel(cfg, init_tree(cfg, generator)).to(device)


@torch.inference_mode()
def vision_forward(model: VisionModel, x: torch.Tensor,
                   policy: NumericsPolicy) -> torch.Tensor:
    """Inference: x (B, H, W, C) -> logits (B, n_classes)."""
    return model(x, policy)


def vision_loss(model: VisionModel, batch: dict, policy: NumericsPolicy):
    """Mean softmax cross-entropy of a batch {"x": (B,H,W,C), "y": (B,)}
    and {"acc": accuracy}; differentiable (the training entry point).
    Under a mesh with the batch split over the data axes, the means over
    every data rank's rows."""
    logits = model(batch["x"], policy)
    labels = batch["y"].to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[:, None])[:, 0]
    hit = (logits.argmax(-1) == labels).to(torch.float32)
    mesh = current_mesh()
    if mesh is not None and mesh.data_size > 1:
        n = labels.shape[0] * mesh.data_size
        return data_total(torch.sum(lse - ll)) / n, {"acc": data_total(torch.sum(hit)) / n}
    return torch.mean(lse - ll), {"acc": torch.mean(hit)}
