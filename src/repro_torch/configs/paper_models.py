"""The paper's own evaluation architectures (§VII): LeNets + ResNets.

A lightweight spec consumed by ``models/vision.py``; the same values as
``repro.configs.paper_models``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    name: str
    kind: str                   # mlp | cnn | resnet
    input_hw: int               # square input resolution
    input_ch: int
    n_classes: int
    hidden: tuple = ()          # mlp: dense widths
    channels: tuple = ()        # cnn/resnet: conv channels per stage
    blocks_per_stage: int = 2   # resnet


LENET_300_100 = VisionConfig(
    name="lenet-300-100", kind="mlp", input_hw=28, input_ch=1,
    n_classes=10, hidden=(300, 100))

LENET_5 = VisionConfig(
    name="lenet-5", kind="cnn", input_hw=28, input_ch=1,
    n_classes=10, channels=(6, 16), hidden=(120, 84))

RESNET_MINI = VisionConfig(  # CIFAR-scale ResNet (paper: ResNet-18/34/50)
    name="resnet-mini", kind="resnet", input_hw=32, input_ch=3,
    n_classes=10, channels=(16, 32, 64), blocks_per_stage=2)

VISION_REGISTRY = {c.name: c for c in [LENET_300_100, LENET_5, RESNET_MINI]}
