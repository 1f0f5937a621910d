"""Fig. 10 + Table III: training convergence and test accuracy per multiplier.

The twin of ``benchmarks/bench_convergence.py`` and
``examples/train_lenet_approx.py``: trains one of the paper's models on
the synthetic learnable image data under four multipliers (Table II) --
FP32 (native), bfloat16 and AFM16 (the LUT path, ``--mode``), and AFM32
(``direct`` bit arithmetic: LUTs cap at M=12) -- all from the same
initial parameters, with SGD-momentum (lr 0.05) and global-norm clipping
at 1.0.  Prints each multiplier's per-epoch train accuracy and test
accuracy, then the Table III deltas AFM32 - FP32 and AFM16 - bfloat16.

Run on the card:

    PYTHONPATH=src python -m repro_torch.train.convergence --model lenet-5 --mode amsim

``--mode amsim`` runs every forward, dx and dw product of the 16-bit
multipliers through the CUDA kernels; ``amsim_torch`` through their plain
versions.  ``--device cpu`` runs on the CPU (plain versions).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.paper_models import VISION_REGISTRY, VisionConfig
from repro_torch.core.policy import NumericsPolicy
from repro_torch.data.pipeline import vision_batches, vision_dataset
from repro_torch.device import resolve_device
from repro_torch.models.vision import init_vision, vision_forward, vision_loss
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.step import make_train_step


def build_policies(mode: str) -> dict[str, NumericsPolicy]:
    """The four multipliers of Table III; ``mode`` lowers the 16-bit ones."""
    return {
        "fp32": NumericsPolicy(),
        "bf16": NumericsPolicy(mode=mode, multiplier="bf16"),
        "afm32": NumericsPolicy(mode="direct", multiplier="afm32"),
        "afm16": NumericsPolicy(mode=mode, multiplier="afm16"),
    }


def train_one(cfg: VisionConfig, policy: NumericsPolicy, data: dict, *, epochs: int,
              batch: int = 64, lr: float = 0.05, seed: int = 0, device=None):
    """Train ``cfg`` from the parameters seed ``seed`` gives under ``policy``.

    Returns (per-epoch mean train accuracy, test accuracy, the trained
    model, the loss of every step).
    """
    device = resolve_device(device)
    model = init_vision(cfg, generator=torch.Generator().manual_seed(seed), device=device)
    opt = make_optimizer("sgdm", lr)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(lambda m, b: vision_loss(m, b, policy), opt)
    curve, losses = [], []
    for epoch in range(epochs):
        accs = []
        for b in vision_batches(data, batch, epoch):
            b = {"x": torch.from_numpy(b["x"]).to(device),
                 "y": torch.from_numpy(b["y"]).to(device)}
            state, metrics = step(model, state, b)
            accs.append(metrics["acc"])
            losses.append(metrics["loss"])
        curve.append(float(torch.stack(accs).mean()))
    logits = vision_forward(model, torch.from_numpy(data["x_test"]).to(device), policy)
    test_acc = float(np.mean(logits.argmax(-1).cpu().numpy() == data["y_test"]))
    return curve, test_acc, model, [float(v) for v in losses]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="lenet-300-100", choices=sorted(VISION_REGISTRY))
    ap.add_argument("--mode", default="amsim", choices=["amsim", "amsim_torch"],
                    help="lowering of the 16-bit multipliers (amsim = the CUDA kernels)")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = VISION_REGISTRY[args.model]
    data = vision_dataset(args.model, args.n_train, 512, cfg.input_hw, cfg.input_ch,
                          cfg.n_classes)
    device = resolve_device(args.device)
    print(f"{args.model}: {args.epochs} epochs x {args.n_train} samples (mode={args.mode}, "
          f"device={device})")
    results = {}
    for name, pol in build_policies(args.mode).items():
        curve, acc, _, _ = train_one(cfg, pol, data, epochs=args.epochs, device=device)
        results[name] = acc
        print(f"  {name:6s} train-acc curve: " + " ".join(f"{c:.3f}" for c in curve)
              + f"  | test acc {acc:.4f}")
    print("\nTable III-style deltas:")
    print(f"  AFM32 - FP32    : {results['afm32'] - results['fp32']:+.4f}")
    print(f"  AFM16 - bfloat16: {results['afm16'] - results['bf16']:+.4f}")
    return results


if __name__ == "__main__":
    main()
