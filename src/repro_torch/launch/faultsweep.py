"""LUT fault-injection campaign: the port of ``repro.launch.faultsweep``.

How hard can the multiplier's LUT hardware fault before training stops
converging?  Sweeps a :class:`core.faults.FaultCampaign` (one seeded
fault spec a point, typically a ladder of bit-flip rates), trains each
point with the trainer under the divergence supervisor (same seeded
weights, same batches, so the points differ only by the injected faults),
and prints a JSON report (``REPORT_SCHEMA``, the JAX package's) of loss
and accuracy against the fault rate.

Workloads: ``--arch`` takes the paper's vision models (``lenet-300-100``,
``lenet-5``, ``resnet-mini``: SGD-momentum on the learnable synthetic
dataset, then **test accuracy** under the same faulted datapath) or an LM
(adamw, final loss).

    python -m repro_torch.launch.faultsweep --arch resnet-mini --steps 5 \
        --mode amsim --multiplier afm16 --rates 0,1e-4,1e-3            # on the card
    python -m repro_torch.launch.faultsweep --arch lenet-300-100 --device cpu \
        --steps 5 --rates 0,1e-2,2e-1

Each point builds its train step once, and once more a ladder rung
(``traces`` in the report counts the builds, asserted ``1 +
ladder_level``), and copies each faulted table to the device once
(``uploads``; a clean point after a clean run copies none).
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.configs.paper_models import VISION_REGISTRY
from repro_torch.core import faults
from repro_torch.core.faults import FaultCampaign
from repro_torch.core.policy import NumericsPolicy
from repro_torch.data.pipeline import lm_batch, vision_batches, vision_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.transformer import init_lm, lm_loss, lm_stacks
from repro_torch.models.vision import init_vision, vision_forward, vision_loss
from repro_torch.optim.optimizers import cosine_schedule, make_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import (DivergenceError, StepFactory, Trainer, TrainerConfig,
                                      TrainerState)

REPORT_SCHEMA = 1


def vision_problem(cfg, *, batch: int, lr: float, seed: int, device, n_train: int = 512,
                   n_test: int = 256):
    """The train/eval substrate of a paper vision model: the learnable
    synthetic dataset, step-indexed batches (one shuffled epoch at a time,
    so a rollback replays the same batches), sgdm, and test accuracy."""
    data = vision_dataset(cfg.name, n_train, n_test, cfg.input_hw, cfg.input_ch, cfg.n_classes,
                          noise=0.3, seed=seed)
    per_epoch = n_train // batch
    epoch_cache: dict = {}

    def batch_fn(step):
        e, i = divmod(step, per_epoch)
        if e not in epoch_cache:
            epoch_cache.clear()
            epoch_cache[e] = list(vision_batches(data, batch, epoch=e))
        b = epoch_cache[e][i]
        return {"x": torch.from_numpy(b["x"]).to(device), "y": torch.from_numpy(b["y"]).to(device)}

    def evaluate(model, policy):
        with torch.no_grad():
            logits = vision_forward(model, torch.from_numpy(data["x_test"]).to(device), policy)
        acc = np.mean(np.argmax(logits.cpu().numpy(), -1) == data["y_test"])
        return {"test_acc": float(acc)}

    return {
        "init": lambda s: init_vision(cfg, generator=torch.Generator().manual_seed(s),
                                      device=device),
        "make_opt": lambda steps: make_optimizer("sgdm", lr),
        "loss": lambda pol: (lambda m, b: vision_loss(m, b, pol)),
        "batch_fn": batch_fn,
        "evaluate": evaluate,
    }


def lm_problem(cfg, *, batch: int, seq: int, lr: float, seed: int, device):
    """The train substrate of an LM: ``lm_batch`` data, adamw over a cosine
    schedule; no evaluation (the report gives the final loss)."""
    return {
        "init": lambda s: init_lm(cfg, generator=torch.Generator(device=device).manual_seed(s),
                                  device=device),
        "make_opt": lambda steps: make_optimizer(
            cfg.optimizer, cosine_schedule(lr, max(steps // 10, 1), steps), stacks=lm_stacks(cfg)),
        "loss": lambda pol: (lambda m, b: lm_loss(m, b, pol)),
        "batch_fn": lambda s: lm_batch(cfg, (batch, seq), s, device),
        "evaluate": None,
    }


def run_fault_point(problem, policy, spec, *, steps: int, seed: int = 0,
                    clip_norm: float = 1.0, ladder: bool = False, spike_factor: float = 0.0,
                    spike_warmup: int = 2, ckpt_every: int = 0, max_retries: int = 1,
                    log_fn=lambda s: None, step_wrapper=None) -> dict:
    """Train ``steps`` steps with ``spec``'s faults in every LUT and the
    divergence supervisor armed (and the degradation ladder, ``ladder``).

    Returns per-step losses, the evaluation under the same faulted
    datapath (test accuracy for a vision problem), the supervisor's trips,
    the ladder level reached, ``traces`` (train steps built: one per
    numerics used, ``1 + ladder_level``), ``uploads`` (tables copied to
    the device in this point) and the steps' wall times.
    ``step_wrapper(step) -> step`` wraps each step built."""
    opt = problem["make_opt"](steps)

    def make(pol):
        step = make_train_step(problem["loss"](pol), opt, clip_norm=clip_norm)
        return step if step_wrapper is None else step_wrapper(step)

    factory = StepFactory(make)
    uploads = sum(ops.lut_uploads.values())
    model = problem["init"](seed)
    with tempfile.TemporaryDirectory(prefix="faultsweep_") as ckpt_dir, faults.inject(spec):
        trainer = Trainer(
            factory(policy), problem["batch_fn"],
            TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                          ckpt_every=ckpt_every or max(steps // 5, 1), keep=3, log_every=1,
                          max_retries=max_retries, retry_window=max(steps // 2, 5),
                          spike_factor=spike_factor, spike_warmup=spike_warmup,
                          degrade_fn=factory.ladder(policy, log_fn) if ladder else None,
                          log_fn=log_fn))
        state = trainer.run(TrainerState(model, opt.init(dict(model.named_parameters()))))
        evals = (problem["evaluate"](state.model, factory.numerics[-1])
                 if problem["evaluate"] else {})
    losses = [m["loss"] for _, m in state.history]
    return {
        "losses": losses,
        "final_loss": losses[-1] if losses else None,
        **evals,
        "divergences": [(s, r, float(v)) for s, r, v in trainer.divergences],
        "ladder_level": trainer.ladder_level,
        "completed_steps": int(state.step),
        "traces": factory.builds,
        "uploads": sum(ops.lut_uploads.values()) - uploads,
        "step_ms": [t * 1e3 for t in trainer.step_times],
    }


def main(argv=None, step_wrapper=None):
    """Run the campaign of ``argv`` and return its report (also printed, and
    written to ``--out``); ``step_wrapper`` as in :func:`run_fault_point`."""
    ap = argparse.ArgumentParser(description="LUT fault-injection campaign "
                                             "(docs/robustness.md)")
    ap.add_argument("--arch", default="lenet-300-100",
                    help=f"vision model ({', '.join(VISION_REGISTRY)}) or LM arch name")
    ap.add_argument("--reduced", action="store_true", help="LM archs only: reduced config")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=32, help="LM archs only")
    ap.add_argument("--lr", type=float, default=0.05,
                    help="vision sgdm LR; LM runs want ~3e-4")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", default="amsim_torch",
                    help="mode the faulted LUTs run under (amsim: the CUDA kernels)")
    ap.add_argument("--multiplier", default="mitchell8")
    ap.add_argument("--model", default="bitflip", choices=["bitflip", "stuck0", "stuck1"],
                    help="fault model swept over --rates")
    ap.add_argument("--rates", default="0,1e-3,1e-2,1e-1",
                    help="comma-separated fault rates (0 = clean baseline)")
    ap.add_argument("--clip-norm", type=float, default=1.0,
                    help="gradient clip (0 disables: faults then reach the optimizer "
                         "unattenuated)")
    ap.add_argument("--ladder", action="store_true",
                    help="arm the degradation ladder (demote numerics on repeated rollback "
                         "instead of failing the point)")
    ap.add_argument("--spike-factor", type=float, default=0.0,
                    help="loss-spike threshold (k x running EMA; 0 = non-finite sentinel only)")
    ap.add_argument("--spike-warmup", type=int, default=2,
                    help="steps of EMA seeding before the spike detector may fire")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="rollback checkpoint cadence (0 = steps/5)")
    ap.add_argument("--max-retries", type=int, default=1,
                    help="rollbacks per ladder rung before demoting or failing")
    ap.add_argument("--out", metavar="PATH", default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.arch in VISION_REGISTRY:
        cfg = VISION_REGISTRY[args.arch]
        problem = vision_problem(cfg, batch=args.batch, lr=args.lr, seed=args.seed,
                                 device=device)
    else:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
        problem = lm_problem(cfg, batch=args.batch, seq=args.seq, lr=args.lr, seed=args.seed,
                             device=device)
    policy = NumericsPolicy(mode=args.mode, multiplier=args.multiplier)
    rates = [float(r) for r in args.rates.split(",") if r.strip()]
    campaign = FaultCampaign.from_rates(args.model, rates, seed=args.seed)
    common = dict(steps=args.steps, seed=args.seed, clip_norm=args.clip_norm,
                  ladder=args.ladder, spike_factor=args.spike_factor,
                  spike_warmup=args.spike_warmup, ckpt_every=args.ckpt_every,
                  max_retries=args.max_retries, step_wrapper=step_wrapper)
    report = {"schema": REPORT_SCHEMA, "arch": cfg.name, "reduced": bool(args.reduced),
              "mode": args.mode, "multiplier": args.multiplier, "model": args.model,
              "steps": args.steps, "batch": args.batch, "lr": args.lr, "seed": args.seed,
              "clip_norm": args.clip_norm, "ladder": args.ladder, "device": str(device),
              "points": []}

    for label, spec in campaign:
        print(f"[faultsweep] point {label} ({spec.describe() if spec else 'off'})")
        t0 = time.time()
        try:
            res = run_fault_point(problem, policy, spec,
                                  log_fn=lambda s: print(f"[faultsweep]   {s}"), **common)
        except DivergenceError as e:  # a point that diverged for good is a data point
            print(f"[faultsweep]   point diverged: {e!r}")
            report["points"].append({
                "label": label, "rate": spec.rate if spec else 0.0,
                "spec": spec.to_json() if spec else None, "error": repr(e),
                "final_loss": None, "seconds": round(time.time() - t0, 2)})
            continue
        expect = 1 + res["ladder_level"]
        if res["traces"] != expect:
            raise AssertionError(f"point {label}: {res['traces']} train steps built, expected "
                                 f"{expect} (1 + ladder rungs)")
        entry = {"label": label, "rate": spec.rate if spec else 0.0,
                 "spec": spec.to_json() if spec else None, **res,
                 "seconds": round(time.time() - t0, 2)}
        report["points"].append(entry)
        stats = [f"final loss {entry['final_loss']:.4f}" if entry["final_loss"] is not None
                 else "no steps"]
        if "test_acc" in entry:
            stats.append(f"test acc {entry['test_acc']:.3f}")
        print(f"[faultsweep]   {', '.join(stats)}, {len(res['divergences'])} supervisor trips, "
              f"ladder level {res['ladder_level']}, {res['uploads']} tables uploaded "
              f"({entry['seconds']:.1f} s)")

    base = next((p for p in report["points"] if p["rate"] == 0.0), None)
    if base and base.get("final_loss") is not None:
        for p in report["points"]:
            if p.get("final_loss") is not None:
                p["final_vs_clean"] = p["final_loss"] - base["final_loss"]
            if "test_acc" in p and "test_acc" in base:
                p["acc_vs_clean"] = p["test_acc"] - base["test_acc"]

    print(json.dumps(report, sort_keys=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"[faultsweep] wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
