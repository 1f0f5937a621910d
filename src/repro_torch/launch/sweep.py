"""Multiplier-assignment sweep: the port of ``repro.launch.sweep``.

Which layers and passes can take which approximate multiplier before
training degrades?  Takes a grid of per-site assignments (``--point``
specs, a ``--grid-json`` file, or ``--cross-sites x --cross-multipliers``),
trains each point for N steps with the trainer (adamw over a cosine
schedule, the step-indexed ``lm_batch`` data, one seeded init), and prints
a JSON report (``REPORT_SCHEMA``, the JAX package's) of the per-step
losses against the fp32 baseline, with each point's ms a step and peak
memory.

    python -m repro_torch.launch.sweep --arch granite-3-2b --steps 3 --batch 4 --seq 64 \
        --point "qkv=mitchell8,attn_score=bf16,dw=native,default=afm16" \
        --point "default=fp16xbf16"                           # on the card
    python -m repro_torch.launch.sweep --reduced --device cpu --steps 2 --batch 2 \
        --seq 16 --cross-sites qkv,wd --cross-multipliers mitchell8,bf16

Assignment grammar (``core.policy.table_from_assignments``): keys are
sites, families, passes or ``default``; values ``native``, a multiplier
(mode ``amsim``: the CUDA kernels, their plain versions on the CPU) or
``mode:multiplier``.

The JAX sweep asserts one trace a point.  Here a point asserts one train
step built (``traces`` in the report counts the builds, the same key as
the JAX report's) and counts the tables it copied to the device
(``uploads``): each (multiplier, layout) once, the first time any point
reads it.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time

import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.policy import NumericsPolicy, PolicyTable, table_from_assignments
from repro_torch.data.pipeline import lm_batch
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.transformer import init_lm, lm_loss, lm_stacks
from repro_torch.optim.optimizers import cosine_schedule, make_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import StepFactory, Trainer, TrainerConfig, TrainerState

REPORT_SCHEMA = 1


def run_point(cfg, policy, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
              seed: int = 0, device=None, log_fn=lambda s: None, step_wrapper=None) -> dict:
    """Train ``steps`` adamw steps of a model drawn from ``seed`` under
    ``policy`` and return {losses, traces (train steps built), uploads
    (tables copied to the device), step_ms (each step's wall time),
    peak_bytes (the card's peak allocation; None on the CPU)}.

    Every point starts from the same weights and reads the same batches,
    so the curves differ only by numerics.  ``step_wrapper(step) -> step``
    wraps each step built (a counter or a profiler)."""
    device = resolve_device(device)
    opt = make_optimizer(cfg.optimizer, cosine_schedule(lr, max(steps // 10, 1), steps),
                         stacks=lm_stacks(cfg))

    def make(pol):
        step = make_train_step(lambda model, b: lm_loss(model, b, pol), opt)
        return step if step_wrapper is None else step_wrapper(step)

    factory = StepFactory(make)
    uploads = sum(ops.lut_uploads.values())
    gc.collect()         # an earlier point's model held in a reference cycle would count here
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = init_lm(cfg, generator=torch.Generator(device=device).manual_seed(seed),
                    device=device)
    trainer = Trainer(factory(policy), lambda s: lm_batch(cfg, (batch, seq), s, device),
                      TrainerConfig(total_steps=steps, ckpt_dir=None, log_every=1,
                                    log_fn=log_fn))
    state = trainer.run(TrainerState(model, opt.init(dict(model.named_parameters()))))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"losses": [m["loss"] for _, m in state.history], "traces": factory.builds,
            "uploads": sum(ops.lut_uploads.values()) - uploads,
            "step_ms": [t * 1e3 for t in trainer.step_times], "peak_bytes": peak}


def _expand_grid(args) -> list[tuple[str, PolicyTable]]:
    """(label, table) of each grid point from the three input forms."""
    points: list[tuple[str, PolicyTable]] = []
    for spec in args.point or []:
        points.append((spec, table_from_assignments(spec)))
    if args.cross_sites and args.cross_multipliers:
        sites = [s.strip() for s in args.cross_sites.split(",") if s.strip()]
        mults = [m.strip() for m in args.cross_multipliers.split(",") if m.strip()]
        for site in sites:
            for mult in mults:
                spec = f"{site}={mult},default={args.cross_default}"
                points.append((spec, table_from_assignments(spec)))
    elif bool(args.cross_sites) != bool(args.cross_multipliers):
        raise SystemExit("--cross-sites and --cross-multipliers go together")
    if args.grid_json:
        with open(args.grid_json) as f:
            grid = json.load(f)
        for spec in grid.get("points", []):
            points.append((spec, table_from_assignments(spec)))
    if not points:
        raise SystemExit("no grid points: pass --point / --cross-sites + "
                         "--cross-multipliers / --grid-json")
    return points


def _entry(res: dict, t0: float) -> dict:
    ms = res["step_ms"]
    return {**res, "final_loss": res["losses"][-1], "seconds": round(time.time() - t0, 2),
            "ms_per_step": ms[-1] if ms else None}


def main(argv=None, step_wrapper=None):
    """Run the sweep of ``argv`` and return its report (also printed, and
    written to ``--out``); ``step_wrapper`` as in :func:`run_point`."""
    ap = argparse.ArgumentParser(description="per-site multiplier-assignment sweep "
                                             "(docs/policies.md)")
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-test widths of configs.base.reduced")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers (widths stay)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--point", action="append", metavar="SPEC",
                    help="assignment spec, e.g. 'qkv=mitchell8,dw=native,default=afm16' "
                         "(repeatable)")
    ap.add_argument("--cross-sites", metavar="S1,S2",
                    help="cross product: one point per (site, multiplier)")
    ap.add_argument("--cross-multipliers", metavar="M1,M2")
    ap.add_argument("--cross-default", default="native",
                    help="default target for cross-product points")
    ap.add_argument("--grid-json", metavar="PATH", default=None,
                    help='grid file: {"points": ["<assignment spec>", ...]}')
    ap.add_argument("--no-baseline", action="store_true", help="skip the fp32 baseline run")
    ap.add_argument("--out", metavar="PATH", default=None,
                    help="write the comparison report JSON here")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    points = _expand_grid(args)
    device = resolve_device(args.device)
    common = dict(steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, seed=args.seed)
    report = {"schema": REPORT_SCHEMA, "arch": cfg.name, "reduced": bool(args.reduced),
              "n_layers": cfg.n_layers, "device": str(device), **common, "points": []}

    def run(policy, log_fn=lambda s: None):
        t0 = time.time()
        res = run_point(cfg, policy, device=device, log_fn=log_fn, step_wrapper=step_wrapper,
                        **common)
        if res["traces"] != 1:
            raise AssertionError(f"{res['traces']} train steps built for one point")
        return _entry(res, t0)

    baseline_final = None
    if not args.no_baseline:
        print(f"[sweep] baseline: native/fp32, {args.steps} steps")
        entry = run(NumericsPolicy())
        baseline_final = entry["final_loss"]
        report["baseline"] = {"assign": "default=native", **entry}
        print(f"[sweep]   final loss {baseline_final:.4f} ({entry['seconds']:.1f} s)")

    for spec, table in points:
        print(f"[sweep] point: {spec}")
        for line in table.describe():
            print(f"[sweep]   {line}")
        entry = {"assign": spec, "rules": table.describe(),
                 **run(table, log_fn=lambda s: print(f"[sweep]   {s}"))}
        if baseline_final is not None:
            entry["final_vs_baseline"] = entry["final_loss"] - baseline_final
            entry["rel_final"] = entry["final_loss"] / baseline_final if baseline_final else None
        report["points"].append(entry)
        tail = (f" (baseline {baseline_final:.4f}, delta {entry['final_vs_baseline']:+.4f})"
                if baseline_final is not None else "")
        peak = (f", peak {entry['peak_bytes'] / 1e9:.2f} GB" if entry["peak_bytes"] is not None
                else "")
        print(f"[sweep]   final loss {entry['final_loss']:.4f}{tail}; "
              f"{entry['ms_per_step']:.1f} ms the last step{peak}, {entry['uploads']} tables "
              f"uploaded")

    print(json.dumps(report, sort_keys=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"[sweep] wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
