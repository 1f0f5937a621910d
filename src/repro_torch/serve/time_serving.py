"""Time batched greedy serving on the card: the runs of ``chip_smoke.py``
phases 5c and 5d.

    python src/repro_torch/serve/time_serving.py [--src DIR] [--tag NAME] [--reps N]

Needs an NVIDIA GPU and nvcc.  ``--src`` imports ``repro_torch`` from
another checkout's ``src`` (its kernels built there), so that two trees
are timed by one script in one call on one card: run it for each tree in
turns (A, B, B, A).  granite-3-2b (40 layers, a ring of 96) and
granite-moe-3b-a800m (32 layers) at full width, random weights and
prompts from seed 0, batch 4, prompt 64, 32 new tokens, through
``ServingEngine`` under ``amsim:afm16`` and ``native``.  For each, after
a warm-up: the prefill ms and the ms a decode step of ``generate`` on the
host clock (its ``timings``, as phases 5c and 5d print them), the median
of ``--reps`` runs; and by CUDA events around 3 calls each, the ms of a
prefill and of a decode step.  Prints one line a model and numerics, then
one JSON object {"tag", "device", "ms": {name: ms}}.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ARCHS = ("granite-3-2b", "granite-moe-3b-a800m")
BATCH, PROMPT, NEW = 4, 64, 32


def events_ms(fn, reps: int = 3) -> float:
    """Mean ms of ``fn()`` by CUDA events around ``reps`` calls (host time
    included where the host holds the card back)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--tag", default="", help="a name for this tree in the output")
    ap.add_argument("--reps", type=int, default=3, help="timed generate runs a case")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_serving: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_arch
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.models.transformer import init_lm, init_lm_caches
    from repro_torch.serve.engine import ServingEngine

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    ring = PROMPT + NEW
    ms = {}
    for arch in ARCHS:
        cfg = get_arch(arch)
        model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                                generator=torch.Generator().manual_seed(0)).to(dev)
        for pname, policy in (("amsim", NumericsPolicy(mode="amsim", multiplier="afm16")),
                              ("native", NumericsPolicy())):
            engine = ServingEngine(model, policy, max_len=ring)
            engine.generate(prompts, 2)          # warm-up: LUT upload, library handles
            pre, step = [], []
            for _ in range(args.reps):
                timings = {}
                engine.generate(prompts, NEW, timings=timings)
                pre.append(timings["prefill_s"] * 1e3)
                step.append(timings["decode_s"] * 1e3 / timings["decode_steps"])
            _, nxt, caches = engine.prefill(prompts, init_lm_caches(cfg, BATCH, ring, dev))
            ev_step = events_ms(lambda: engine.step(nxt, caches))
            ev_pre = events_ms(lambda: engine.prefill(prompts,
                                                      init_lm_caches(cfg, BATCH, ring, dev)))
            key = f"{arch} {pname}"
            ms.update({f"{key} prefill": statistics.median(pre),
                       f"{key} step": statistics.median(step),
                       f"{key} prefill events": ev_pre, f"{key} step events": ev_step})
            print(f"{args.tag} {key}: prefill {ms[key + ' prefill']:.2f} ms, "
                  f"{ms[key + ' step']:.3f} ms a decode step (host clock, median of "
                  f"{args.reps}: prefill {[round(t, 2) for t in pre]}, step "
                  f"{[round(t, 3) for t in step]}); by CUDA events prefill {ev_pre:.2f} ms, "
                  f"step {ev_step:.3f} ms", flush=True)
            del engine, caches
        del model
        torch.cuda.empty_cache()
    print(json.dumps({"tag": args.tag, "device": smi, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
