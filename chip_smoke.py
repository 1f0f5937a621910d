#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on an NVIDIA GPU: build, check, run, time.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

Phases; the first failure ends the run with a non-zero exit, nothing is
caught:
 1. require CUDA; print the card, its power limit and its SM clock;
 2. build every kernel from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a);
 3. hold each kernel against its plain PyTorch version on the card, at
    every shape the three paper models give it at batch 64, for packed and
    canonical LUTs of afm16 and mitchell8 and an M=10 table (read from
    global memory); every result must be bitwise equal;
 4. the main path: resnet-mini at full width (batch 64, 32x32x3 images
    from the port's ``vision_dataset``, random weights from a seed) under
    ``amsim``/afm16 for a few batches; the launch counters must read 15
    conv + 1 GEMM launches per forward and the logits must be finite and
    bitwise equal to ``amsim_torch`` on the card; then lenet-5 and
    lenet-300-100 the same way;
 5. per-forward times (CUDA events) of native, amsim and amsim_torch with
    the device's busy time (torch.profiler), and each kernel's device time
    at the main path's shapes beside its bound and its plain version's time.
The line before the last is a JSON object with one row per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0
BATCH = 64
N_BATCHES = 3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
LOOKUPS_PER_SM_PER_CLOCK = 32      # shared-memory gathers: one per bank
LUT_CASES = [("afm16", True), ("afm16", False), ("mitchell8", True),
             ("mitchell8", False), ("afm10", True), ("afm10", False)]
# Every GEMM of the three models at batch 64, plus a ragged one.
GEMM_SHAPES = [(64, 784, 120), (64, 120, 84), (64, 84, 10), (64, 784, 300),
               (64, 300, 100), (64, 100, 10), (64, 64, 10), (67, 130, 33)]
# Every distinct conv of resnet-mini and lenet-5 at batch 64:
# (x shape, w shape, stride), all SAME.
CONV_SHAPES = [
    ((64, 32, 32, 3), (3, 3, 3, 16), 1),     # resnet stem
    ((64, 32, 32, 16), (3, 3, 16, 16), 1),   # stage 1
    ((64, 32, 32, 16), (3, 3, 16, 32), 2),   # stage 2 c1, pads (0, 1)
    ((64, 32, 32, 16), (1, 1, 16, 32), 2),   # stage 2 proj
    ((64, 16, 16, 32), (3, 3, 32, 32), 1),   # stage 2
    ((64, 16, 16, 32), (3, 3, 32, 64), 2),   # stage 3 c1
    ((64, 16, 16, 32), (1, 1, 32, 64), 2),   # stage 3 proj
    ((64, 8, 8, 64), (3, 3, 64, 64), 1),     # stage 3
    ((64, 28, 28, 1), (5, 5, 1, 6), 1),      # lenet-5 conv 1
    ((64, 14, 14, 6), (5, 5, 6, 16), 1),     # lenet-5 conv 2
]


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, name_part: str | None, reps: int) -> float:
    """Mean device time (ms) per ``fn()`` of the kernels whose name holds
    ``name_part`` (every device activity when None), from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (name_part is None or name_part in e.name))
    return us / reps / 1e3


def require(cond: bool, what: str):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.paper_models import VISION_REGISTRY
    from repro_torch.core.lutgen import get_lut, get_packed_lut
    from repro_torch.core.multipliers import get_multiplier
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.data.pipeline import vision_batches, vision_dataset
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.approx_conv import (approx_conv2d_fused, approx_conv2d_plain,
                                                 conv_out_shape, conv_pads)
    from repro_torch.kernels.approx_gemm import approx_gemm, approx_gemm_plain
    from repro_torch.kernels.common import lut_bytes, lut_in_smem, lut_tensor
    from repro_torch.models.vision import init_vision, vision_forward

    dev = torch.device(DEVICE)
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    # ---------------------------------------------------------- 1. card
    name = torch.cuda.get_device_name(0)
    smi_line = smi("name,power.limit")
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"device: {name} (count {torch.cuda.device_count()}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi_line}; max SM clock {sm_mhz:.0f} MHz")
    lookups_per_s = torch.cuda.get_device_properties(0).multi_processor_count \
        * LOOKUPS_PER_SM_PER_CLOCK * sm_mhz * 1e6

    # ---------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (cached)'}")
    for lib, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib}: {line.strip()}")

    # ------------------------------------- 3. kernels vs plain on the card
    max_err = {"approx_gemm": 0.0, "approx_conv2d_fused": 0.0}
    for lut_name, packed in LUT_CASES:
        M = get_multiplier(lut_name).mantissa_bits
        lut = lut_tensor(get_packed_lut(lut_name) if packed else get_lut(lut_name), dev)
        where = "shared" if lut_in_smem(lut) else "global"
        for m, k, n in GEMM_SHAPES:
            a, b = randn(m, k), randn(k, n)
            out, ref = approx_gemm(a, b, lut, M), approx_gemm_plain(a, b, lut, M)
            err = (out - ref).abs().max().item()
            require(torch.equal(out, ref), f"approx_gemm {lut_name} packed={packed} "
                    f"({m},{k},{n}): max|d|={err}")
            max_err["approx_gemm"] = max(max_err["approx_gemm"], err)
        for xs, ws, stride in CONV_SHAPES:
            x, w = randn(*xs), randn(*ws)
            pads = conv_pads(xs[1], xs[2], ws[0], ws[1], stride, "SAME")
            out = approx_conv2d_fused(x, w, lut, M, stride=stride, padding="SAME")
            ref = approx_conv2d_plain(x, w, lut, M, stride, pads)
            err = (out - ref).abs().max().item()
            require(torch.equal(out, ref), f"approx_conv2d_fused {lut_name} packed={packed} "
                    f"{xs}x{ws}/s{stride}: max|d|={err}")
            max_err["approx_conv2d_fused"] = max(max_err["approx_conv2d_fused"], err)
        print(f"kernels == plain (bitwise): {lut_name} M={M} "
              f"{'packed' if packed else 'canonical'} LUT ({lut_bytes(lut)} B, {where} memory): "
              f"{len(GEMM_SHAPES)} GEMM + {len(CONV_SHAPES)} conv shapes")

    # ----------------------------------------------------- 4. main path
    amsim = NumericsPolicy(mode="amsim", multiplier="afm16")
    plain = NumericsPolicy(mode="amsim_torch", multiplier="afm16")
    native = NumericsPolicy()
    want = {"resnet-mini": (15, 1), "lenet-5": (2, 3), "lenet-300-100": (0, 3)}
    runs, main_launches = {}, {}
    for model_name, (n_conv, n_gemm) in want.items():
        cfg = VISION_REGISTRY[model_name]
        model = init_vision(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
        data = vision_dataset(cfg.name, BATCH * N_BATCHES, 0, cfg.input_hw, cfg.input_ch,
                              cfg.n_classes, seed=SEED)
        xs = [torch.from_numpy(bt["x"]).to(dev) for bt in vision_batches(data, BATCH, 0)]
        approx_conv2d_fused.launches = 0
        approx_gemm.launches = 0
        logits = [vision_forward(model, x, amsim) for x in xs]
        torch.cuda.synchronize()
        launches = (approx_conv2d_fused.launches, approx_gemm.launches)
        require(launches == (n_conv * len(xs), n_gemm * len(xs)),
                f"{model_name}: launches (conv, gemm) = {launches}, want "
                f"{(n_conv * len(xs), n_gemm * len(xs))}")
        if not main_launches:
            main_launches = {"approx_conv2d_fused": launches[0], "approx_gemm": launches[1]}
        for x, out in zip(xs, logits):
            require(out.shape == (BATCH, cfg.n_classes) and bool(torch.isfinite(out).all()),
                    f"{model_name}: logits {tuple(out.shape)} not finite")
            ref = vision_forward(model, x, plain)
            require(torch.equal(out, ref), f"{model_name}: amsim logits differ from amsim_torch "
                    f"by {(out - ref).abs().max().item()}")
        agree = torch.cat([(vision_forward(model, x, native).argmax(-1) == out.argmax(-1))
                           for x, out in zip(xs, logits)]).float().mean().item()
        print(f"{model_name}: {len(xs)} batches of {BATCH}, launches conv {launches[0]} gemm "
              f"{launches[1]}, logits finite and bitwise equal to amsim_torch; argmax agrees "
              f"with native on {agree:.3f} of images")
        runs[model_name] = (model, xs[0])

    # ------------------------------------------------------ 5. timings
    print(f"per-forward times at batch {BATCH} (CUDA events, after warm-up; device busy "
          f"from torch.profiler; {name}, {smi_line}):")
    for model_name, (model, x) in runs.items():
        t_nat = cuda_ms(lambda: vision_forward(model, x, native), reps=50, warmup=3)
        t_am = cuda_ms(lambda: vision_forward(model, x, amsim), reps=20, warmup=2)
        t_pl = cuda_ms(lambda: vision_forward(model, x, plain), reps=2)
        busy_nat = device_ms(lambda: vision_forward(model, x, native), None, reps=10)
        busy_am = device_ms(lambda: vision_forward(model, x, amsim), None, reps=10)
        print(f"  {model_name}: native {t_nat:.4f} ms (device busy {busy_nat:.4f} ms), amsim "
              f"{t_am:.4f} ms (device busy {busy_am:.4f} ms, idle share "
              f"{1 - busy_am / t_am:.3f}), amsim_torch {t_pl:.2f} ms; amsim/native = "
              f"{t_am / t_nat:.2f}x (the paper's yardstick: native only 8x faster than AMSim)")

    # Each kernel at the shapes of one resnet-mini forward: capture its calls.
    calls = {"approx_gemm": [], "approx_conv2d_fused": []}
    orig_gemm, orig_conv = ops.approx_gemm, ops.approx_conv2d_fused
    ops.approx_gemm = lambda *a, **kw: calls["approx_gemm"].append((a, kw)) or orig_gemm(*a, **kw)
    ops.approx_conv2d_fused = lambda *a, **kw: (calls["approx_conv2d_fused"].append((a, kw))
                                                or orig_conv(*a, **kw))
    model, x = runs["resnet-mini"]
    vision_forward(model, x, amsim)
    ops.approx_gemm, ops.approx_conv2d_fused = orig_gemm, orig_conv

    def gemm_cost(a, b, lut, M):
        m, k = a.shape
        n = b.shape[1]
        nbytes = 4 * (m * k + k * n + m * n) + lut_bytes(lut)
        return nbytes, m * k * n, lambda: approx_gemm_plain(a, b, lut, M)

    def conv_cost(x, w, lut, M, stride=1, padding="SAME"):
        n, h, wid, c = x.shape
        kh, kw, _, o = w.shape
        pads = conv_pads(h, wid, kh, kw, stride, padding)
        oh, ow = conv_out_shape(h, wid, kh, kw, stride, pads)
        # Padding taps are skipped: count the taps these inputs need.
        rows = sum(0 <= oy * stride + ki - pads[0] < h for oy in range(oh) for ki in range(kh))
        cols = sum(0 <= ox * stride + kj - pads[2] < wid for ox in range(ow) for kj in range(kw))
        nbytes = 4 * (x.numel() + w.numel() + n * oh * ow * o) + lut_bytes(lut)
        return nbytes, n * o * c * rows * cols, lambda: approx_conv2d_plain(x, w, lut, M, stride,
                                                                            pads)

    rows_out = []
    # (source, TPU kernel it replaces, wrapper, cost model, device kernel name)
    sources = {"approx_gemm": ("approx_gemm.cu", "src/repro/kernels/approx_gemm.py:57",
                               orig_gemm, gemm_cost, "approx_gemm_kernel"),
               "approx_conv2d_fused": ("approx_conv.cu", "src/repro/kernels/approx_conv.py:105",
                                       orig_conv, conv_cost, "approx_conv_kernel")}
    print("kernels at the shapes of one resnet-mini forward: device time from torch.profiler, "
          "wrapper call time (host launch path included) from CUDA events:")
    for kname, (src, replaces, fn, cost, symbol) in sources.items():
        ms = call_ms = plain_ms = bound = bytes_s = ops_s = 0.0
        for args, kw in calls[kname]:
            nbytes, lookups, plain_fn = cost(*args, **kw)
            t_call = cuda_ms(lambda: fn(*args, **kw), reps=20, warmup=2)
            t = device_ms(lambda: fn(*args, **kw), symbol, reps=10)
            require(t > 0, f"torch.profiler saw no device time for {symbol}")
            tp = cuda_ms(plain_fn, reps=1)
            tb = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
            shapes = " ".join(str(tuple(a.shape)) for a in args[:2])
            print(f"  {kname} {shapes} {kw}: {t:.4f} ms on device, {t_call:.4f} ms per call "
                  f"(plain {tp:.2f} ms, bound {tb:.4f} ms, {lookups} lookups, {nbytes} B)")
            ms, call_ms, plain_ms, bound = ms + t, call_ms + t_call, plain_ms + tp, bound + tb
            bytes_s += nbytes / HBM_BYTES_PER_S
            ops_s += lookups / lookups_per_s
        rows_out.append({
            "name": kname, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": main_launches[kname],
            "max_abs_err": max_err[kname], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes", "library_ms": None})
        print(f"kernel {kname} (replaces {replaces}): {ms:.4f} ms on device per resnet-mini "
              f"forward over {len(calls[kname])} launches ({call_ms:.4f} ms per-call time), "
              f"bound {bound:.4f} ms "
              f"({rows_out[-1]['bound_by']}), plain {plain_ms:.2f} ms, max|d| "
              f"{max_err[kname]}; no PyTorch call computes a LUT product, so no library time")

    print(smi_line)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
