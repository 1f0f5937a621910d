"""Time the decode-chain, attention, GEMM and conv kernels on the card at the
path's shapes.

    python src/repro_torch/kernels/time_chain.py [--src DIR] [--tag NAME] [--match TEXT]
                                                 [--luts A,B] [--dw-sweep] [--conv-sweep]
                                                 [--attn-sweep]

Needs an NVIDIA GPU and nvcc.  ``--src`` imports ``repro_torch`` from
another checkout's ``src`` (its kernels built there), so that two trees
are timed by one script in one call on one card: run it for each tree in
turns (A, B, B, A).  Weights and activations are random, from a seed; the
expert banks get the capacity buffers that ``moe.moe_ffn`` scatters for 4
decode tokens (C = 8) and for a prefill of 4 x 64 tokens (C = 64).  The
GEMM kernel (``--match approx_gemm``) is timed at granite-3-2b's four
prefill projection shapes (4 x 64 tokens) and its head at 4 rows,
granite-moe-3b-a800m's router and head at 4 rows and its expert banks on
the capacity-512 buffers of a 4 x 512 prefill, and at the vision models'
fc GEMMs at batch 64 (forward, dx and dw).  The conv weight-gradient
kernel (``--match approx_conv2d_dw``) is timed at the 8 distinct dw shapes
of a resnet-mini training step (15 launches) and LeNet-5's 2, batch 64,
with the sum over a resnet-mini step; ``--dw-sweep`` also times every tile
its plan could take at each shape.  The conv kernel (``--match
approx_conv2d_fused``) is timed at the same shapes: a resnet-mini step's
15 forward and 14 data-gradient launches and LeNet-5's 2 and 1, with the
sum over a step of each; the data gradient reads the undilated error with
``input_dilation`` where the tree's ``approx_conv2d_fused`` takes it, else
the dilated error that ``ops.conv_dx_operands`` materialises;
``--conv-sweep`` also times every tile the kernel takes at each shape.
The attention kernel (``--match approx_attention``) is timed at
granite-3-2b's prefill (4 x 64 tokens into a ring of 96) and a decode step
over a ring of 160 with 96 keys written, granite-moe-3b-a800m's decode
step over a ring of 96 with 80 written (G = 3) and its prefill of 4 x 512
tokens into a ring of 512, each with its plan and grid where the tree has
``attention_plan``; ``--attn-sweep`` also times every tile and table form
the kernel takes at each shape.  Each time is the mean device
time of a launch from CUDA events around 5 calls queued behind a spin
kernel, for each packed table of ``--luts`` (default afm16, a
shared-memory LUT, and afm10, global memory; ``fp16xbf16`` is the
asymmetric cross-format table, global); the GEMM also with afm16's packed
table kept packed in shared memory ("raw"), where the tree has that
choice; the dense back half (``fused_out_mlp``, ``fused_attn_out_mlp``)
under every table but afm10.  Prints one line a kernel and shape, then
one JSON object {"tag", "device", "power_limit", "ms": {name: ms}}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def queued_ms(fn, reps: int = 5) -> float:
    """Mean device ms of ``fn()`` with the host out of the way: a spin kernel
    holds the stream while the calls queue up behind it."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 10_000_000
    for _ in range(5):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise SystemExit("time_chain: the host could not queue the calls ahead of the card")


# The fc GEMMs of LeNet-300-100, LeNet-5 and resnet-mini at batch 64, and a
# ragged one: (m, k, n) of the forward product (chip_smoke.py's GEMM_SHAPES).
VISION_GEMMS = [(64, 784, 120), (64, 120, 84), (64, 84, 10), (64, 784, 300),
                (64, 300, 100), (64, 100, 10), (64, 64, 10), (67, 130, 33)]


# The dw shapes of a resnet-mini and a LeNet-5 training step at batch 64:
# (model, x shape, w shape, stride, launches a step), all SAME
# (chip_smoke.py's CONV_SHAPES).
DW_SHAPES = [
    ("resnet-mini", (64, 32, 32, 3), (3, 3, 3, 16), 1, 1),
    ("resnet-mini", (64, 32, 32, 16), (3, 3, 16, 16), 1, 4),
    ("resnet-mini", (64, 32, 32, 16), (3, 3, 16, 32), 2, 1),
    ("resnet-mini", (64, 32, 32, 16), (1, 1, 16, 32), 2, 1),
    ("resnet-mini", (64, 16, 16, 32), (3, 3, 32, 32), 1, 3),
    ("resnet-mini", (64, 16, 16, 32), (3, 3, 32, 64), 2, 1),
    ("resnet-mini", (64, 16, 16, 32), (1, 1, 32, 64), 2, 1),
    ("resnet-mini", (64, 8, 8, 64), (3, 3, 64, 64), 1, 3),
    ("lenet-5", (64, 28, 28, 1), (5, 5, 1, 6), 1, 1),
    ("lenet-5", (64, 14, 14, 6), (5, 5, 6, 16), 1, 1),
]


def time_dw(timed, randn, lut_name, lut, M, sweep):
    """The conv weight-gradient kernel at the DW_SHAPES (module doc)."""
    import dataclasses
    from repro_torch.kernels import approx_conv as conv
    steps = {}
    for model, xs, ws, stride, per_step in DW_SHAPES:
        kh, kw, _, o = ws
        pads = conv.conv_pads(xs[1], xs[2], kh, kw, stride, "SAME")
        oh, ow = conv.conv_out_shape(xs[1], xs[2], kh, kw, stride, pads)
        name = f"{lut_name} approx_conv2d_dw {model} {xs}x{ws}/s{stride}"
        if not timed.wants(name):
            continue
        x, g = randn(*xs), randn(xs[0], oh, ow, o)
        run = lambda: conv.approx_conv2d_dw(x, g, lut, M, kh=kh, kw=kw, stride=stride,  # noqa: E731
                                            padding="SAME")
        plan_of = getattr(conv, "dw_plan", None)
        if plan_of is not None:
            plan = plan_of(kh, kw, xs[3], o, lut, torch_sms(lut.device))
            print(f"{timed.tag} {name}: plan {plan}")
        ms = timed(name, run)
        steps[model] = steps.get(model, 0.0) + per_step * ms
        if sweep and plan_of is not None:
            for outputs in (conv.DW_THREADS, *conv.DW_SPLIT_OUTPUTS):
                for to in (8, 16, 32, 64):
                    tc = outputs // to
                    if tc < 1 or tc > max(1, xs[3]) * 2 or to > max(8, 2 * o):
                        continue
                    forced = dataclasses.replace(
                        plan, tile=(tc, to), outputs=outputs, chunk=conv.dw_chunk(outputs),
                        path="tiled" if outputs >= conv.DW_THREADS else "split")
                    conv.dw_plan = lambda *a, f=forced: f
                    try:
                        timed(f"{lut_name} approx_conv2d_dw sweep {xs}x{ws}/s{stride} tile "
                              f"{tc}x{to}", run)
                    finally:
                        conv.dw_plan = plan_of
    for model, ms in steps.items():
        print(f"{timed.tag} {lut_name} approx_conv2d_dw: {ms:.4f} ms a {model} step", flush=True)


# Data-gradient launches a step of each DW_SHAPES conv: none where the
# conv's input is the image (the stem, LeNet-5's conv 1).
NO_DX = {((64, 32, 32, 3), (3, 3, 3, 16)), ((64, 28, 28, 1), (5, 5, 1, 6))}


def time_conv(timed, randn, lut_name, lut, M, sweep):
    """The conv kernel at the forward and data-gradient launches of the
    DW_SHAPES convs (module doc)."""
    import dataclasses
    import inspect
    import torch
    from repro_torch.kernels import approx_conv as conv
    from repro_torch.kernels import ops
    undilated = "input_dilation" in inspect.signature(conv.approx_conv2d_fused).parameters
    plan_of = getattr(conv, "conv_plan", None)
    steps = {}
    for model, xs, ws, stride, per_step in DW_SHAPES:
        kh, kw, _, o = ws
        pads = conv.conv_pads(xs[1], xs[2], kh, kw, stride, "SAME")
        oh, ow = conv.conv_out_shape(xs[1], xs[2], kh, kw, stride, pads)
        names = {p: f"{lut_name} approx_conv2d_fused {p} {model} {xs}x{ws}/s{stride}"
                 for p in ("fwd", "dx")}
        if not any(timed.wants(name) for name in names.values()):
            continue
        x, w, g = randn(*xs), randn(*ws), randn(xs[0], oh, ow, o)
        launches = {"fwd": (x, w, dict(stride=stride, padding="SAME"), per_step)}
        if (xs, ws) not in NO_DX:
            if undilated:
                w_rt, dpads = ops.conv_dx_weights(w, (oh, ow), xs[1:3], stride, pads)
                launches["dx"] = (g, w_rt, dict(padding=dpads, input_dilation=stride), per_step)
            else:
                gd, w_rt, dpads = ops.conv_dx_operands(g, w, xs[1:3], stride, pads)
                launches["dx"] = (gd, w_rt, dict(padding=dpads), per_step)
        for pass_, (a, b, kwargs, n) in launches.items():
            name = names[pass_]
            if not timed.wants(name):
                continue
            run = lambda: conv.approx_conv2d_fused(a, b, lut, M, **kwargs)  # noqa: E731
            plan = None
            if plan_of is not None:   # the dx launch's pads are explicit
                s = kwargs.get("stride", 1)
                shape = conv.conv_shape(a.shape, b.shape, s,
                                        conv.conv_pads(*a.shape[1:3], kh, kw, s, kwargs["padding"]),
                                        kwargs.get("input_dilation", 1))
                plan = plan_of(shape, lut, torch_sms(lut.device))
                print(f"{timed.tag} {name}: plan {plan}; grid {conv.conv_grid(plan, shape, lut)}")
            ms = timed(name, run)
            key = (model, pass_)
            steps[key] = steps.get(key, 0.0) + n * ms
            if sweep and plan is not None:
                # every tile, with the plan's table form and, for a packed
                # table the plan expands to canonical words, kept packed
                expanded = plan.table == "smem canonical" and lut.dtype == torch.int16
                tables = [plan.table] + (["smem packed"] if expanded else [])
                for table in tables:
                    for tm, wn in conv.CONV_TILES:
                        forced = dataclasses.replace(
                            plan, tile=(tm, conv.CONV_TN), warps=(conv.CONV_WARPS // wn, wn),
                            block=(conv.CONV_WARPS // wn * 32 * tm, wn * conv.CONV_TN),
                            table=table)
                        conv.conv_plan = lambda *a, f=forced: f
                        try:
                            timed(f"{lut_name} approx_conv2d_fused sweep {pass_} {xs}x{ws}"
                                  f"/s{stride} tile {tm}x{conv.CONV_TN} warps "
                                  f"{conv.CONV_WARPS // wn}x{wn} table {table}", run)
                        finally:
                            conv.conv_plan = plan_of
        del x, w, g, launches
    for model in dict.fromkeys(m for m, _ in steps):
        parts = {p: ms for (m, p), ms in steps.items() if m == model}
        print(f"{timed.tag} {lut_name} approx_conv2d_fused: {sum(parts.values()):.4f} ms a {model} "
              f"step (" + ", ".join(f"{p} {ms:.4f}" for p, ms in parts.items()) + ")", flush=True)


# (label, arch, batch, query tokens, ring slots, keys written): the
# attention kernel's launches on the serving paths.
ATTN_CASES = [("granite-3-2b prefill 4x64 ring 96", "granite-3-2b", 4, 64, 96, 64),
              ("granite-3-2b decode ring 160", "granite-3-2b", 4, 1, 160, 96),
              ("granite-moe-3b-a800m decode ring 96", "granite-moe-3b-a800m", 4, 1, 96, 80),
              ("granite-moe-3b-a800m prefill 4x512 ring 512", "granite-moe-3b-a800m", 4, 512,
               512, 512)]


def time_attention(timed, randn, lut_name, lut, M, sweep):
    """The attention kernel at the ATTN_CASES (module doc)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import approx_attention as attn
    from repro_torch.kernels.common import POS_PAD, lut_bytes
    plan_of = getattr(attn, "attention_plan", None)
    for label, arch, B, S, T, written in ATTN_CASES:
        name = f"{lut_name} approx_attention {label}"
        if not timed.wants(name):
            continue
        cfg = get_arch(arch)
        H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v = randn(B, S, H, dh), randn(B, T, KV, dh), randn(B, T, KV, dh)
        k_pos = torch.full((T,), POS_PAD, dtype=torch.int32)
        for p in range(max(0, written - T), written):
            k_pos[p % T] = p
        k_pos = k_pos.to(lut.device)
        q_pos = torch.arange(written - S, written, dtype=torch.int32, device=lut.device)
        run = lambda: attn.approx_attention(q, k, v, q_pos, k_pos, lut, M)  # noqa: E731
        plan = None
        if plan_of is not None:
            shape = attn.attention_shape(q.shape, k.shape)
            plan = plan_of(shape, lut, torch_sms(lut.device))
            print(f"{timed.tag} {name}: plan {plan}; grid {attn.attention_grid(plan, shape, lut)}")
        timed(name, run)
        if sweep and plan is not None:
            packed = lut.dtype == torch.int16
            tables = [plan.table]
            if packed and plan.table.startswith("smem"):
                tables = ["smem canonical", "smem packed"]
            for tile, (rt, tm, tn) in enumerate(attn.ATTN_TILES):
                for table in tables:
                    space = attn.SMEM_BLOCK_MAX - attn._table_bytes(table, packed, lut_bytes(lut))
                    layout = attn.attention_layout(tile, dh, T, space)
                    if layout is None:
                        continue
                    forced = attn._tile_plan(shape, tile, table, layout, plan.path)
                    attn.attention_plan = lambda *a, f=forced: f
                    try:
                        timed(f"{lut_name} approx_attention sweep {label} tile {rt * tm} rows "
                              f"table {table} scores {forced.scores}", run)
                    finally:
                        attn.attention_plan = plan_of
        del q, k, v


def torch_sms(device) -> int:
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def routed_buffer(cfg, router, x, policy):
    """The (E, C, d) capacity buffer that ``moe.moe_ffn`` scatters for the
    tokens x (B, S, d) with the router weights (d, E) under ``policy`` (one
    that takes the expert-bank launch)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.layers import Linear
    E, d, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff
    banks = {"wg": (E, d, F), "wu": (E, d, F), "wd": (E, F, d)}
    p = torch.nn.ModuleDict({
        "router": Linear(router),
        "experts": torch.nn.ModuleDict({n: Linear(torch.zeros(shape, device=x.device))
                                        for n, shape in banks.items()})})
    seen, original, max_c = [], ops.decode_moe_ffn, ops.MOE_FFN_MAX_C
    ops.decode_moe_ffn = lambda buf, *a: seen.append(buf) or torch.zeros_like(buf)
    ops.MOE_FFN_MAX_C = 1 << 30      # capture the buffer at any capacity
    try:
        with torch.no_grad():
            moe.moe_ffn(p, x, cfg, policy)
    finally:
        ops.decode_moe_ffn, ops.MOE_FFN_MAX_C = original, max_c
    return seen[0]


def time_gemms(timed, randn, lut_name, lut, M, dense, moe_cfg, B, policy):
    """The GEMM kernel at the serving and training shapes (module doc)."""
    import torch
    from repro_torch.kernels import approx_gemm as gemm
    d = dense.d_model
    shapes = {f"{dense.name} prefill {64 * B}x{k}x{n}": (64 * B, k, n)
              for k, n in ((d, dense.n_heads * dense.head_dim),
                           (d, dense.n_kv_heads * dense.head_dim), (d, dense.d_ff),
                           (dense.d_ff, d))}
    shapes[f"{dense.name} head {B}x{d}x{dense.vocab}"] = (B, d, dense.vocab)
    dm = moe_cfg.d_model
    shapes[f"{moe_cfg.name} router {B}x{dm}x{moe_cfg.moe.n_experts}"] = (
        B, dm, moe_cfg.moe.n_experts)
    shapes[f"{moe_cfg.name} head {B}x{dm}x{moe_cfg.vocab}"] = (B, dm, moe_cfg.vocab)
    for m, k, n in VISION_GEMMS:
        for pass_, shape in (("fwd", (m, k, n)), ("dx", (m, n, k)), ("dw", (k, m, n))):
            shapes[f"vision {pass_} {'x'.join(map(str, shape))}"] = shape
    # (tag, EXPAND_MIN_K): the plan's own table form, then afm16's packed
    # table kept packed at every k, where the tree has that choice
    min_k = getattr(gemm, "EXPAND_MIN_K", None)
    variants = [("", min_k)]
    if lut_name == "afm16" and min_k is not None:
        variants.append((" raw", sys.maxsize))
    for tag, expand_min_k in variants:
        if min_k is not None:
            gemm.EXPAND_MIN_K = expand_min_k
        for label, (m, k, n) in shapes.items():
            name = f"{lut_name}{tag} approx_gemm {label}"
            if not timed.wants(name):
                continue
            a, b = randn(m, k), randn(k, n, scale=k ** -0.5)
            timed(name, lambda: gemm.approx_gemm(a, b, lut, M))
        E, F = moe_cfg.moe.n_experts, moe_cfg.moe.d_ff
        name = f"{lut_name}{tag} approx_gemm_batched {moe_cfg.name} C=512"
        if not timed.wants(name):
            continue
        router = randn(dm, E, scale=dm ** -0.5)
        h = routed_buffer(moe_cfg, router, randn(B, 512, dm), policy)
        live = ((h.view(torch.int32) >> 23) & 0xFF).bool().any(-1)
        act = randn(E, h.shape[1], F) * live[..., None]
        for what, a, b in (("gate", h, randn(E, dm, F, scale=dm ** -0.5)),
                           ("down", act, randn(E, F, dm, scale=F ** -0.5))):
            timed(f"{name} {what} {tuple(a.shape)}x{tuple(b.shape)} ({int(live.sum())} "
                  f"live rows)", lambda: gemm.approx_gemm_batched(a, b, lut, M))
        del h, act
    if min_k is not None:
        gemm.EXPAND_MIN_K = min_k


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--tag", default="", help="a name for this tree in the output")
    ap.add_argument("--match", default="", help="time only the kernels whose line holds this")
    ap.add_argument("--luts", default="afm16,afm10",
                    help="the multipliers whose packed tables are timed, comma-separated")
    ap.add_argument("--dw-sweep", action="store_true",
                    help="also time every tile of the dw kernel at each dw shape")
    ap.add_argument("--conv-sweep", action="store_true",
                    help="also time every tile of the conv kernel at each conv shape")
    ap.add_argument("--attn-sweep", action="store_true",
                    help="also time every tile of the attention kernel at each shape")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_chain: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_arch
    from repro_torch.core.lutgen import get_packed_lut
    from repro_torch.core.multipliers import get_multiplier
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.kernels import decode_chain as chain
    from repro_torch.kernels.common import POS_PAD, lut_tensor

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    ms = {}

    def timed(name, fn):
        if args.match not in name:
            return None
        ms[name] = queued_ms(fn)
        print(f"{args.tag} {name}: {ms[name]:.4f} ms a launch", flush=True)
        return ms[name]

    timed.wants = lambda name: args.match in name
    timed.tag = args.tag

    dense, moe_cfg = get_arch("granite-3-2b"), get_arch("granite-moe-3b-a800m")
    B = 4
    for lut_name in args.luts.split(","):
        lut = lut_tensor(get_packed_lut(lut_name), dev)
        M = get_multiplier(lut_name).mantissa_bits
        time_gemms(timed, randn, lut_name, lut, M, dense, moe_cfg, B,
                   NumericsPolicy(mode="amsim", multiplier="afm16"))
        time_dw(timed, randn, lut_name, lut, M, args.dw_sweep)
        time_conv(timed, randn, lut_name, lut, M, args.conv_sweep)
        time_attention(timed, randn, lut_name, lut, M, args.attn_sweep)
        for cfg in (dense, moe_cfg):
            d, nq, nkv = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
            qkv = (randn(B, d), 1 + 0.1 * randn(d), randn(d, nq, scale=d ** -0.5),
                   randn(d, nkv, scale=d ** -0.5), randn(d, nkv, scale=d ** -0.5))
            timed(f"{lut_name} fused_qkv_norm {cfg.name} {B} rows",
                  lambda: chain.fused_qkv_norm(*qkv, lut, M, eps=cfg.norm_eps))
            del qkv
        if lut_name != "afm10":
            cfg = dense
            d, F, H, KV, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            K = H * dh
            back = (1 + 0.1 * randn(d), randn(K, d, scale=K ** -0.5), randn(d, F, scale=d ** -0.5),
                    randn(d, F, scale=d ** -0.5), randn(F, d, scale=F ** -0.5))
            x, attn = randn(B, d), randn(B, K, scale=0.3)
            timed(f"{lut_name} fused_out_mlp {cfg.name} {B} rows",
                  lambda: chain.fused_out_mlp(x, attn, *back, lut, M, eps=cfg.norm_eps))
            T, written = 96, 80
            k_pos = torch.full((T,), POS_PAD, dtype=torch.int32)
            k_pos[:written] = torch.arange(written, dtype=torch.int32)
            att = (randn(B, 1, H, dh), randn(B, T, KV, dh), randn(B, T, KV, dh),
                   torch.tensor([written - 1], dtype=torch.int32, device=dev), k_pos.to(dev))
            timed(f"{lut_name} fused_attn_out_mlp {cfg.name} {B} rows ring {T}",
                  lambda: chain.fused_attn_out_mlp(x, *att, *back, lut, M, eps=cfg.norm_eps))
            del back, att
        cfg = moe_cfg
        d, E, F, K = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff, cfg.n_heads * cfg.head_dim
        x, attn = randn(B, d), randn(B, K, scale=0.3)
        wo_args = (1 + 0.1 * randn(d), randn(K, d, scale=K ** -0.5))
        timed(f"{lut_name} fused_wo_norm {cfg.name} {B} rows",
              lambda: chain.fused_wo_norm(x, attn, *wo_args, lut, M, eps=cfg.norm_eps))
        banks = (randn(E, d, F, scale=d ** -0.5), randn(E, d, F, scale=d ** -0.5),
                 randn(E, F, d, scale=F ** -0.5))
        router = randn(d, E, scale=d ** -0.5)
        policy = NumericsPolicy(mode="amsim", multiplier="afm16")
        for tokens in ((1, 4), (4, 64)):
            h = routed_buffer(cfg, router, randn(*tokens, d), policy)
            live = int(((h.view(torch.int32) >> 23) & 0xFF).bool().any(-1).sum())
            timed(f"{lut_name} fused_moe_ffn {cfg.name} C={h.shape[1]} ({live} live rows)",
                  lambda: chain.fused_moe_ffn(h, *banks, lut, M))
        del banks
        torch.cuda.empty_cache()
    print(json.dumps({"tag": args.tag, "device": torch.cuda.get_device_name(0),
                      "power_limit": smi.split(", ")[-1], "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
