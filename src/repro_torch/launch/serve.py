"""The serving CLI: batched greedy generation, or a continuous-batching
request stream (the port of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --stream 32 --prompt-len 256 \
        --min-prompt-len 32 --new-tokens 32 --tiers exact=native,cheap=amsim:afm16 \
        --capacity 8 --page-size 16                          # on the card
    python -m repro_torch.launch.serve --stream 4 --reduced --device cpu
    python -m repro_torch.launch.serve --numerics amsim --multiplier afm16   # one batch

``--stream N`` replays a synthetic timed stream of N requests through the
paged scheduler (``serve/scheduler.ContinuousBatchingEngine``): prompt
lengths drawn uniformly in ``--min-prompt-len`` .. ``--prompt-len``
(default half the maximum up to it) and tokens from ``--seed`` with numpy,
one arrival every ``--arrival-every`` ticks, tiers taken in turn from
``--tiers`` (``name=mode[:multiplier],...``; sorted by name).  It prints,
for the stream and each tier, the tokens, tokens/s, decode ticks and
builds, preemptions, the most pages a lane held and the prefill time an
admission by bucket, and asserts one decode build per tier.  Without
``--stream`` it serves one batch through ``ServingEngine``.

Full width by default; ``--n-layers`` cuts the depth only, ``--reduced``
takes the smoke-test widths of ``configs.base.reduced``.  Weights are
drawn from ``--seed`` on the device.  Every dense arch serves, llava-next-34b
on text tokens only, as JAX's engines do (a prefill with its patch
embeddings is ``lm_forward(embeds=, caches=)``), and the MoE archs; ``--stream``
refuses llama4-maverick-400b-a17b, whose (dense, MoE) pairs JAX's paged
caches do not hold either.  An encoder-decoder arch (whisper-base) exits before any work
with the JAX CLI's message.

``--mesh`` serves the batch on a 2x2 (data, model) debug mesh of four
ranks (``launch.mesh.spawn``, the backend printed first), as JAX's CLI
does: a dense arch's weights drawn on every rank and cut to its blocks,
``ServingEngine(mesh=)``; rank 0 prints.  ``--mesh`` with ``--stream``
exits: the paged scheduler under a mesh is a later slice.

    python -m repro_torch.launch.serve --reduced --device cpu --mesh --numerics amsim
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.policy import MODES, NumericsPolicy, load_numerics
from repro_torch.device import resolve_device
from repro_torch.models.encdec import ENGINE_REFUSAL
from repro_torch.models.transformer import check_paged, init_lm
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.scheduler import ContinuousBatchingEngine


def parse_tiers(spec: str) -> dict:
    """``name=mode[:multiplier],...`` -> {name: NumericsPolicy}."""
    tiers = {}
    for part in spec.split(","):
        name, _, pol = part.partition("=")
        if not name or not pol:
            raise SystemExit(f"bad tier spec {part!r} (want name=mode[:multiplier])")
        mode, _, mult = pol.partition(":")
        if mode not in MODES:
            raise SystemExit(f"tier {name!r}: unknown mode {mode!r} (have {sorted(MODES)})")
        tiers[name] = (NumericsPolicy() if mode == "native" and not mult
                       else NumericsPolicy(mode=mode, multiplier=mult or "fp32"))
    return tiers


def synthetic_stream(args, vocab: int) -> list:
    """[(arrival tick, prompt, new tokens, tier)] of ``--stream`` requests,
    drawn from ``--seed`` with numpy (the JAX CLI's draw)."""
    rng = np.random.default_rng(args.seed)
    names = sorted(parse_tiers(args.tiers))
    lo = args.min_prompt_len if args.min_prompt_len else max(1, args.prompt_len // 2)
    stream = []
    for i in range(args.stream):
        plen = int(rng.integers(lo, args.prompt_len + 1))
        prompt = rng.integers(1, vocab, size=plen)
        stream.append((i * args.arrival_every, prompt, args.new_tokens, names[i % len(names)]))
    return stream


def stream_engine(args, model, n_pages=None) -> ContinuousBatchingEngine:
    """The stream's engine: a lane per tier, ``--capacity`` slots of
    ``--page-size`` pages, positions up to prompt + new tokens + 1;
    ``n_pages`` pages a lane as ``ContinuousBatchingEngine`` takes it
    (default: no preemption)."""
    return ContinuousBatchingEngine(
        model, parse_tiers(args.tiers), max_len=args.prompt_len + args.new_tokens + 1,
        capacity=args.capacity, page_size=args.page_size, n_pages=n_pages)


def report_stream(engine: ContinuousBatchingEngine, wall_s: float) -> dict:
    """Print the stream's numbers; returns them by tier ("stream": totals)."""
    reqs = list(engine.finished.values())
    total = sum(len(r.out) for r in reqs)
    rep = {"stream": {"requests": len(reqs), "tokens": total, "s": wall_s,
                      "tokens_per_s": total / wall_s,
                      "preemptions": sum(r.preemptions for r in reqs)}}
    print(f"stream: {len(reqs)} requests, {total} tokens in {wall_s:.3f} s "
          f"({total / wall_s:.2f} tok/s), {rep['stream']['preemptions']} preemptions")
    for name, lane in engine._lanes.items():
        mine = [r for r in reqs if r.tier == name]
        n = sum(len(r.out) for r in mine)
        ticks = lane.decode_ticks
        tick_ms = 1e3 * sum(lane.decode_s) / max(ticks, 1)
        prefill = {b: 1e3 * sum(ts) / len(ts) for b, ts in sorted(lane.prefill_s.items())}
        rep[name] = {"requests": len(mine), "tokens": n, "tokens_per_s": n / wall_s,
                     "decode_ticks": ticks, "decode_builds": lane.decode_builds,
                     "tick_ms": tick_ms, "prefill_ms": prefill,
                     "preemptions": sum(r.preemptions for r in mine),
                     "pages_high": lane.pages_high, "pages": lane.alloc.capacity}
        print(f"  tier {name}: {len(mine)} requests, {n} tokens ({n / wall_s:.2f} tok/s), "
              f"{ticks} decode ticks ({tick_ms:.3f} ms a tick, wall), "
              f"{lane.decode_builds} decode build(s), {rep[name]['preemptions']} preemptions, "
              f"pages high-water {lane.pages_high} of {lane.alloc.capacity}; prefill ms an "
              f"admission by bucket " + ", ".join(f"{b}: {t:.2f} ({len(lane.prefill_s[b])}x)"
                                                  for b, t in prefill.items()))
    print(f"decode builds: {engine.decode_trace_counts} (expect 1 per tier)")
    for name, count in engine.decode_trace_counts.items():
        assert count == 1, f"tier {name} built its decode step {count}x"
    return rep


def run_stream(args, model) -> tuple[ContinuousBatchingEngine, dict]:
    """Replay the synthetic stream through the paged scheduler."""
    engine = stream_engine(args, model)
    stream = synthetic_stream(args, model.cfg.vocab)
    t0 = time.perf_counter()
    engine.run(stream)
    return engine, report_stream(engine, time.perf_counter() - t0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-2b",
                    help="granite-3-2b, stablelm-12b, qwen2.5-32b, qwen1.5-110b, "
                         "llava-next-34b (dense; llava serves text tokens only), "
                         "granite-moe-3b-a800m (MoE), llama4-maverick-400b-a17b ((dense, MoE) "
                         "pairs), mamba2-780m (SSM) or zamba2-1.2b (hybrid; --stream takes "
                         "dense and granite-moe only)")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-test widths of configs.base.reduced")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers (widths stay)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--min-prompt-len", type=int, default=0,
                    help="--stream: shortest prompt (default: half of --prompt-len)")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--numerics", default="native",
                    help=f"one batch: a mode ({'|'.join(MODES)}) or a policy-table JSON path")
    ap.add_argument("--multiplier", default="fp32")
    ap.add_argument("--mesh", action="store_true",
                    help="one batch on a 2x2 (data, model) mesh of four ranks")
    ap.add_argument("--mesh-timeout", type=float, default=1800.0,
                    help="seconds every collective and the whole mesh run may take")
    ap.add_argument("--stream", type=int, default=0, metavar="N",
                    help="continuous batching: replay a synthetic stream of N requests")
    ap.add_argument("--tiers", default="default=native",
                    help="per-request numerics tiers for --stream, name=mode[:multiplier],...")
    ap.add_argument("--capacity", type=int, default=4, help="resident slots per tier lane")
    ap.add_argument("--page-size", type=int, default=16, help="tokens per KV page")
    ap.add_argument("--arrival-every", type=int, default=1,
                    help="scheduler ticks between request arrivals")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _arch_cfg(args):
    cfg = get_arch(args.arch)
    if cfg.family == "encdec":
        raise SystemExit(ENGINE_REFUSAL)
    if args.reduced:
        cfg = reduced(cfg)
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return cfg


def _serve_rank(mesh, args):
    """One rank of ``--mesh``: the batch through ``ServingEngine(mesh=)``;
    rank 0 prints and returns the tokens."""
    from repro_torch.distributed import shard_fused

    cfg = _arch_cfg(args)
    policy = load_numerics(args.numerics, args.multiplier)
    gen = torch.Generator(device=mesh.device).manual_seed(args.seed)
    model = init_lm(cfg, generator=gen, device=mesh.device, mesh=mesh)
    engine = ServingEngine(model, policy, max_len=args.prompt_len + args.new_tokens + 1,
                           mesh=mesh)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                            device=mesh.device)
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=args.new_tokens)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dt = time.perf_counter() - t0
    if mesh.rank == 0:
        print("mesh dispatch: " + shard_fused.describe(mesh, policy))
        print(f"generated {tuple(out.shape)} in {dt:.2f}s "
              f"({args.batch * args.new_tokens / dt:.1f} tok/s) on {mesh!r}; "
              f"{mesh.stats['collectives']} collectives on rank 0")
        print(out[:, :8].tolist())
    return out.cpu()


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mesh and args.stream:
        raise SystemExit("--mesh --stream: the paged scheduler under a mesh (sharded page "
                         "pools) is a later slice of the port; --mesh serves one batch")
    cfg = _arch_cfg(args)
    if args.mesh:
        from repro_torch.launch.mesh import spawn
        from repro_torch.launch.train import mesh_device
        return spawn(_serve_rank, (2, 2), device=mesh_device(args.device),
                     timeout=args.mesh_timeout, args=(args,))[0]
    device = resolve_device(args.device)
    if args.stream:
        try:
            check_paged(cfg)
        except NotImplementedError as e:
            raise SystemExit(f"--stream: {e}") from None
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = init_lm(cfg, generator=gen, device=device)
    if args.stream:
        engine, _ = run_stream(args, model)
        return engine
    policy = load_numerics(args.numerics, args.multiplier)
    engine = ServingEngine(model, policy, max_len=args.prompt_len + args.new_tokens + 1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                            device=device)
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=args.new_tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} in {dt:.2f}s ({args.batch * args.new_tokens / dt:.1f} "
          f"tok/s)")
    print(out[:, :8].tolist())
    return engine


if __name__ == "__main__":
    main()
