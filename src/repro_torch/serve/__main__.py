"""Batched greedy serving of an LM with optional approximate-multiplier
numerics: the twin of ``examples/serve_lm.py``.

    python -m repro_torch.serve --new-tokens 24                 # on the card
    python -m repro_torch.serve --numerics native
    python -m repro_torch.serve --arch granite-moe-3b-a800m     # MoE, 40 experts
    python -m repro_torch.serve --arch mamba2-780m              # SSM (Mamba2)
    python -m repro_torch.serve --arch zamba2-1.2b              # hybrid
    python -m repro_torch.serve --arch stablelm-12b             # heads of 160, 48.6 GB
    python -m repro_torch.serve --arch qwen2.5-32b --n-layers 8 # q/k/v biases
    python -m repro_torch.serve --arch llama4-maverick-400b-a17b --n-layers 2   # 74.2 GB
    python -m repro_torch.serve --reduced --device cpu --numerics amsim_torch
    python -m repro_torch.serve --numerics table.json           # per-site numerics

Full width by default; ``--n-layers`` cuts the depth only, ``--reduced``
takes the smoke-test widths of ``configs.base.reduced``.  ``--numerics``
takes a mode or a policy-table JSON (docs/policies.md): the fused decode
chain runs when every chain site (qkv, wo, wg, wu, wd and both attention
sites) resolves to one ``amsim`` or ``amsim_torch`` leaf, whatever the
router and the head run; a table that splits them runs the per-op path.
The chain runs the dense blocks (the hybrid's shared block); a Mamba2
layer decodes by its recurrence.  llava-next-34b serves text tokens only,
as JAX's ``ServingEngine`` does: its prefill with patch embeddings is
``lm_forward(embeds=, caches=)``.  The 30-110 B archs (llava, the qwens)
fit one card only at a cut depth; llama4-maverick-400b-a17b ((dense, MoE)
pairs, 128 experts and a shared expert) at one pair, ``--n-layers 2`` (an
odd depth raises).  An encoder-decoder arch (whisper-base)
exits before any work with the JAX CLI's message: no engine serves one.
Prints which, tokens/s, the prefill time and the time per decode step.
"""
import argparse
import dataclasses
import os

import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.policy import MODES, PolicyTable, load_numerics
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.encdec import ENGINE_REFUSAL
from repro_torch.models.transformer import init_lm
from repro_torch.serve.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b",
                    help="granite-3-2b, stablelm-12b, qwen2.5-32b, qwen1.5-110b, "
                         "llava-next-34b (dense; llava on text tokens), granite-moe-3b-a800m "
                         "(MoE), llama4-maverick-400b-a17b ((dense, MoE) pairs), mamba2-780m "
                         "(SSM) or zamba2-1.2b (hybrid)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--numerics", default="amsim",
                    help=f"a mode ({'|'.join(MODES)}) or a policy-table JSON path")
    ap.add_argument("--multiplier", default="afm16",
                    help="the multiplier of a mode (afm16, bf16, mitchell8, fp16xbf16, ...)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers (widths stay)")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-test widths of configs.base.reduced")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if cfg.family == "encdec":
        raise SystemExit(ENGINE_REFUSAL)
    device = resolve_device(args.device)
    if args.reduced:
        cfg = reduced(cfg)
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    policy = load_numerics(args.numerics, args.multiplier)
    print(f"decode chain: {'fused' if ops.decode_chain_enabled(policy) else 'per-op'}")
    gen = torch.Generator(device=device).manual_seed(0)
    model = init_lm(cfg, generator=gen, device=device)
    engine = ServingEngine(model, policy, max_len=args.prompt_len + args.new_tokens + 1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                            device=device)
    timings = {}
    out = engine.generate(prompts, max_new_tokens=args.new_tokens, timings=timings)
    total = timings["prefill_s"] + timings["decode_s"]
    steps = max(timings["decode_steps"], 1)
    tag = (os.path.basename(args.numerics) if isinstance(policy, PolicyTable)
           else f"{args.numerics}/{args.multiplier}")
    print(f"[{tag}] {cfg.name}, {cfg.n_layers} layers, on "
          f"{device}: generated {tuple(out.shape)} in {total:.3f} s "
          f"({args.batch * args.new_tokens / total:.1f} tok/s); prefill "
          f"{timings['prefill_s'] * 1e3:.1f} ms, {timings['decode_s'] * 1e3 / steps:.2f} ms "
          f"per decode step")
    for row in range(min(args.batch, 2)):
        print("  seq", row, ":", out[row, :10].tolist())


if __name__ == "__main__":
    main()
