"""LM training on one device: the port of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch granite-3-2b --steps 3 --batch 4 \
        --seq 64 --numerics amsim --multiplier afm16            # on the card
    python -m repro_torch.launch.train --reduced --device cpu --steps 2
    python -m repro_torch.launch.train --arch mamba2-780m --steps 3 --batch 4 \
        --seq 256 --numerics amsim --multiplier afm16           # SSD chunks of 256
    python -m repro_torch.launch.train --arch whisper-base --steps 3 --batch 4 \
        --seq 64 --numerics amsim --multiplier afm16            # over 1500 frames
    python -m repro_torch.launch.train --arch llava-next-34b --reduced --device cpu \
        --steps 2 --batch 2 --seq 16                            # 8 patches + 8 text
    python -m repro_torch.launch.train --arch llama4-maverick-400b-a17b --n-layers 2 \
        --n-experts 16 --steps 2 --batch 4 --seq 64 --numerics amsim --multiplier afm16

Full width by default (``--reduced``: the smoke-test widths of
``configs.base.reduced``); weights drawn from ``--seed``, batches from
``data.pipeline.lm_batch``.  The SSM and hybrid archs (mamba2-780m,
zamba2-1.2b) scan whole SSD chunks: ``--seq`` must be a multiple of the
config's chunk (256; 8 under ``--reduced``).  The encoder-decoder
(whisper-base) trains ``encdec_loss``: ``--seq`` is the decoder's length,
and the encoder takes ``n_frontend_tokens`` frames (1500; 8 under
``--reduced``) that ``lm_batch`` draws.  A decoder-only LM with a
frontend (llava-next-34b) trains ``lm_loss`` on ``lm_batch``'s patch
embeddings and text: of ``--seq`` positions, ``n_frontend_tokens`` (2880;
8 under ``--reduced``) are patches, the rest text, so ``--seq`` must
exceed them.  ``--n-layers`` cuts the depth (llama4-maverick-400b-a17b:
whole (dense, MoE) pairs, else it raises) and ``--n-experts`` an MoE arch's
routed experts (``configs.base.cut``): one (dense, MoE) pair of llama4
trains at full width with its 128 experts cut to 16.  The optimizer is the
config's (``cfg.optimizer``: adafactor for qwen1.5-110b and llama4, adamw
for every other ported config) over
``cosine_schedule(lr, 10, steps)``, driven by ``train.trainer.Trainer``
(checkpoints under ``--ckpt-dir`` every steps/5).  Prints the numerics
report and the metrics every steps/10.

``--mesh DxM`` (or ``PxDxM``) trains on a mesh of that many ranks
(``launch.mesh.spawn``; the backend is printed first): every arch runs
tensor- and data-parallel through ``distributed/shard_fused`` (an MoE
arch's experts over "model", its routing the whole batch's; whisper-base's
encoder and decoder as a dense stack), each rank
drawing the same weights and keeping its blocks, and each data rank
keeping its rows of the global ``lm_batch``, so the data are the
single-device run's.  Rank 0 alone prints, the dispatch line too.  Under
``--ckpt-dir`` a checkpoint is the gathered tree, written by rank 0: the
single-device run's, which a resume on any mesh cuts again.  ``main``
returns rank 0's history and the gathered parameters (the JAX tree).

    python -m repro_torch.launch.train --reduced --device cpu --steps 2 --mesh 2x2
    python -m repro_torch.launch.train --n-layers 4 --steps 2 --batch 4 --seq 64 \
        --numerics amsim --multiplier afm16 --mesh 2x2     # four ranks on one card: gloo

Per-site numerics (docs/policies.md): ``--numerics-table table.json``
loads a ``PolicyTable`` (``--numerics`` takes a table path too), or
``--assign "qkv=mitchell8,dw=native"`` assigns multipliers per site on
top of the ``--numerics``/``--multiplier`` default.  Under a table the
report prints one line for each site whose leaves differ from the
default's.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.configs.base import ArchConfig, cut, get_arch, reduced
from repro_torch.core.policy import (MODES, PASSES, SITES, Numerics, PolicyTable,
                                     load_numerics, table_from_assignments, table_from_json)
from repro_torch.convert import encdec_params_to_numpy, lm_params_to_numpy
from repro_torch.data.pipeline import lm_batch
from repro_torch.device import resolve_device
from repro_torch.models.encdec import (encdec_loss, encdec_param_shapes, encdec_stacks,
                                       init_encdec)
from repro_torch.models.transformer import init_lm, lm_loss, lm_stacks
from repro_torch.optim.optimizers import Optimizer, cosine_schedule, make_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig, TrainerState


def make_lm_train_step(cfg: ArchConfig, policy: Numerics, *, lr: float, steps: int,
                       microbatches: int = 1) -> tuple[Optimizer, callable]:
    """(optimizer, ``train_step(model, opt_state, batch)``) of an LM run of
    ``steps`` steps: ``cfg.optimizer`` over ``cosine_schedule(lr, 10,
    steps)`` on ``lm_loss`` (``encdec_loss`` for an encoder-decoder) under
    ``policy``, global-norm clip 1.0."""
    encdec = cfg.family == "encdec"
    loss, stacks = (encdec_loss, encdec_stacks) if encdec else (lm_loss, lm_stacks)
    opt = make_optimizer(cfg.optimizer, cosine_schedule(lr, 10, steps), stacks=stacks(cfg))
    step = make_train_step(lambda model, batch: loss(model, batch, policy), opt,
                           microbatches=microbatches)
    return opt, step


def check_seq(cfg: ArchConfig, seq: int):
    """Exit before any work unless ``seq`` fits the arch: the SSD scan of an
    SSM or hybrid stack takes whole chunks of ``cfg.ssm.chunk`` steps; a
    decoder-only frontend's patches take ``cfg.n_frontend_tokens`` of the
    positions, and the text the rest."""
    if cfg.ssm is not None and seq % cfg.ssm.chunk:
        raise SystemExit(f"--seq {seq} is not a multiple of {cfg.name}'s SSD chunk "
                         f"{cfg.ssm.chunk}: the chunked scan takes whole chunks")
    F = cfg.n_frontend_tokens
    if F and cfg.family != "encdec" and seq <= F:
        raise SystemExit(f"--seq {seq} leaves no text: {cfg.name}'s {F} frontend positions "
                         f"come first, so --seq must exceed {F}")


def _kernels_on(device: torch.device) -> str:
    return ("the CUDA LUT kernels" if device.type == "cuda"
            else "the kernels' plain versions on the CPU")


def describe_numerics(policy: Numerics, device: torch.device) -> str:
    """Which path this run's products take.  A table: the default leaf of
    each pass, then one line for each site whose leaves differ from those."""
    if isinstance(policy, PolicyTable):
        def leaves_text(leaves):
            return ", ".join(f"{p} {'native' if lf.is_native else f'{lf.mode}/{lf.multiplier}'}"
                             for p, lf in zip(PASSES, leaves))

        default = [policy.resolve(None, "gemm", p) for p in PASSES]
        lines = [f"numerics table ({len(policy.rules)} rules) on {device}, amsim through "
                 f"{_kernels_on(device)}: default {leaves_text(default)}"]
        for site in SITES:
            leaves = [policy.resolve(site, pass_=p) for p in PASSES]
            if any((lf.mode, lf.multiplier) != (d.mode, d.multiplier)
                   for lf, d in zip(leaves, default)):
                lines.append(f"  {site}: {leaves_text(leaves)}")
        return "\n".join(lines)
    if policy.is_native:
        return f"numerics=native: exact float32 (TF32 off) on {device}"
    if policy.mode == "amsim":
        return f"numerics=amsim/{policy.multiplier}: {_kernels_on(device)}"
    return f"numerics={policy.mode}/{policy.multiplier} on {device}"


def policy_from_args(args) -> Numerics:
    """The run's numerics: ``--numerics-table``, or ``--assign`` over the
    ``--numerics``/``--multiplier`` default, or those two alone (a mode
    name or a table path)."""
    if args.numerics_table and args.assign:
        raise SystemExit("--numerics-table and --assign are mutually exclusive (put the "
                         "assignments in the table JSON)")
    if args.numerics_table:
        return table_from_json(args.numerics_table)
    if args.assign:
        default = (("native", "fp32") if args.numerics == "native"
                   else (args.numerics, args.multiplier))
        return table_from_assignments(args.assign, default=default)
    return load_numerics(args.numerics, args.multiplier)


def parse_mesh(text: str) -> tuple:
    """"2x2" -> (2, 2); "2x2x2" -> (2, 2, 2) (pod, data, model)."""
    try:
        sizes = tuple(int(v) for v in text.lower().split("x"))
    except ValueError:
        sizes = ()
    if len(sizes) not in (2, 3) or min(sizes) < 1:
        raise SystemExit(f"--mesh {text!r}: want DxM or PxDxM, e.g. 2x2")
    return sizes


def check_mesh_arch(cfg, sizes) -> None:
    """Exit before any rank starts when ``cfg`` does not run on a mesh of
    ``sizes`` yet (``transformer.check_mesh_family``)."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.transformer import check_mesh_family
    try:
        check_mesh_family(cfg, MeshShape(sizes))
    except NotImplementedError as e:
        raise SystemExit(f"--mesh: {e}") from None


def mesh_device(arg) -> str:
    """The ranks' device kind: "cpu" when asked, else the card(s), whose
    kernels the parent builds before the ranks start (ranks never build
    into one directory at once)."""
    if arg == "cpu":
        return "cpu"
    resolve_device(arg)
    from repro_torch.kernels import _build
    _build.build()
    return "cuda"


def _train_rank(mesh, args):
    """One rank of ``--mesh``: the run of ``main``'s arguments on its
    blocks; rank 0 prints."""
    from repro_torch.distributed import shard_fused
    from repro_torch.distributed.sharding import lm_param_specs, opt_state_specs
    from repro_torch.models.transformer import lm_param_shapes

    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    cfg = _arch_cfg(args)
    encdec = cfg.family == "encdec"
    policy = policy_from_args(args)
    say(describe_numerics(policy, mesh.device))
    say("  mesh dispatch: " + shard_fused.describe(mesh, policy))
    init = init_encdec if encdec else init_lm
    model = init(cfg, generator=torch.Generator(device=mesh.device).manual_seed(args.seed),
                 device=mesh.device, mesh=mesh)
    opt, step = make_lm_train_step(cfg, policy, lr=args.lr, steps=args.steps,
                                   microbatches=args.microbatches)
    shapes = (encdec_param_shapes if encdec else lm_param_shapes)(cfg)
    stacked = lm_param_specs(shapes, cfg, mesh, stacked=True)
    specs = {n: tuple(p.spec) for n, p in model.named_parameters()}
    opt_specs = opt_state_specs(cfg.optimizer, stacked if cfg.optimizer == "adafactor" else specs)

    def batch_fn(s):
        return {k: mesh.block(v, mesh.data_axes, 0)
                for k, v in lm_batch(cfg, (args.batch, args.seq), s, mesh.device).items()}

    trainer = Trainer(step, batch_fn,
                      TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                                    ckpt_every=max(args.steps // 5, 1),
                                    log_every=max(args.steps // 10, 1), log_fn=say),
                      mesh=mesh, specs={"params": specs, "opt": opt_specs})
    state = trainer.run(TrainerState(model, opt.init(dict(model.named_parameters()))))
    say(f"done at step {state.step}; stragglers flagged: {len(state.stragglers)}; "
        f"collectives on rank 0: {mesh.stats['collectives']}")
    # gathered on every rank
    params = (encdec_params_to_numpy if encdec else lm_params_to_numpy)(model, mesh)
    return {"history": state.history, "params": params} if mesh.rank == 0 else None


def _arch_cfg(args) -> ArchConfig:
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = cut(cfg, n_layers=args.n_layers, n_experts=args.n_experts)
    check_seq(cfg, args.seq)
    return cfg


def arg_parser() -> argparse.ArgumentParser:
    """``main``'s arguments."""
    ap = argparse.ArgumentParser(description="LM training on one device or a mesh of ranks")
    ap.add_argument("--arch", default="granite-3-2b",
                    help="granite-3-2b, stablelm-12b, qwen2.5-32b, qwen1.5-110b (dense), "
                         "llava-next-34b (dense, patch embeddings first), granite-moe-3b-a800m "
                         "(MoE), llama4-maverick-400b-a17b ((dense, MoE) pairs, a shared "
                         "expert), mamba2-780m (SSM), zamba2-1.2b (hybrid) or whisper-base "
                         "(encoder-decoder)")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-test widths of configs.base.reduced")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers (widths stay)")
    ap.add_argument("--n-experts", type=int, default=None,
                    help="cut an MoE arch's routed experts to this many")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128,
                    help="positions a row (an encoder-decoder's decoder length, its encoder "
                         "takes the config's frames; a decoder-only frontend's patches and "
                         "text together)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--numerics", default="native",
                    help=f"a mode ({'|'.join(MODES)}) or a policy-table JSON path")
    ap.add_argument("--multiplier", default="fp32",
                    help="the multiplier of a non-native mode (afm16, bf16, mitchell8, "
                         "fp16xbf16, ...)")
    ap.add_argument("--numerics-table", metavar="PATH", default=None,
                    help="per-site numerics: a policy-table JSON (docs/policies.md); "
                         "overrides --numerics/--multiplier")
    ap.add_argument("--assign", metavar="SPEC", default=None,
                    help="per-site assignments, e.g. 'qkv=mitchell8,head=native,dw=native'; "
                         "unassigned sites run --numerics/--multiplier")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="train on a (data, model) mesh of ranks, e.g. 2x2 (PxDxM: pods too)")
    ap.add_argument("--mesh-timeout", type=float, default=1800.0,
                    help="seconds every collective and the whole mesh run may take")
    return ap


def main(argv=None):
    args = arg_parser().parse_args(argv)

    cfg = _arch_cfg(args)
    if args.mesh:
        from repro_torch.launch.mesh import spawn
        sizes = parse_mesh(args.mesh)
        check_mesh_arch(cfg, sizes)
        if args.batch % math.prod(sizes[:-1]):
            raise SystemExit(f"--batch {args.batch} does not split over the "
                             f"{math.prod(sizes[:-1])} data ranks of --mesh {args.mesh}")
        return spawn(_train_rank, sizes, device=mesh_device(args.device),
                     timeout=args.mesh_timeout, args=(args,))[0]
    device = resolve_device(args.device)
    policy = policy_from_args(args)
    print(describe_numerics(policy, device))

    init = init_encdec if cfg.family == "encdec" else init_lm
    model = init(cfg, generator=torch.Generator(device=device).manual_seed(args.seed),
                 device=device)
    opt, step = make_lm_train_step(cfg, policy, lr=args.lr, steps=args.steps,
                                   microbatches=args.microbatches)
    trainer = Trainer(step, lambda s: lm_batch(cfg, (args.batch, args.seq), s, device),
                      TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                                    ckpt_every=max(args.steps // 5, 1),
                                    log_every=max(args.steps // 10, 1)))
    state = trainer.run(TrainerState(model, opt.init(dict(model.named_parameters()))))
    print(f"done at step {state.step}; stragglers flagged: {len(state.stragglers)}")
    return state


if __name__ == "__main__":
    main()
