"""The supervised training loop: checkpoints, restore and retry, the
divergence supervisor, the degradation ladder and the straggler watchdog.
The port of ``repro.train.trainer``.

A train step here (``train.step.make_train_step``) updates the model's
parameters in place, where the JAX step returns new ones.  So a step that
fails or diverges has already written its update, and the rollback is a
restore from the newest checkpoint: ``run`` saves the starting state when
the checkpoint directory holds none, so there is always one to go back
to.  The divergence supervisor raises :class:`DivergenceError` on
non-finite metrics or a loss spike before the state is counted or saved,
so no checkpoint holds a diverged state.

:class:`StepFactory` builds the train step of each numerics a run uses and
counts the builds; its ``ladder`` is a ``degrade_fn`` that demotes a flat
policy or a per-site table rung by rung (``core.policy.demote_numerics``).
The sweep runners assert one build per numerics used: ``1 +
ladder_level``.

Under a mesh (``mesh=``, with ``specs``, the spec tree of the
checkpointed tree): a checkpoint is the gathered tree, written by rank 0,
so it is the single-device run's; a restore reads the whole tree on every
rank and keeps its blocks.  There is no retry: a rank that fails fails
the run.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.core.policy import demote_numerics


class DivergenceError(RuntimeError):
    """Training metrics went non-finite or spiked past the EMA band.
    ``reason`` is ``"non-finite"`` or ``"loss-spike"``, ``value`` the
    offending metric's value."""

    def __init__(self, step: int, reason: str, value: float, metric: str = "loss"):
        super().__init__(f"step {step}: {metric} {reason} ({value!r})")
        self.step = step
        self.reason = reason
        self.value = value
        self.metric = metric


@dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 200
    keep: int = 3
    log_every: int = 50
    max_retries: int = 3            # restores from a checkpoint before the ladder
    straggler_factor: float = 3.0   # a step slower than factor x the median is flagged
    nonfinite_sentinel: bool = True  # NaN/inf in any metric -> DivergenceError
    spike_factor: float = 0.0       # loss > factor x its EMA -> DivergenceError (0: off)
    spike_warmup: int = 5           # steps that seed the EMA before it can fire
    ema_beta: float = 0.9           # decay of the loss EMA
    retry_window: int = 50          # clean steps in a row that refill the retry budget
    # Degradation ladder: level (1, 2, ...) -> a more conservative train
    # step, or None when there is none; asked when the retries are spent,
    # and a rung taken resets them.
    degrade_fn: Optional[Callable[[int], Optional[Callable]]] = None
    log_fn: Callable = print


@dataclass
class TrainerState:
    model: torch.nn.Module
    opt_state: object
    step: int = 0
    stragglers: list = field(default_factory=list)
    # (step, metrics) at every log_every step, restored steps again (set by run)
    history: list = field(default_factory=list)


@dataclass
class StepFactory:
    """``make(numerics) -> train_step``, counted: ``builds`` is how many
    steps were made, ``numerics`` the numerics of each, in order."""

    make: Callable
    builds: int = 0
    numerics: list = field(default_factory=list)

    def __call__(self, numerics):
        self.builds += 1
        self.numerics.append(numerics)
        return self.make(numerics)

    def ladder(self, policy, log_fn: Callable = lambda s: None) -> Callable:
        """A ``degrade_fn``: level L builds the step of ``policy`` demoted L
        times, or gives None when the policy runs out of rungs first."""
        def degrade(level: int):
            pol = policy
            for _ in range(level):
                pol = demote_numerics(pol)
                if pol is None:
                    return None
            log_fn(f"ladder level {level}: {pol}")
            return self(pol)
        return degrade


class Trainer:
    """Drives ``train_step(model, opt_state, batch) -> (opt_state,
    metrics)`` over ``batch_fn(step)``:

    * a checkpoint every ``ckpt_every`` steps (atomic, keep-K, CRC-tagged);
    * on an exception (a failed step, a :class:`DivergenceError`): restore
      the newest checkpoint and go on, at most ``max_retries`` times;
      ``retry_window`` clean steps in a row refill the budget;
    * the budget spent, climb the ladder (``degrade_fn``), or re-raise;
    * a step slower than ``straggler_factor`` x the running median of the
      last 50 is recorded in ``state.stragglers``; a step is timed up to
      the read-back of its loss.

    After ``run``: ``divergences`` lists each supervisor trip as (step,
    reason, value), ``ladder_level`` the rung reached (0: none) and
    ``step_times`` the seconds of each step that completed.
    """

    def __init__(self, train_step, batch_fn, cfg: TrainerConfig, *, mesh=None, specs=None):
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.mesh, self.specs = mesh, specs
        self.mgr = CheckpointManager(cfg.ckpt_dir, cfg.keep) if cfg.ckpt_dir else None
        self.divergences: list[tuple[int, str, float]] = []
        self.ladder_level = 0
        self.step_times: list[float] = []

    @staticmethod
    def _tree(state: TrainerState) -> dict:
        return {"params": dict(state.model.named_parameters()), "opt": state.opt_state}

    def _save(self, state: TrainerState):
        tree = self._tree(state)
        if self.mesh is None:
            self.mgr.save(state.step, tree)
            return
        from repro_torch.distributed.sharding import gather_tree
        whole = gather_tree(tree, self.specs, self.mesh)
        if self.mesh.rank == 0:
            self.mgr.save(state.step, whole)
        torch.distributed.barrier()

    def _restore(self, state: TrainerState) -> TrainerState:
        """The newest checkpoint, copied into the model in place."""
        restored, meta = self.mgr.restore_latest(self._tree(state))
        if restored is None:
            raise RuntimeError(f"{self.mgr.dir}: no checkpoint to restore")
        if self.mesh is not None:
            from repro_torch.distributed.sharding import shard_tree
            restored = shard_tree(restored, self.specs, self.mesh)
        params = dict(state.model.named_parameters())
        with torch.no_grad():
            for name, value in restored["params"].items():
                params[name].copy_(value)
        return TrainerState(state.model, restored["opt"], step=int(meta["step"]),
                            stragglers=state.stragglers)

    def _check_divergence(self, step: int, metrics: dict, ema: Optional[float]):
        """Raise DivergenceError on diverged metrics; else the updated loss
        EMA (None without a loss metric)."""
        cfg = self.cfg
        if cfg.nonfinite_sentinel:
            for k, v in metrics.items():
                if not math.isfinite(v):
                    self.divergences.append((step, "non-finite", v))
                    raise DivergenceError(step, "non-finite", v, metric=k)
        if "loss" not in metrics:
            return ema
        loss = metrics["loss"]
        if cfg.spike_factor > 0 and ema is not None and step > cfg.spike_warmup \
                and loss > cfg.spike_factor * ema:
            self.divergences.append((step, "loss-spike", loss))
            raise DivergenceError(step, "loss-spike", loss)
        return loss if ema is None else cfg.ema_beta * ema + (1 - cfg.ema_beta) * loss

    def _next_rung(self, state: TrainerState, error: Exception) -> TrainerState:
        """The retries are spent: take the next rung of the ladder and
        restore, or re-raise ``error`` when there is none."""
        cfg = self.cfg
        nxt = None if cfg.degrade_fn is None else cfg.degrade_fn(self.ladder_level + 1)
        if nxt is None:
            if cfg.degrade_fn is not None:
                cfg.log_fn(f"[supervisor] degradation ladder exhausted at level "
                           f"{self.ladder_level}; giving up")
            raise error
        self.ladder_level += 1
        self.train_step = nxt
        cfg.log_fn(f"[supervisor] demoting to ladder level {self.ladder_level}; retry budget "
                   f"reset")
        return self._restore(state)

    def run(self, state: TrainerState) -> TrainerState:
        cfg = self.cfg
        if self.mgr is not None:
            if self.mgr.latest_step() is None:
                self._save(state)
            else:
                state = self._restore(state)
        retries = clean_steps = 0
        ema: Optional[float] = None
        times = self.step_times
        history = []
        last_saved = state.step if self.mgr is not None else -1
        while state.step < cfg.total_steps:
            try:
                t0 = time.perf_counter()
                opt_state, metrics = self.train_step(state.model, state.opt_state,
                                                     self.batch_fn(state.step))
                metrics = {k: float(v) for k, v in metrics.items()}   # waits for the step
                dt = time.perf_counter() - t0
                ema = self._check_divergence(state.step + 1, metrics, ema)
                state = TrainerState(state.model, opt_state, state.step + 1, state.stragglers)
                clean_steps += 1
                if retries and cfg.retry_window and clean_steps >= cfg.retry_window:
                    cfg.log_fn(f"[supervisor] {clean_steps} clean steps: retry budget reset")
                    retries = 0
                times.append(dt)
                med = float(np.median(times[-50:]))
                if len(times) > 5 and dt > cfg.straggler_factor * med:
                    state.stragglers.append((state.step, dt, med))
                    cfg.log_fn(f"[watchdog] step {state.step}: {dt:.3f}s vs median "
                               f"{med:.3f}s: straggler flagged")
                if state.step % cfg.log_every == 0:
                    history.append((state.step, metrics))
                    cfg.log_fn(f"step {state.step}: "
                               + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
                if self.mgr is not None and state.step % cfg.ckpt_every == 0:
                    self._save(state)
                    last_saved = state.step
            except KeyboardInterrupt:
                raise
            except Exception as e:  # a failed or diverged step: restore and retry
                if self.mesh is not None:
                    raise
                retries += 1
                clean_steps = 0
                ema = None
                cfg.log_fn(f"[supervisor] step {state.step} failed ({e!r}); retry "
                           f"{retries}/{cfg.max_retries} from checkpoint")
                if self.mgr is None:
                    raise
                if retries > cfg.max_retries:
                    state = self._next_rung(state, e)
                    retries = 0
                else:
                    state = self._restore(state)
        if self.mgr is not None and state.step != last_saved:
            self._save(state)
        state.history = history
        return state
