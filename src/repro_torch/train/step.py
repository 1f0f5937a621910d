"""The train step: gradients, microbatch accumulation, clipping, update.

The twin of ``repro.train.step``.  ``make_train_step`` works for any
``loss_fn(model, batch) -> (loss, metrics)``; the step updates the model's
parameters in place (``optim.apply_updates``) and returns the optimizer
state and the metrics, where the JAX step returns a new parameter tree.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.optim.optimizers import Optimizer, apply_updates, clip_by_global_norm


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    microbatches: int = 1, clip_norm: float = 1.0):
    """``loss_fn(model, batch) -> (loss, {name: scalar tensor})``; returns
    ``train_step(model, opt_state, batch) -> (opt_state, metrics)`` with
    metrics ``loss``, ``grad_norm`` and those of ``loss_fn``.

    ``microbatches > 1`` splits the batch's leading axis into that many
    equal parts, in order, and averages their losses and gradients;
    ``clip_norm`` (0 turns it off) clips by global norm before the update.
    """

    def grads_of(model, params, batch):
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(params, grads)))

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if microbatches > 1:
            size = next(iter(batch.values())).shape[0]
            if size % microbatches:
                raise ValueError(f"batch of {size} does not split into {microbatches} "
                                 f"microbatches")
            size //= microbatches
            loss = 0.0
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            for i in range(microbatches):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                mb_loss, metrics, mb_grads = grads_of(model, params, mb)
                loss = loss + mb_loss
                grads = {k: grads[k] + mb_grads[k] for k in grads}
            loss = loss / microbatches
            grads = {k: g / microbatches for k, g in grads.items()}
        else:
            loss, metrics, grads = grads_of(model, params, batch)

        if clip_norm:
            specs = {k: tuple(getattr(p, "spec", ())) for k, p in params.items()}
            grads, gnorm = clip_by_global_norm(grads, clip_norm, specs)
        else:
            gnorm = torch.zeros((), device=loss.device)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        apply_updates(params, updates)
        return opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step
