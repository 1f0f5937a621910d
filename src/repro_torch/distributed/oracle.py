"""The k-split oracle of a mesh's LM loss and gradients, on one device.

``docs/numerics.md`` ("Sharded contracts"): sharding splits only parallel
axes, so the sharded ops are bitwise the single-device op, except where
a contraction crosses shards; there the result is bitwise the k-split
oracle, each shard's slice through the single-device kernel and the
partials added in shard order.  ``ksplit`` composes that oracle for a
dense LM's forward (serving: a data rank's rows are its own, so the
single-device run over every row is the mesh's), and
``ksplit_loss_and_grads`` for a whole training step: the single-device
model, run one data block of rows at a time (a data rank's rows), with

  * every product that the mesh computes column- or row-parallel
    (``shard_fused.parallel_matmul``: an engaging forward leaf and a
    weight whose spec is its kind's) computed from the mesh's per-shard
    partials: a row-parallel forward and a column-parallel dx as the
    partials of each "model" block, added in block order; every other
    product, and every other op, whole (each of those is bitwise the
    mesh's by its contract);
  * the mean token cross-entropy taken as the mesh takes it, each block's
    sum over the count of every block's labels, the sums added in order;
  * each gradient summed over the data blocks in order, as the mesh's
    ``ordered_sum`` over the data axes, and a tensor that the step reads
    twice (a tied table: the lookup and the head) summed per use first.

A mesh's loss and gradients are then bitwise these at any width, where a
tolerance against the unsplit run could not tell a rounding from a fault.
The dense family alone, without biases (a bias's gradient is a reduction
over a column block whose order need not match the whole tensor's).
"""
from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.core.policy import Numerics
from repro_torch.distributed import shard_fused as sf
from repro_torch.kernels import ops
from repro_torch.launch.mesh import MeshShape, single_device


def _ordered(parts):
    acc = None
    for p in parts:
        acc = p if acc is None else acc + p
    return acc


class _SplitMatmul(torch.autograd.Function):
    """x @ w with the mesh's contraction split over ``n`` "model" blocks:
    a row-parallel forward, or a column-parallel dx."""

    @staticmethod
    def forward(ctx, x, w, policy, site, kind, n):
        ctx.save_for_backward(x, w)
        ctx.policy, ctx.site, ctx.kind, ctx.n = policy, site, kind, n
        leaf = policy.resolve(site)
        if kind == "row":
            return _ordered(ops._matmul_nograd(xb.contiguous(), wb, leaf)
                            for xb, wb in zip(x.chunk(n, -1), w.chunk(n, 0)))
        return ops._matmul_nograd(x, w, leaf)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        leaf_dx = ctx.policy.resolve(ctx.site, pass_="dx")
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if ctx.kind == "column":
                dx = _ordered(ops._matmul_nograd(gb.contiguous(), wb.contiguous().T, leaf_dx)
                              for gb, wb in zip(g.chunk(ctx.n, -1), w.chunk(ctx.n, 1)))
            else:
                dx = ops._matmul_nograd(g, w.T, leaf_dx)
        if ctx.needs_input_grad[1]:
            dw = sf._dw(x, g, ctx.policy.resolve(ctx.site, pass_="dw"))
        return dx, dw, None, None, None, None


@contextlib.contextmanager
def _patched(module, name, value):
    was = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, was)


@contextlib.contextmanager
def ksplit(model, mesh: MeshShape):
    """Inside, without an ambient mesh: ``model``'s products as ``mesh``
    splits them (its parameters placed by
    ``distributed.sharding.lm_param_specs``), and the decode chain off, as
    under a mesh.  Yields {parameter name: a leaf of its own} for each
    parameter that a product reads through its transpose (the tied head,
    under grad), so that its gradient there is kept apart from the
    parameter's other uses."""
    from repro_torch.distributed.sharding import lm_param_specs
    from repro_torch.models.transformer import lm_param_shapes
    cfg = model.cfg
    params = dict(model.named_parameters())
    if cfg.family != "dense" or any(n.endswith(".b") for n in params):
        raise NotImplementedError(f"{cfg.name}: the oracle covers dense stacks without biases")
    specs = lm_param_specs(lm_param_shapes(cfg), cfg, mesh)
    spec_of = {id(p): tuple(specs.get(n, ())) + (None,) * (2 - p.ndim) for n, p in params.items()}
    name_of = {id(p): n for n, p in params.items()}
    uses = {}

    def parallel_matmul(x, w, policy, kind, site=None, *, w_spec=None, w_full=None):
        base = w._base if w._base is not None and id(w._base) in name_of else None
        if base is not None:        # w = a parameter's transpose (the tied head)
            name = name_of[id(base)]
            if name not in uses:
                uses[name] = base.detach().requires_grad_(base.requires_grad)
            spec, w = spec_of[id(base)][::-1], uses[name].T
        else:
            spec = spec_of.get(id(w), (None, None))
        if kind in ("column", "row") and sf.engages(policy.resolve(site)) \
                and sf.matmul_supported(kind, spec):
            return _SplitMatmul.apply(x.to(torch.float32), w.to(torch.float32), policy, site,
                                      kind, mesh.model_size)
        return ops.policy_matmul(x, w, policy, site)

    was = os.environ.get("REPRO_DECODE_FUSED")
    os.environ["REPRO_DECODE_FUSED"] = "0"
    try:
        with single_device(), _patched(sf, "parallel_matmul", parallel_matmul):
            yield uses
    finally:
        if was is None:
            del os.environ["REPRO_DECODE_FUSED"]
        else:
            os.environ["REPRO_DECODE_FUSED"] = was


def ksplit_loss_and_grads(model, batch: dict, policy: Numerics, mesh: MeshShape):
    """(loss, {parameter name: gradient}) that a dense LM's ``lm_loss`` step
    on ``mesh`` (each data rank holding its rows of ``batch``) gives,
    gathered, computed under ``ksplit`` from the whole parameters and
    batch on ``model``'s device."""
    from repro_torch.models import transformer as tf
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    count = torch.sum(batch["labels"] >= 0).to(torch.float32)
    sums, grads, apart = [], {}, {}

    def label_xent(logits, labels):
        total, _ = tf.xent_sum(logits, labels)
        sums.append(total.detach())
        return total / torch.clamp(count, min=1)

    for d in range(mesh.data_size):
        rows = {k: v.chunk(mesh.data_size, 0)[d] for k, v in batch.items()}
        with ksplit(model, mesh) as uses, _patched(tf, "label_xent", label_xent):
            loss, _ = tf.lm_loss(model, rows, policy)
            extra = {n: t for n, t in uses.items() if t.requires_grad}
            got = torch.autograd.grad(loss, list(params.values()) + list(extra.values()))
        for into, names, gs in ((grads, params, got[:len(params)]),
                                (apart, extra, got[len(params):])):
            for n, g in zip(names, gs):
                into[n] = g if n not in into else into[n] + g
    for n, g in apart.items():
        grads[n] = grads[n] + g
    return _ordered(sums) / torch.clamp(count, min=1), grads
