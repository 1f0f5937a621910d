"""The k-split oracle of a mesh's forward, loss and gradients, on one device.

``docs/numerics.md`` ("Sharded contracts"): sharding splits only parallel
axes, so the sharded ops are bitwise the single-device op, except where
a contraction crosses shards; there the result is bitwise the k-split
oracle, each shard's slice through the single-device kernel and the
partials added in shard order.  ``ksplit`` composes that oracle for a
model's forward.  Its calls have the mesh's shapes where a product's bits
may depend on the shape of its call (cuBLAS, under ``native``, picks its
algorithm by a call's rows and batch): an MoE layer's banks run in the
mesh's blocks of experts, one block a "model" rank, and a paged stream's
decode tick runs each data rank's slots in turn, as a mesh whose data axes
split the slots does, in lockstep with each MoE layer's routing exchanged
(the whole tick's).  A ``ServingEngine`` batch runs whole under ``ksplit``
(an MoE layer routes the whole batch as the mesh does); a caller that
needs a data rank's rows alone runs them in turn.
``ksplit_loss_and_grads`` composes it for a whole training step: the
single-device model, run one data block of rows at a time (a data rank's
rows), with

  * every product that the mesh computes column- or row-parallel
    (``shard_fused.parallel_matmul``: an engaging forward leaf and a
    weight whose spec is its kind's) computed from the mesh's per-shard
    partials: a row-parallel forward and a column-parallel dx as the
    partials of each "model" block, added in block order; every other
    product (the replicated dispatch: the SSM projections, whisper's
    head, an MoE router), and every other op, whole (each of those is
    bitwise the mesh's by its contract);
  * an MoE layer's routing the whole batch's: the blocks run in lockstep
    (a thread each, one at a time), exchanging each MoE layer's choices
    and router probabilities as the mesh's ranks all-gather them, so the
    capacity, slots and drops are the whole batch's and the aux loss
    takes its means over it, its gradient reaching each block's own rows;
  * the mean token cross-entropy taken as the mesh takes it, each block's
    sum over the count of every block's labels, the sums added in order;
  * each gradient summed over the data blocks in order, as the mesh's
    ``ordered_sum`` over the data axes, and a tensor that the step reads
    twice through different products (a tied table: the lookup and the
    head) summed per use first.  A block that the step applies more than
    once (the hybrid's shared block) adds up its applications within the
    block, as the mesh does before its one data sum.

A mesh's loss and gradients are then bitwise these at any width, where a
tolerance against the unsplit run could not tell a rounding from a fault.
Every family: dense (biases too: the mesh reduces a column-split bias's
gradient over the whole columns), MoE, SSM, hybrid and the
encoder-decoder.
"""
from __future__ import annotations

import contextlib
import os
import threading

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


def _param_shapes(cfg) -> dict:
    if cfg.family == "encdec":
        from repro_torch.models.encdec import encdec_param_shapes
        return encdec_param_shapes(cfg)
    from repro_torch.models.transformer import lm_param_shapes
    return lm_param_shapes(cfg)


_LOCAL = threading.local()      # .block: the data block a lockstep thread runs
# the block whose backward runs: autograd runs a CUDA graph's backward, a
# remat's recompute included, on a thread of its own
_BACKWARD = {"block": 0}


def _block() -> int:
    return getattr(_LOCAL, "block", _BACKWARD["block"])


@contextlib.contextmanager
def ksplit(model, mesh: MeshShape):
    """Inside, without an ambient mesh: ``model``'s products as ``mesh``
    splits them (its parameters placed by
    ``distributed.sharding.lm_param_specs``), and the decode chain off, as
    under a mesh.  Yields ``uses(block)``: {parameter name: a leaf of its
    own} for each parameter that a product of that data block's pass reads
    through its transpose (the tied head, under grad), so that its
    gradient there is kept apart from the parameter's other uses."""
    from repro_torch.distributed.sharding import lm_param_specs
    cfg = model.cfg
    params = dict(model.named_parameters())
    specs = lm_param_specs(_param_shapes(cfg), cfg, mesh)
    spec_of = {id(p): tuple(specs.get(n, ())) + (None,) * (2 - p.ndim) for n, p in params.items()}
    name_of = {id(p): n for n, p in params.items()}
    uses: dict = {}

    def parallel_matmul(x, w, policy, kind, site=None, *, w_spec=None, w_full=None):
        base = w._base if w._base is not None and id(w._base) in name_of else None
        if base is not None and w.stride() == base.stride()[::-1]:
            # w = a parameter's transpose (the tied head; an expert block of
            # a bank is a view of it too, not a transpose)
            name, mine = name_of[id(base)], uses.setdefault(_block(), {})
            if name not in mine:
                mine[name] = base.detach().requires_grad_(base.requires_grad)
            spec, w = spec_of[id(base)][::-1], mine[name].T
        else:
            spec = spec_of.get(id(w), (None, None))
        if kind in ("column", "row") and sf.engages(policy.resolve(site)) \
                and sf.matmul_supported(kind, spec):
            return _SplitMatmul.apply(x.to(torch.float32), w.to(torch.float32), policy, site,
                                      kind, mesh.model_size)
        return ops.policy_matmul(x, w, policy, site)

    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import scheduler
    banks = moe_mod.expert_banks

    def expert_banks(ew, buf, cfg, policy):
        """The banks in the mesh's blocks of experts, one a "model" rank."""
        n = mesh.model_size
        if spec_of.get(id(ew["wu"].w), (None,))[0] != "model" or n == 1:
            return banks(ew, buf, cfg, policy)
        blocks = [{k: moe_mod._Bank(lin.w.chunk(n, 0)[i]) for k, lin in ew.items()}
                  for i in range(n)]
        return torch.cat([banks(b, x, cfg, policy) for b, x in zip(blocks, buf.chunk(n, 0))])

    was = os.environ.get("REPRO_DECODE_FUSED")
    os.environ["REPRO_DECODE_FUSED"] = "0"
    try:
        with single_device(), _patched(sf, "parallel_matmul", parallel_matmul), \
                _patched(moe_mod, "expert_banks", expert_banks), \
                _patched(scheduler, "make_paged_serve_step",
                         _paged_step_by_data_block(scheduler.make_paged_serve_step,
                                                   mesh.data_size)):
            yield lambda block: uses.get(block, {})
    finally:
        if was is None:
            del os.environ["REPRO_DECODE_FUSED"]
        else:
            os.environ["REPRO_DECODE_FUSED"] = was


class _Lockstep:
    """``run(fn)`` runs fn(0), ..., fn(n - 1) in a thread each, one thread
    at a time: a thread runs until it calls ``exchange``, then hands on to
    the next, and each exchange returns every thread's value once all have
    given theirs (an all-gather over the blocks, in block order)."""

    def __init__(self, n: int):
        self.n, self.turn, self.failed, self.active = n, 0, False, False
        self.cond = threading.Condition()
        self.rounds: dict = {}
        self.count = [0] * n

    def _hand_on(self, d: int):
        self.turn = (d + 1) % self.n
        self.cond.notify_all()

    def exchange(self, value):
        d = _block()
        with self.cond:
            r = self.count[d]
            self.count[d] += 1
            pool = self.rounds.setdefault(r, [None] * self.n)
            pool[d] = value
            self._hand_on(d)
            self.cond.wait_for(lambda: self.failed or (
                all(v is not None for v in pool) and self.turn == d))
            if self.failed:
                raise RuntimeError("another data block of the oracle failed")
            return list(pool)

    def run(self, fn) -> list:
        out, errors = [None] * self.n, []

        def body(d):
            _LOCAL.block = d
            with self.cond:
                self.cond.wait_for(lambda: self.failed or self.turn == d)
            try:
                if not self.failed:
                    out[d] = fn(d)
            except BaseException as e:      # noqa: BLE001 - re-raised in the caller
                errors.append(e)
                with self.cond:
                    self.failed = True
                    self.cond.notify_all()
            finally:
                with self.cond:
                    self._hand_on(d)
        threads = [threading.Thread(target=body, args=(d,)) for d in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


def _routing_in_lockstep(lockstep: _Lockstep, first_of: list):
    """``moe.whole_routing`` for the oracle's blocks: each MoE layer's
    choices and router probabilities exchanged between the blocks (the
    other blocks' probabilities as constants), kept per (block, layer) for
    a remat's recompute in the backward."""
    kept: dict = {}

    def whole_routing(probs, sel, layer=None):
        d = _block()
        if lockstep.active:
            parts = kept[d, layer] = lockstep.exchange((probs.detach(), sel))
        else:           # a remat's recompute (the backward): the forward's exchange
            parts = kept[d, layer]
            if not torch.equal(parts[d][1], sel):
                raise RuntimeError("a recompute routed unlike its forward")
        probs_all = torch.cat([probs if i == d else p for i, (p, _) in enumerate(parts)])
        return probs_all, torch.cat([s for _, s in parts]), first_of[d]

    return whole_routing


def _paged_step_by_data_block(make, D: int):
    """``scheduler.make_paged_serve_step`` whose steps run each of the ``D``
    data blocks of the slots in turn (when ``D`` divides them, as a mesh
    splits them), in lockstep, each MoE layer's routing exchanged, writing
    each block's pages in the shared pools; the outputs concatenated."""
    from repro_torch.models import moe as moe_mod

    def make_blocked(model, policy, window=None):
        step = make(model, policy, window)

        def blocked(tokens, live, start, ptab, caches):
            if D == 1 or tokens.shape[0] % D:
                return step(tokens, live, start, ptab, caches)
            n = tokens.shape[0] // D
            lockstep = _Lockstep(D)
            routing = _routing_in_lockstep(lockstep, [d * n * tokens.shape[1]
                                                      for d in range(D)])

            def block(d):
                rows = slice(d * n, (d + 1) * n)
                return step(tokens[rows], live[rows], start[rows], ptab[rows], caches)

            with _patched(moe_mod, "whole_routing", routing):
                lockstep.active = True
                outs = lockstep.run(block)
            return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
                    outs[-1][2])
        return blocked
    return make_blocked


def ksplit_loss_and_grads(model, batch: dict, policy: Numerics, mesh: MeshShape):
    """(loss, {parameter name: gradient}) that a ``lm_loss`` step (an
    encoder-decoder's ``encdec_loss``) on ``mesh`` (each data rank holding
    its rows of ``batch``) gives, gathered, computed under ``ksplit`` from
    the whole parameters and batch on ``model``'s device."""
    from repro_torch.models import encdec as ed
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    encdec = model.cfg.family == "encdec"
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    count = torch.sum(batch["labels"] >= 0).to(torch.float32)
    D = mesh.data_size
    sums, losses = [None] * D, [None] * D
    rows = [{k: v.chunk(D, 0)[d] for k, v in batch.items()} for d in range(D)]
    tokens = [r["labels"].numel() for r in rows]
    first_of = [sum(tokens[:d]) for d in range(D)]
    lockstep = _Lockstep(D)

    def label_xent(logits, labels):
        total, _ = tf.xent_sum(logits, labels)
        sums[_block()] = total.detach()
        return total / torch.clamp(count, min=1)

    def block_loss(d):
        loss_fn = ed.encdec_loss if encdec else tf.lm_loss
        loss, metrics = loss_fn(model, rows[d], policy)
        losses[d] = loss
        return metrics

    grads, apart = {}, {}
    with ksplit(model, mesh) as uses, _patched(tf, "label_xent", label_xent), \
            _patched(ed, "label_xent", label_xent), \
            _patched(moe_mod, "whole_routing", _routing_in_lockstep(lockstep, first_of)):
        lockstep.active = True
        metrics = lockstep.run(block_loss)
        lockstep.active = False
        for d in range(D):
            _BACKWARD["block"] = d
            extra = {n: t for n, t in uses(d).items() if t.requires_grad}
            got = torch.autograd.grad(losses[d], list(params.values()) + list(extra.values()))
            for into, names, gs in ((grads, params, got[:len(params)]),
                                    (apart, extra, got[len(params):])):
                for n, g in zip(names, gs):
                    into[n] = g if n not in into else into[n] + g
        _BACKWARD["block"] = 0
    for n, g in apart.items():
        grads[n] = grads[n] + g
    loss = _ordered(sums) / torch.clamp(count, min=1)
    if not encdec:
        loss = loss + 0.01 * metrics[0]["aux"]
    return loss, grads
