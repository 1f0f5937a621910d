"""Sharded execution of the LUT kernels over a mesh of ranks: the port of
``repro.distributed.shard_fused``.

The JAX package wraps its kernels in ``shard_map`` and leaves every other
op to GSPMD.  The port has no GSPMD, so each rank holds its blocks
(``distributed/sharding.py``: a parameter's spec is ``param.spec``) and
every collective is placed here, in ``torch.autograd.Function``s:

  * **column-parallel matmul** (wq/wk/wv, wg/wu, the head: output dim over
    "model"): each rank's kernel computes its column block, no forward
    collective.  dx is the partials' ordered sum over "model"; dw the
    ordered sum over the data axes iff the batch is split over them.
  * **row-parallel matmul** (wo, wd: input dim over "model"): each rank's
    kernel contracts its k block, then the ordered sum over "model".  dx
    is shard-local; dw as above.
  * **attention**: KV heads over "model", batch over the data axes; each
    rank runs the one-launch kernel on its block, with no collective.
  * **conv2d**: batch over the data axes, weights replicated; dw the
    ordered sum over the data axes.

Every cross-shard sum is ``Mesh.ordered_sum`` (an all-gather, then the
partials added in rank order), so it is bitwise the k-split oracle: each
shard's slice through the single-device kernel, the partials added in
shard order.  The sharded path engages on an ``amsim`` forward leaf with
``REPRO_SHARD_FUSED`` on (``active_mesh``) and a supported layout; every
other call takes the **replicated dispatch**: the operands gathered over
"model", the single-device op (``ops._matmul_nograd`` /
``ops.policy_attention`` / ``ops.approx_conv2d``), and this rank's block of
the result.  Batch rows are never gathered: a row's output depends on
that row alone, so the data-parallel layout stays and only a weight
gradient is summed over the data axes.  The replicated dispatch's forward
is thus bitwise the single-device op's.  ``REPRO_SHARD_FUSED=0`` sends
everything there, and then the decode chain engages on the gathered
weights (``models/transformer.py``), as JAX's does.

A tensor's layout under a mesh follows the specs alone, whichever path
computes it: a column product's output is column-sharded iff its weight's
output dim is, a row product's output is whole.  Parameters read outside
these products (norm gains, biases, the embedding) go through
``data_parallel``, whose backward sums their gradient over the data axes;
the Mamba2 constants and conv go through ``whole_param`` (gathered at use:
held per weight version without grad).  A weight that a step reads more
than once (the hybrid's shared block) can be wrapped once by
``data_summed_once``: its products then leave its gradient to the wrapper,
which sums every use's local gradient, in autograd's order, over the data
axes once.  A column-split bias's gradient is reduced over the whole
columns (``bias_add``), so that its fold is the unsplit tensor's.
"""
from __future__ import annotations

import weakref

import torch

from repro_torch.core.policy import Numerics, NumericsPolicy
from repro_torch.distributed.sharding import gather_tensor
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, current_mesh

_KINDS = ("column", "row")


def env_enabled() -> bool:
    """The REPRO_SHARD_FUSED kill switch (on unless "0" or "false")."""
    return not ops.switched_off("REPRO_SHARD_FUSED")


def engages(leaf: NumericsPolicy) -> bool:
    """Whether the sharded path may engage on a forward leaf: ``amsim``,
    with the kill switch on."""
    return leaf.mode == "amsim" and not leaf.is_native and env_enabled()


def active_mesh(leaf: NumericsPolicy) -> Mesh | None:
    """The mesh to shard the kernels over, or None when the sharded path
    must not engage (``engages``) or there is no mesh of more than one
    rank."""
    return current_mesh() if engages(leaf) else None


def spec_of(t: torch.Tensor, ndim: int | None = None) -> tuple:
    """A parameter's spec (``param.spec``, set when it was placed), padded
    with None to ``ndim`` entries."""
    spec = tuple(getattr(t, "spec", ()))
    ndim = t.ndim if ndim is None else ndim
    return spec + (None,) * (ndim - len(spec))


def sum_over_data(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ordered sum over the data axes (the batch is split there)."""
    if mesh.data_size > 1:
        return mesh.ordered_sum(t, mesh.data_axes)
    return t


# ----------------------------------------------------- autograd helpers
class _DataParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return sum_over_data(g, ctx.mesh), None


def data_parallel(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a parameter every data rank holds) as it is; its gradient is
    summed over the data axes in rank order under an ambient mesh (unless
    ``data_summed_once`` already wrapped it)."""
    mesh = current_mesh()
    if mesh is None or not t.requires_grad or getattr(t, "data_summed", False):
        return t
    return _DataParallel.apply(t, mesh)


def data_summed_once(t: torch.Tensor) -> torch.Tensor:
    """``t`` wrapped so that every use's local gradient is added up first
    (autograd's order, the single-device one) and the total summed over the
    data axes once; the products that read it then sum nothing over the
    data axes (its ``data_summed`` mark).  Keeps ``t``'s spec."""
    mesh = current_mesh()
    if mesh is None or not t.requires_grad:
        return t
    out = _DataParallel.apply(t, mesh)
    out.spec, out.data_summed = spec_of(t), True
    return out


def _data_sum(w) -> bool:
    """Whether a product's weight gradient is its own to sum over the data
    axes (not a ``data_summed_once`` weight's)."""
    return not getattr(w, "data_summed", False)


def _dw_total(dw, mesh, data_sum: bool):
    return sum_over_data(dw, mesh) if data_sum else dw


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(t, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.block(g, ctx.axes, ctx.dim).contiguous(), None, None, None


def gather(t: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """All-gather of ``t`` along ``dim`` over ``axes``; the backward takes
    this rank's block of the gradient (the consumers of the whole tensor
    run alike on every rank of ``axes``)."""
    return _Gather.apply(t, mesh, axes, dim)


def gather_param(t: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """A tensor of this spec put back together from its blocks
    (differentiable)."""
    for dim, axes in enumerate(spec):
        if axes is not None:
            t = gather(t, mesh, axes, dim)
    return t


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.block(t, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), ctx.axes, dim=ctx.dim), None, None, None


def scatter(t: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` (the same on every rank of ``axes``)
    along ``dim``; the backward gathers every rank's block of the gradient,
    so that each rank holds the whole tensor's (``gather``'s mirror)."""
    return _Scatter.apply(t, mesh, axes, dim)


_WHOLE: dict = {}       # id(parameter) -> ((version, storage), the gathered tensor)


def held_whole(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole of a placed parameter, gathered once per weight version
    (its version counter and storage) and held while it lives: the
    serving steps read it without a collective."""
    key = (t._version, t.data_ptr())
    held = _WHOLE.get(id(t))
    if held is None or held[0] != key:
        if held is None:
            weakref.finalize(t, _WHOLE.pop, id(t), None)
        held = _WHOLE[id(t)] = (key, gather_tensor(t.detach(), spec, mesh))
    return held[1]


def whole_param(t: torch.Tensor) -> torch.Tensor:
    """A parameter read whole outside the products (the Mamba2 conv and
    constants): itself without a mesh; under one, its blocks put back
    together, held per weight version without grad (``held_whole``), or
    gathered differentiably with its gradient summed over the data axes."""
    mesh = current_mesh()
    spec = spec_of(t)
    if mesh is None or all(a is None for a in spec):
        return data_parallel(t)
    if not (torch.is_grad_enabled() and t.requires_grad):
        return held_whole(t, spec, mesh)
    return gather_param(data_parallel(t), mesh, spec)


class _BiasAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, b, mesh, shape, data_sum):
        ctx.mesh, ctx.shape, ctx.data_sum = mesh, shape, data_sum
        return y + b

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        whole = mesh.all_gather(g.contiguous(), "model", dim=-1).sum_to_size(ctx.shape)
        db = mesh.block(whole, "model", -1).contiguous()
        return g, _dw_total(db, mesh, ctx.data_sum), None, None, None


def bias_add(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y + b for a layer's bias.  A bias split over "model" (a column
    product's) reduces its gradient over the whole columns, gathered, and
    keeps its block, so its fold is the unsplit tensor's; every other bias
    is ``data_parallel``."""
    mesh = current_mesh()
    if mesh is None or spec_of(b, 1)[0] != "model" or not torch.is_grad_enabled():
        return y + data_parallel(b)
    whole = (b.shape[0] * mesh.model_size,)
    return _BiasAdd.apply(y, b, mesh, whole, _data_sum(b))


class _SumScalars(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        return sum_over_data(t, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def data_total(t: torch.Tensor) -> torch.Tensor:
    """The ordered sum of ``t`` over the data ranks (each rank's own rows'
    share); its gradient reaches each rank's ``t`` whole."""
    mesh = current_mesh()
    return t if mesh is None else _SumScalars.apply(t, mesh)


# ================================================================= matmul
def matmul_supported(kind: str | None, w_spec) -> bool:
    """Whether x @ w can take the sharded path: a 2-D weight whose
    parallel dim, and no other, is over "model" (its spec, after
    ``_fix_divisibility``, says so)."""
    spec = tuple(w_spec) + (None,) * (2 - len(tuple(w_spec)))
    return (kind == "column" and spec == (None, "model")) or (
        kind == "row" and spec == ("model", None))


def _dw(x, g, leaf):
    """dw = x_flat^T @ g_flat (every batch row folded in), ops'
    weight-gradient formula."""
    return ops._gemm2d(x.reshape(-1, x.shape[-1]).T, g.reshape(-1, g.shape[-1]), leaf)


class _ColumnParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, policy, site, mesh, data_sum=True):
        ctx.save_for_backward(x, w)
        ctx.policy, ctx.site, ctx.mesh, ctx.data_sum = policy, site, mesh, data_sum
        return ops._matmul_nograd(x, w, policy.resolve(site))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:   # the contraction over the split n: partials summed
            part = ops._matmul_nograd(g, w.T, ctx.policy.resolve(ctx.site, pass_="dx"))
            dx = ctx.mesh.ordered_sum(part, "model")
        if ctx.needs_input_grad[1]:
            dw = _dw_total(_dw(x, g, ctx.policy.resolve(ctx.site, pass_="dw")), ctx.mesh,
                           ctx.data_sum)
        return dx, dw, None, None, None, None


class _RowParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, policy, site, mesh, data_sum=True):
        ctx.save_for_backward(x, w)
        ctx.policy, ctx.site, ctx.mesh, ctx.data_sum = policy, site, mesh, data_sum
        return mesh.ordered_sum(ops._matmul_nograd(x, w, policy.resolve(site)), "model")

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:   # w's k rows live here: dx's block is local
            dx = ops._matmul_nograd(g, w.T, ctx.policy.resolve(ctx.site, pass_="dx"))
        if ctx.needs_input_grad[1]:
            dw = _dw_total(_dw(x, g, ctx.policy.resolve(ctx.site, pass_="dw")), ctx.mesh,
                           ctx.data_sum)
        return dx, dw, None, None, None, None


def column_parallel_matmul(x, w, policy: Numerics, mesh: Mesh, site: str | None = None):
    """x (..., m, k) @ w's column block (k, n / model) -> (..., m, n / model)."""
    return _ColumnParallel.apply(x.to(torch.float32), w.to(torch.float32), policy, site, mesh,
                                 _data_sum(w))


def row_parallel_matmul(x, w, policy: Numerics, mesh: Mesh, site: str | None = None):
    """x's k block (..., m, k / model) @ w's row block (k / model, n) ->
    (..., m, n), summed over "model" in rank order."""
    return _RowParallel.apply(x.to(torch.float32), w.to(torch.float32), policy, site, mesh,
                              _data_sum(w))


class _Replicated(torch.autograd.Function):
    """The replicated dispatch of x @ w: x's k gathered when it is split,
    the whole w, the single-device product, this rank's columns of it."""

    @staticmethod
    def forward(ctx, x, w, policy, site, mesh, x_split, w_spec, out_split, w_full, data_sum):
        wf = w_full if w_full is not None else gather_tensor(w, w_spec, mesh)
        xf = mesh.all_gather(x, "model", dim=-1) if x_split else x
        ctx.save_for_backward(xf, wf)
        ctx.policy, ctx.site, ctx.mesh, ctx.data_sum = policy, site, mesh, data_sum
        ctx.x_split, ctx.w_spec, ctx.out_split = x_split, w_spec, out_split
        out = ops._matmul_nograd(xf, wf, policy.resolve(site))
        return mesh.block(out, "model", -1).contiguous() if out_split else out

    @staticmethod
    def backward(ctx, g):
        xf, wf = ctx.saved_tensors
        mesh = ctx.mesh
        g = g.to(torch.float32).contiguous()
        gf = mesh.all_gather(g, "model", dim=-1) if ctx.out_split else g
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ops._matmul_nograd(gf, wf.T, ctx.policy.resolve(ctx.site, pass_="dx"))
            if ctx.x_split:
                dx = mesh.block(dx, "model", -1).contiguous()
        if ctx.needs_input_grad[1]:
            dw = _dw_total(_dw(xf, gf, ctx.policy.resolve(ctx.site, pass_="dw")), mesh,
                           ctx.data_sum)
            for dim, axes in enumerate(ctx.w_spec):
                if axes is not None:
                    dw = mesh.block(dw, axes, dim)
            dw = dw.contiguous()
        return dx, dw, None, None, None, None, None, None, None, None


def replicated_matmul(x, w, policy: Numerics, kind: str | None, mesh: Mesh,
                      site: str | None = None, *, w_spec=None, w_full=None):
    """x @ w by the replicated dispatch.  The layout is the sharded path's:
    x's k is split iff ``kind`` is "row" and w's k is; the output's columns
    are split iff ``kind`` is "column" and w's n is.  ``w_full`` is the
    whole w when the caller holds it (the tied head's gathered table);
    without grad a placed parameter's whole is held per weight version
    (``held_whole``: the SSM projections, whisper's head)."""
    spec = spec_of(w, 2) if w_spec is None else tuple(w_spec)
    x_split = kind == "row" and spec[0] == "model"
    out_split = kind == "column" and spec[1] == "model"
    if (w_full is None and isinstance(w, torch.nn.Parameter) and not torch.is_grad_enabled()
            and any(a is not None for a in spec)):
        w_full = held_whole(w, spec, mesh)
    return _Replicated.apply(x.to(torch.float32), w.to(torch.float32), policy, site, mesh,
                             x_split, spec, out_split, w_full, _data_sum(w))


def parallel_matmul(x, w, policy: Numerics, kind: str | None, site: str | None = None, *,
                    w_spec=None, w_full=None):
    """The model layers' dispatch point.  No ambient mesh: ``policy_matmul``.
    Under a mesh: the column- or row-parallel product when the forward
    leaf is ``amsim``, the kill switch is on and w's spec is the kind's;
    else the replicated dispatch.  ``kind`` is the layer's Megatron role
    ("column", "row" or None), ``site`` its numerics site."""
    mesh = current_mesh()
    if mesh is None:
        return ops.policy_matmul(x, w, policy, site)
    spec = spec_of(w, 2) if w_spec is None else tuple(w_spec)
    if kind in _KINDS and active_mesh(policy.resolve(site)) is not None \
            and matmul_supported(kind, spec):
        fn = column_parallel_matmul if kind == "column" else row_parallel_matmul
        return fn(x, w, policy, mesh, site)
    return replicated_matmul(x, w, policy, kind, mesh, site, w_spec=spec, w_full=w_full)


# ============================================================== attention
def attention_supported(policy: Numerics, mesh: Mesh, q_shape, k_shape) -> bool:
    """Whether the attention kernel runs per shard, for global q (B, S, H,
    dh) and k (B, T, KV, dh): KV heads divide "model" and group whole
    query heads, the batch divides the data axes, and the fused kernel is
    on."""
    B, _, H, _ = q_shape
    KV = k_shape[2]
    if KV % mesh.model_size or H % KV:
        return False
    if B % mesh.data_size:
        return False
    return ops.fused_attention_enabled(policy)


def sharded_attention(q, k, v, q_pos, k_pos, policy: Numerics, *, causal: bool,
                      window: int):
    """The fused kernel on this rank's block: q (B / data, S, H / model,
    dh), k and v (B / data, T, KV / model, dh).  Heads and batch rows are
    parallel in the kernel's grid, and a rank holds whole query groups, so
    forward and backward (its recompute, per rank) are bitwise the
    single-device kernel's; there is no collective."""
    return ops.policy_attention(q, k, v, q_pos, k_pos, policy, causal, window)


def _attend(q, k, v, q_pos, k_pos, policy, causal, window):
    if ops.one_call_attention_enabled(policy):
        return ops.policy_attention(q, k, v, q_pos, k_pos, policy, causal, window)
    return ops.attend_einsum(q, k, v, q_pos, k_pos, policy, causal=causal, window=window)


def parallel_attention(q, k, v, q_pos, k_pos, policy: Numerics, *, causal: bool,
                       window: int, heads_split: bool, mesh: Mesh):
    """Attention of this rank's block under a mesh.  ``heads_split``: q and
    k/v hold this rank's heads over "model" (else every head, and the
    single-device op runs on this rank's rows).  The sharded kernel when
    the sharded path engages and ``attention_supported`` holds for the
    global shapes; else the replicated dispatch, the heads gathered, the
    single-device op, this rank's heads of it."""
    if not heads_split:
        return _attend(q, k, v, q_pos, k_pos, policy, causal, window)
    leaf = ops.attention_fused_leaf(policy)

    def whole(t):
        return (t.shape[0] * mesh.data_size, t.shape[1], t.shape[2] * mesh.model_size,
                t.shape[3])

    if leaf is not None and active_mesh(leaf) is not None \
            and attention_supported(policy, mesh, whole(q), whole(k)):
        return sharded_attention(q, k, v, q_pos, k_pos, policy, causal=causal, window=window)
    qf, kf, vf = (gather(t, mesh, "model", 2) for t in (q, k, v))
    out = _attend(qf, kf, vf, q_pos, k_pos, policy, causal, window)
    return mesh.block(out, "model", 2)


# ================================================================= conv2d
def conv_supported(mesh: Mesh, x_shape) -> bool:
    """Batch-parallel conv: this rank's rows are its block of a batch split
    over the data axes (weights replicated; channels are not split)."""
    return mesh.data_size > 1


class _ShardedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, pads, policy, mesh):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.pads, ctx.policy, ctx.mesh = stride, pads, policy, mesh
        return ops._conv_nograd(x, w, stride, pads, policy.resolve("conv"))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ops._conv_dx(x.shape, w, g, ctx.stride, ctx.pads,
                              ctx.policy.resolve("conv", pass_="dx"))
        if ctx.needs_input_grad[1]:
            dw = sum_over_data(ops._conv_dw(x, w.shape, g, ctx.stride, ctx.pads,
                                        ctx.policy.resolve("conv", pass_="dw")), ctx.mesh)
        return dx, dw, None, None, None, None


def sharded_conv2d(x, w, stride: int, padding, policy: Numerics, mesh: Mesh):
    """NHWC conv of this rank's batch block; forward and dx bitwise the
    single-device kernels, dw bitwise the batch-split oracle."""
    x, w = x.to(torch.float32), w.to(torch.float32)
    pads = ops.conv_pads(x.shape[1], x.shape[2], w.shape[0], w.shape[1], stride, padding)
    return _ShardedConv.apply(x, w, stride, pads, policy, mesh)


def parallel_conv2d(x, w, stride: int, padding, policy: Numerics):
    """The conv dispatch point: ``ops.approx_conv2d`` without a mesh; the
    batch-sharded kernels when the "conv" forward leaf engages the sharded
    path; else the replicated dispatch, which for a conv with replicated
    weights is the single-device op on this rank's rows, its weight
    gradient summed over the data axes."""
    mesh = current_mesh()
    if mesh is None:
        return ops.approx_conv2d(x, w, stride, padding, policy)
    if active_mesh(policy.resolve("conv")) is not None and conv_supported(mesh, x.shape):
        return sharded_conv2d(x, w, stride, padding, policy, mesh)
    return ops.approx_conv2d(x, data_parallel(w), stride, padding, policy)


def describe(mesh: Mesh, policy: Numerics) -> str:
    """The dispatch a run under ``mesh`` takes (the launch drivers' line)."""
    shape = dict(mesh.shape)
    leaf = policy.resolve(None) if hasattr(policy, "resolve") else policy
    if leaf.mode == "amsim" and not leaf.is_native:
        if env_enabled():
            return (f"amsim/{leaf.multiplier}: sharded LUT kernels on mesh {shape} (column/row-"
                    f"parallel GEMMs, heads and batch split attention, experts over \"model\", "
                    f"batch split convs)")
        return (f"amsim/{leaf.multiplier}: REPRO_SHARD_FUSED=0, the replicated dispatch on mesh "
                f"{shape} (operands gathered over \"model\", the single-device kernels; the "
                f"decode chain on the gathered weights)")
    return (f"{'native' if leaf.is_native else f'{leaf.mode}/{leaf.multiplier}'}: the "
            f"replicated dispatch on mesh {shape} (operands gathered over \"model\")")
