"""Decoder-only LM, dense, MoE, SSM and hybrid families: the port of
``repro.models.transformer``.

Every GEMM (projections, attention score/value, FFN, router, experts, the
SSD einsums, LM head) routes through the NumericsPolicy.  The stack is a
plain loop over layers (the JAX package scans over stacked layer
parameters).  The hybrid (zamba2) runs its Mamba2 layers with one
weight-shared dense block after every ``cfg.attn_every``-th layer, each
application with its own KV cache.  A single-token decode step of a
dense block under one ``amsim`` or ``amsim_torch`` leaf runs as the decode
chain (``_dense_block_fused_decode``): the CUDA chain kernels, or their
plain versions, in the same structure, so the two modes decode bit for
bit alike.  ``lm_forward(..., train=True)`` runs with grad enabled (each
block of a dense, MoE or SSM stack under ``torch.utils.checkpoint`` when
``cfg.remat``; the hybrid stack without, as in JAX) and ``lm_loss`` is the
training loss: token cross-entropy plus the MoE load-balance loss, which
every block hands up the stack.  A decoder-only LM with a frontend (llava)
takes its precomputed patch embeddings before the text
(``lm_forward(embeds=)``); ``lm_loss`` crops those positions.  A llama4
stack (``moe.interleave == 2``) is a loop over (dense, MoE) pairs, JAX's
scan block: each pair is one ``PairLayer`` (one checkpointed block under
remat, as ``jax.checkpoint(block)``), its caches a tuple (the dense
layers' rings, the MoE layers' rings), one a pair in each.

Under an ambient mesh (``launch/mesh.py``; parameters placed by
``distributed/sharding.py``) every family runs tensor- and data-parallel:
each rank its batch rows, and of a dense block its heads and FFN columns,
the products through ``distributed/shard_fused``; an MoE block routes the
whole batch and runs its rank's experts (``models/moe.py``); a Mamba2
layer runs its projections by the replicated dispatch and its conv and
constants gathered, its cache's heads and channels over "model"
(``models/ssm.py``); the hybrid's shared block runs the dense sharded path,
its weights wrapped once a forward (``shard_fused.data_summed_once``), so
that the gradients of its applications add up in the single-device order
before the data sum.  The logits are gathered over "model" and the loss is
the mean over every data rank's rows, from each rank's sum and count.  The
decode chain stays off (as JAX's), except under ``REPRO_SHARD_FUSED=0``,
where it runs on the layer's gathered weights (an MoE layer's banks too),
heads and cache.  ``check_mesh_family`` raises for what still waits:
llama4's pairs, a head count that "model" does not divide, FSDP.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import NumericsPolicy
from repro_torch.device import resolve_device
from repro_torch.distributed import shard_fused as sf
from repro_torch.distributed.sharding import gather_tensor
from repro_torch.kernels import ops
from repro_torch.kernels.decode_chain import rmsnorm_lanes
from repro_torch.launch.mesh import current_mesh
from .attention import attention, cache_dtype, init_attention, init_cache
from .layers import Embedding, Linear, Norm, embed, init_linear, linear, rmsnorm, unembed
from .mlp import ffn, init_ffn
from .moe import init_moe, moe_ffn
from .ssm import SSMLayer, init_mamba2, init_ssm_cache, mamba2, mamba2_shapes


def _linears(tree: dict) -> nn.ModuleDict:
    return nn.ModuleDict({k: Linear(**v) for k, v in tree.items()})


class DenseLayer(nn.Module):
    """One block: ``attn`` (wq/wk/wv/wo), norms ``n1``/``n2``, and ``ffn``
    (wg/wu/wd) or, in an MoE layer, ``moe`` (``router``, the ``experts``
    banks wg/wu/wd and, llama4-style, the ``shared`` FFN wg/wu/wd)."""

    def __init__(self, attn: dict, n1: dict, n2: dict, ffn: dict | None = None,
                 moe: dict | None = None):
        super().__init__()
        self.attn = _linears(attn)
        self.n1 = Norm(**n1)
        self.n2 = Norm(**n2)
        self.ffn = None if ffn is None else _linears(ffn)
        self.moe = None if moe is None else nn.ModuleDict(
            {k: Linear(**v) if k == "router" else _linears(v) for k, v in moe.items()})


class PairLayer(nn.Module):
    """A llama4 scan block: ``dense`` (a ``DenseLayer`` with ``ffn``), then
    ``moe_layer`` (a ``DenseLayer`` with ``moe``), JAX's names."""

    def __init__(self, dense: dict, moe_layer: dict):
        super().__init__()
        self.dense = DenseLayer(**dense)
        self.moe_layer = DenseLayer(**moe_layer)


def paired(cfg: ArchConfig) -> bool:
    """Whether the stack is (dense, MoE) pairs: an MoE FFN every second
    layer."""
    return cfg.moe is not None and cfg.moe.interleave == 2


class LM(nn.Module):
    """A decoder-only LM built from a JAX-layout tree of tensors
    (``init_tree``, or ``convert.lm_params_from_jax``); parameter names
    follow the JAX pytree with layers unstacked (``layers.<i>.attn.wq.w``,
    ``layers.<i>.moe.experts.wg.w``, ``layers.<i>.mamba.conv_w``; a llama4
    pair's ``layers.<i>.dense.attn.wq.w``, ``layers.<i>.moe_layer.moe.shared.wg.w``);
    the hybrid's shared block is ``shared_attn``, one ``DenseLayer``."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(**tree["embed"], tied=cfg.tie_embeddings)
        self.final_norm = Norm(**tree["final_norm"])
        layer = (SSMLayer if cfg.ssm is not None else PairLayer if paired(cfg)
                 else DenseLayer)
        self.layers = nn.ModuleList(layer(**lp) for lp in tree["layers"])
        self.head = None if cfg.tie_embeddings else Linear(**tree["head"])
        self.shared_attn = DenseLayer(**tree["shared_attn"]) if cfg.attn_every else None


def _dense_layer_shapes(cfg: ArchConfig, pre: str, use_moe: bool) -> dict:
    """{dotted name: shape} of one dense (``use_moe`` False) or MoE layer
    under prefix ``pre``."""
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    ffn_names = ("wg", "wu", "wd") if cfg.act == "swiglu" else ("wu", "wd")

    def ffn_shapes(prefix, F, *E):
        dims = {"wg": (*E, d, F), "wu": (*E, d, F), "wd": (*E, F, d)}
        return {f"{prefix}.{name}.w": dims[name] for name in ffn_names}

    shapes = {}
    for name, shape in (("wq", (d, hq)), ("wk", (d, hkv)), ("wv", (d, hkv)), ("wo", (hq, d))):
        shapes[f"{pre}attn.{name}.w"] = shape
        if cfg.qkv_bias and name != "wo":
            shapes[f"{pre}attn.{name}.b"] = (shape[1],)
    shapes[f"{pre}n1.g"] = (d,)
    shapes[f"{pre}n2.g"] = (d,)
    if not use_moe:
        return {**shapes, **ffn_shapes(f"{pre}ffn", cfg.d_ff)}
    m = cfg.moe
    shapes[f"{pre}moe.router.w"] = (d, m.n_experts)
    shapes.update(ffn_shapes(f"{pre}moe.experts", m.d_ff, m.n_experts))
    if m.n_shared_experts:
        shapes.update(ffn_shapes(f"{pre}moe.shared", m.d_ff * m.n_shared_experts))
    return shapes


def lm_param_shapes(cfg: ArchConfig) -> dict:
    """{dotted name: shape} of the JAX-layout tree of ``cfg``, layers
    unstacked, computed without allocating it."""
    d = cfg.d_model
    shapes = {"embed.emb": (cfg.vocab, d), "final_norm.g": (d,)}
    if not cfg.tie_embeddings:
        shapes["head.w"] = (d, cfg.vocab)
    if paired(cfg):
        for i in range(cfg.n_layers // 2):
            shapes.update(_dense_layer_shapes(cfg, f"layers.{i}.dense.", False))
            shapes.update(_dense_layer_shapes(cfg, f"layers.{i}.moe_layer.", True))
        return shapes
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        if cfg.ssm is None:
            shapes.update(_dense_layer_shapes(cfg, pre, cfg.moe is not None))
        else:
            shapes.update({f"{pre}mamba.{k}": v for k, v in mamba2_shapes(cfg).items()})
            shapes[f"{pre}n1.g"] = (d,)
    if cfg.attn_every:
        shapes.update(_dense_layer_shapes(cfg, "shared_attn.", False))
    return shapes


def lm_stacks(cfg: ArchConfig) -> dict:
    """{JAX leaf name: [port names, layer by layer]}: the per-layer tensors
    of ``lm_param_shapes`` that the JAX package stacks into one leaf
    (``layers.<i>.attn.wq.w`` for every i is its ``layers.attn.wq.w``; a
    pair's ``layers.<i>.dense.attn.wq.w`` its ``layers.dense.attn.wq.w``)."""
    stacks: dict = {}
    for name in lm_param_shapes(cfg):
        if name.startswith("layers."):
            _, _, rest = name.split(".", 2)
            stacks.setdefault(f"layers.{rest}", []).append(name)
    return stacks


def init_tree(cfg: ArchConfig, generator: torch.Generator, cut=None) -> dict:
    """JAX-layout parameters on the generator's device, with the JAX
    package's scales: N(0, 1/d_in) weights, N(0, 0.02^2) embeddings, unit
    norm scales, and the Mamba2 constants of ``ssm.init_mamba2``.
    ``cut(prefix, part)``, when given, takes each part as it is drawn (the
    embedding, the head, a layer) and returns what the tree keeps of it: a
    rank's blocks, so that no rank holds the whole model at once."""
    g, dev = generator, generator.device
    cut = (lambda prefix, part: part) if cut is None else cut
    ones = lambda: {"g": torch.ones((cfg.d_model,), device=dev)}  # noqa: E731
    tree = {"embed": cut("embed", {"emb": torch.randn((cfg.vocab, cfg.d_model), generator=g,
                                                       device=dev) * 0.02}),
            "final_norm": ones()}
    if not cfg.tie_embeddings:
        tree["head"] = cut("head", init_linear(cfg.d_model, cfg.vocab, generator=g))

    def dense_layer(use_moe=cfg.moe is not None):
        layer = {"attn": init_attention(cfg, generator=g), "n1": ones(), "n2": ones()}
        if use_moe:
            layer["moe"] = init_moe(cfg, generator=g)
        else:
            layer["ffn"] = init_ffn(cfg.d_model, cfg.d_ff, cfg.act, generator=g)
        return layer

    if paired(cfg):
        tree["layers"] = [cut(f"layers.{i}", {"dense": dense_layer(False),
                                               "moe_layer": dense_layer(True)})
                          for i in range(cfg.n_layers // 2)]
    elif cfg.ssm is None:
        tree["layers"] = [cut(f"layers.{i}", dense_layer()) for i in range(cfg.n_layers)]
    else:
        tree["layers"] = [cut(f"layers.{i}", {"mamba": init_mamba2(cfg, generator=g),
                                               "n1": ones()})
                          for i in range(cfg.n_layers)]
    if cfg.attn_every:
        tree["shared_attn"] = cut("shared_attn", dense_layer(False))
    return tree


def init_lm(cfg: ArchConfig, *, generator: torch.Generator | None = None, device=None,
            mesh=None) -> LM:
    """Random parameters drawn from ``generator`` (default: seed 0 on the
    CPU) on its device, then moved to ``device`` (default: the CUDA card).
    A generator on the card draws a full-size model there directly.  With
    a ``mesh`` (``launch/mesh.py``) this rank keeps its blocks under
    ``lm_param_specs``, each part cut as soon as it is drawn: every rank
    draws the same stream, so its blocks are bitwise the slices of the
    single-device model's tensors."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    if mesh is None:
        return LM(cfg, init_tree(cfg, generator)).to(device)
    from repro_torch.distributed.sharding import cut_part, lm_param_specs, tag_specs
    check_mesh_family(cfg, mesh)
    specs = lm_param_specs(lm_param_shapes(cfg), cfg, mesh)
    tree = init_tree(cfg, generator, cut=lambda prefix, part: cut_part(prefix, part, specs, mesh))
    return tag_specs(LM(cfg, tree).to(device), specs)


# ---------------------------------------------------------------- blocks
def _use_fused_decode_chain(x, cfg: ArchConfig, policy: NumericsPolicy, cache) -> bool:
    """Single-token swiglu decode under one chain leaf (every chain and
    attention site ``amsim``, or every one ``amsim_torch``)."""
    return (cache is not None and x.shape[1] == 1 and cfg.act == "swiglu"
            and ops.decode_chain_enabled(policy))


def _dense_block_fused_decode(p: DenseLayer, x, cfg: ArchConfig, policy: NumericsPolicy,
                              cache, window: int):
    """One decode step of a block as the chain: fused norm+qkv, then for a
    dense block either the attention core folded into the back-half launch
    (a ring, or a paged table of pages x page size, of at most
    ``ops.FUSE_ATTN_MAX_T`` slots: 2 launches) or
    attention and the back half apart (3 launches); for an MoE block
    attention, then wo+residual+norm (emitting x1 and h) and ``moe_ffn`` on
    h.  Rope and the cache write stay in ``attention``."""
    B, S, d = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x2 = x.reshape(B * S, d)
    at = p.attn
    q2, k2, v2 = ops.decode_qkv(x2, p.n1.g, at["wq"].w, at["wk"].w, at["wv"].w, policy,
                                cfg.norm_eps)
    if at["wq"].b is not None:
        q2, k2, v2 = q2 + at["wq"].b, k2 + at["wk"].b, v2 + at["wv"].b
    qkv = (q2.reshape(B, S, H, dh), k2.reshape(B, S, KV, dh), v2.reshape(B, S, KV, dh))
    T = (cache["ptab"].shape[1] * cache["pool_k"].shape[1] if "ptab" in cache
         else cache["k"].shape[1])
    if p.moe is None and ops.decode_fuse_attn_enabled(policy, T):
        mlp = p.ffn
        (qr, kr, vr, qp, kp), cache = attention(at, x, cfg, policy, cache=cache, window=window,
                                                qkv=qkv, capture_attend=True)
        y = ops.decode_attn_out_mlp(x2, qr, kr, vr, qp, kp, p.n2.g, at["wo"].w, mlp["wg"].w,
                                    mlp["wu"].w, mlp["wd"].w, at["wo"].b, mlp["wd"].b, policy,
                                    cfg.norm_eps, True, window)
        return y.reshape(B, S, d), cache, 0.0
    a2, cache = attention(at, x, cfg, policy, cache=cache, window=window, qkv=qkv,
                          project_out=False)
    a2 = a2.reshape(B * S, H * dh)
    if p.moe is not None:
        x1, h = ops.decode_wo_norm(x2, a2, p.n2.g, at["wo"].w, at["wo"].b, policy, cfg.norm_eps)
        y, aux = moe_ffn(p.moe, h.reshape(B, S, d), cfg, policy)
        return x1.reshape(B, S, d) + y, cache, aux
    mlp = p.ffn
    y = ops.decode_out_mlp_b(x2, a2, p.n2.g, at["wo"].w, mlp["wg"].w, mlp["wu"].w, mlp["wd"].w,
                             at["wo"].b, mlp["wd"].b, policy, cfg.norm_eps)
    return y.reshape(B, S, d), cache, 0.0


def _block_norm(policy: NumericsPolicy, cache):
    """The rmsnorm of the block norms and the final norm: in a serving
    forward (a cache) under a chain leaf, the chain's
    (``decode_chain.rmsnorm_lanes``, the warp order of its kernels, row by
    row whatever the rows), so that a prefill, a per-op decode step and the
    chain give the same bits and recomputing a preempted request reproduces
    its tokens; else ``layers.rmsnorm``.  Here the port departs from JAX,
    whose prefill normalises in ``jnp.mean``'s order: such a prefill's
    logits may differ from JAX's in the last bit (its tokens are held to
    JAX's in ``tests/test_torch_scheduler.py``)."""
    if cache is not None and ops.chain_leaf_ok(ops.decode_chain_leaf(policy)):
        return lambda p, x, eps: rmsnorm_lanes(x, p.g, eps)
    return rmsnorm


class _View:
    """A layer's tensors, each mapped by ``fn`` (``.w``, ``.b``, ``.g`` and
    the ``attn``/``ffn``/``moe``/``n1``/``n2`` members a block reads; a
    ``ModuleDict`` as a dict)."""

    def __init__(self, module, fn):
        for name, child in module.named_children():
            setattr(self, name, _view_of(child, fn))
        for name, t in module.named_parameters(recurse=False):
            setattr(self, name, fn(t))
        if isinstance(module, Linear) and module.b is None:
            self.b = None
        if isinstance(module, DenseLayer):
            self.ffn = None if module.ffn is None else self.ffn
            self.moe = None if module.moe is None else self.moe


def _view_of(module, fn):
    if isinstance(module, nn.ModuleDict):
        return {k: _view_of(v, fn) for k, v in module.items()}
    return _View(module, fn)


def _whole(layer, mesh) -> _View:
    """A layer's tensors put back together over the mesh."""
    return _View(layer, lambda t: gather_tensor(t.detach(), sf.spec_of(t), mesh))


_CACHE_HEADS = ("k", "v", "pool_k", "pool_v")    # a ring's or a paged pool's KV (dim 2)


def _chain_on_whole_layer(p: DenseLayer, x, cfg: ArchConfig, policy: NumericsPolicy, cache,
                          window: int, mesh):
    """A decode step of the chain under a mesh (REPRO_SHARD_FUSED=0): the
    layer's weights and the cache's heads (a ring's, or a paged pool's)
    gathered over "model", the single-device chain on this rank's rows
    (an MoE layer's routing the whole batch's), this rank's heads written
    back to its cache."""
    heads = sf.spec_of(p.attn["wk"].w)[1] == "model"
    names = [n for n in _CACHE_HEADS if n in cache]
    whole = dict(cache)
    if heads:
        whole.update({n: mesh.all_gather(cache[n], "model", dim=2) for n in names})
    y, whole, aux = _dense_block_fused_decode(_whole(p, mesh), x, cfg, policy, whole, window)
    if heads:
        for n in names:
            cache[n].copy_(mesh.block(whole[n], "model", 2))
    return y, ({**cache, "len": whole["len"]} if "len" in whole else cache), aux


def _dense_block(p: DenseLayer, x, cfg: ArchConfig, policy: NumericsPolicy, cache,
                 window: int):
    """One block: (x, cache, aux), aux the MoE load-balance loss (0 in a
    dense block)."""
    if _use_fused_decode_chain(x, cfg, policy, cache):
        mesh = current_mesh()
        if mesh is not None:
            return _chain_on_whole_layer(p, x, cfg, policy, cache, window, mesh)
        return _dense_block_fused_decode(p, x, cfg, policy, cache, window)
    norm = _block_norm(policy, cache)
    a, cache = attention(p.attn, norm(p.n1, x, cfg.norm_eps), cfg, policy, cache=cache,
                         window=window)
    x = x + a
    h = norm(p.n2, x, cfg.norm_eps)
    if p.moe is not None:
        y, aux = moe_ffn(p.moe, h, cfg, policy)
    else:
        y, aux = ffn(p.ffn, h, policy, cfg.act), 0.0
    return x + y, cache, aux


def _ssm_block(p: SSMLayer, x, cfg: ArchConfig, policy: NumericsPolicy, cache, window: int = 0):
    """One Mamba2 layer: (x, cache, aux 0).  ``window`` is not read (the
    signature of ``_dense_block``).  Its norms take ``layers.rmsnorm``
    (JAX's order) in every forward: the chain-order norm belongs to the
    dense blocks that decode through the chain."""
    y, cache = mamba2(p.mamba, rmsnorm(p.n1, x, cfg.norm_eps), cfg, policy, cache=cache)
    return x + y, cache, 0.0


def _pair_block(p: PairLayer, x, cfg: ArchConfig, policy: NumericsPolicy, cache,
                window: int):
    """A llama4 pair: its dense layer, then its MoE layer; cache (dense
    ring, MoE ring) or None; aux the MoE layer's."""
    c0, c1 = (None, None) if cache is None else cache
    x, c0, a0 = _dense_block(p.dense, x, cfg, policy, c0, window)
    x, c1, a1 = _dense_block(p.moe_layer, x, cfg, policy, c1, window)
    return x, (None if cache is None else (c0, c1)), a0 + a1


def _shared_block(block: DenseLayer):
    """The hybrid's shared block as the stack reads it: itself, or under a
    mesh with grad each parameter wrapped once a forward
    (``shard_fused.data_summed_once``), so that the gradients of its
    applications add up (autograd's order, the single-device one) before
    the one sum over the data axes."""
    if current_mesh() is None or not torch.is_grad_enabled():
        return block
    return _View(block, sf.data_summed_once)


def _hybrid_stack(model: LM, x, policy: NumericsPolicy, caches, window: int):
    """zamba2: the Mamba2 layers in order, the shared block after every
    ``attn_every``-th one (the same weights each time, its own cache each
    time); no remat, as in JAX.  caches: (Mamba2 caches, attention caches)
    or None."""
    cfg = model.cfg
    mcaches, acaches = caches if caches is not None else (None, None)
    new_m, new_a, aux = [], [], 0.0
    shared = _shared_block(model.shared_attn)
    for i, layer in enumerate(model.layers):
        x, cache, _ = _ssm_block(layer, x, cfg, policy, None if mcaches is None else mcaches[i])
        new_m.append(cache)
        if (i + 1) % cfg.attn_every == 0:
            cache = None if acaches is None else acaches[len(new_a)]
            x, cache, a = _dense_block(shared, x, cfg, policy, cache, window)
            new_a.append(cache)
            aux = aux + a
    return x, (None if caches is None else (new_m, new_a)), aux


# ---------------------------------------------------------------- forward
def _final_hidden(model: LM, tokens: torch.Tensor, policy: NumericsPolicy, embeds, caches,
                  window: int, train: bool):
    """The stack's output after the final norm: (x (B, F + S, d), new
    caches or None, aux); ``embeds`` (B, F, d) or None go before the
    tokens' embeddings."""
    cfg = model.cfg
    check_mesh_family(cfg)
    x = embed(model.embed, tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    if cfg.family == "hybrid":
        x, new_caches, aux = _hybrid_stack(model, x, policy, caches, window)
    else:
        block = (_ssm_block if cfg.family == "ssm" else _pair_block if paired(cfg)
                 else _dense_block)
        if caches is not None and paired(cfg):     # (dense rings, MoE rings) -> a pair's two
            caches = list(zip(*caches))
        aux = 0.0
        new_caches = []
        for i, layer in enumerate(model.layers):
            cache = None if caches is None else caches[i]
            if train and cfg.remat and cache is None:
                x, cache, a = checkpoint(block, layer, x, cfg, policy, None, window,
                                         use_reentrant=False)
            else:
                x, cache, a = block(layer, x, cfg, policy, cache, window)
            aux = aux + a
            new_caches.append(cache)
        if caches is not None and paired(cfg):
            new_caches = tuple(map(list, zip(*new_caches)))
    norm = rmsnorm if cfg.family == "ssm" else _block_norm(policy, caches)
    x = norm(model.final_norm, x, cfg.norm_eps)
    if not isinstance(aux, torch.Tensor):   # no MoE block: no aux loss
        aux = x.new_zeros((), dtype=torch.float32)
    return x, (new_caches if caches is not None else None), aux


def check_mesh_family(cfg: ArchConfig, mesh=None):
    """Raise under ``mesh`` (default: the ambient one) for what the port
    does not run on a mesh yet: llama4's (dense, MoE) pairs (no check
    holds them against the k-split oracle yet), attention heads (query or
    KV), experts, or Mamba2 heads and conv channels that the "model" axis
    does not divide (a rank holds whole ones), and FSDP (``cfg.fsdp``)."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or mesh.size == 1:
        return
    M = mesh.model_size
    if paired(cfg):
        raise NotImplementedError(f"{cfg.name}: (dense, MoE) pairs on a mesh are a later slice "
                                  f"of the port")
    if cfg.fsdp:
        raise NotImplementedError(f"{cfg.name}: FSDP (cfg.fsdp) is a later slice of the port")
    if cfg.n_heads and (cfg.n_heads % M or cfg.n_kv_heads % M):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_heads} query and {cfg.n_kv_heads} KV heads over a model axis "
            f"of {M}: a rank holds whole heads (a later slice splits a head)")
    if cfg.moe is not None and cfg.moe.n_experts % M:
        raise NotImplementedError(f"{cfg.name}: {cfg.moe.n_experts} experts over a model axis "
                                  f"of {M}: a rank holds whole experts")
    if cfg.ssm is not None:
        shapes = mamba2_shapes(cfg)
        nheads, conv_ch = shapes["A_log"][0], shapes["conv_b"][0]
        if nheads % M or conv_ch % M:
            raise NotImplementedError(f"{cfg.name}: {nheads} Mamba2 heads and {conv_ch} conv "
                                      f"channels over a model axis of {M}: a rank holds whole "
                                      f"ones")


def _lm_head(model: LM, x: torch.Tensor, policy: NumericsPolicy) -> torch.Tensor:
    """The logits over the whole vocab: a column-parallel head's vocab
    blocks are gathered over "model" under a mesh."""
    if model.cfg.tie_embeddings:
        logits = unembed(model.embed, x, policy)
        split = sf.spec_of(model.embed.emb)[0] == "model"
    else:
        logits = linear(model.head, x, policy, site="head", kind="column")
        split = sf.spec_of(model.head.w)[1] == "model"
    mesh = current_mesh()
    return sf.gather(logits, mesh, "model", -1) if mesh is not None and split else logits


def lm_forward(model: LM, tokens: torch.Tensor, policy: NumericsPolicy, *, embeds=None,
               caches=None, window: int | None = None, train: bool = False):
    """tokens (B, S), and optional frontend embeddings ``embeds`` (B, F, d)
    put before them (cast to the embeddings' type, as JAX does) -> (logits
    (B, F + S, vocab), new caches or None, aux loss).

    Serving (``train=False``) runs without grad; ``caches``
    (``init_lm_caches``) are updated in place, the F + S positions of a
    prefill with ``embeds`` written to the ring.  ``train=True`` runs with
    grad, each block under ``torch.utils.checkpoint`` when ``cfg.remat``
    (its activations recomputed in the backward: the same bits, fewer
    held; the hybrid stack never, as in JAX).  ``window`` None means the
    architecture's own sliding window (0 = off).  aux sums the blocks' MoE
    load-balance losses.  The final norm takes the chain's order where the
    stack has dense blocks (``_block_norm``), JAX's in an SSM stack."""
    window = model.cfg.sliding_window if window is None else window
    with torch.set_grad_enabled(train):
        x, new_caches, aux = _final_hidden(model, tokens, policy, embeds, caches, window, train)
        logits = _lm_head(model, x, policy)
    return logits, new_caches, aux


def xent_sum(logits: torch.Tensor, labels: torch.Tensor) -> tuple:
    """(the summed token cross-entropy, the count of labelled tokens) of
    logits (B, S, vocab) at labels (B, S) (-1 = no loss): the label's logit
    by mask and sum, not a gather (a scatter-free backward)."""
    valid = labels >= 0
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    ll = torch.sum(torch.where(iota == labels.clamp(min=0)[..., None], logits, 0.0), dim=-1)
    return torch.sum(torch.where(valid, lse - ll, 0.0)), torch.sum(valid)


def label_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean token cross-entropy (``xent_sum``), as JAX ``lm_loss`` and
    ``encdec_loss`` take it; under a mesh the mean over every data rank's
    rows, from each rank's sum and count."""
    total, count = xent_sum(logits, labels)
    mesh = current_mesh()
    if mesh is not None:
        count = sf.sum_over_data(count.to(torch.float32), mesh)
        return sf.data_total(total) / torch.clamp(count, min=1)
    return total / torch.clamp(count, min=1)


def lm_loss(model: LM, batch: dict, policy: NumericsPolicy, aux_weight: float = 0.01):
    """batch {"tokens": (B, S), "labels": (B, S) (-1 = no loss), optional
    "embeds": (B, F, d)} -> (mean token cross-entropy + aux_weight x the MoE
    aux loss, {"xent", "aux"}), as JAX ``lm_loss``.  The frontend positions
    carry no loss: JAX crops the logits to the labels' length; here the
    final hidden states are cropped before the head, so that the head makes
    no product for those positions.  Each logit row and, since the head's
    backward folds its rows in order from +0.0 and a cropped row only adds
    zeros there, every gradient keep their bits
    (``tests/test_torch_dense_zoo.py``)."""
    with torch.set_grad_enabled(True):
        x, _, aux = _final_hidden(model, batch["tokens"], policy, batch.get("embeds"), None,
                                  model.cfg.sliding_window, True)
        labels = batch["labels"]
        logits = _lm_head(model, x[:, x.shape[1] - labels.shape[1]:], policy)
        loss = label_xent(logits, labels)
    return loss + aux_weight * aux, {"xent": loss, "aux": aux}


def init_lm_caches(cfg: ArchConfig, batch: int, max_len: int, device):
    """The decode caches of the whole stack (the layout ``lm_forward``
    takes): a ring cache a layer (dense, MoE); for (dense, MoE) pairs
    (the dense layers' rings, the MoE layers' rings), one a pair in each,
    as JAX; a Mamba2 state a layer (SSM); for the hybrid (Mamba2 states a
    layer, a ring of min(max_len, sliding window) slots for each application
    of the shared block)."""
    if paired(cfg):
        return tuple([init_cache(cfg, batch, max_len, device) for _ in range(cfg.n_layers // 2)]
                     for _ in range(2))
    if cfg.family == "ssm":
        return [init_ssm_cache(cfg, batch, device) for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        ring = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        return ([init_ssm_cache(cfg, batch, device) for _ in range(cfg.n_layers)],
                [init_cache(cfg, batch, ring, device)
                 for _ in range(cfg.n_layers // cfg.attn_every)])
    return [init_cache(cfg, batch, max_len, device) for _ in range(cfg.n_layers)]


def check_paged(cfg: ArchConfig):
    """Raise unless paged serving caches cover ``cfg``'s family (JAX
    ``init_paged_lm_caches``): dense stacks and MoE stacks with an MoE FFN
    in every layer, whose decode state is attention KV; an SSM or hybrid
    state is O(1) a slot and needs no paging, and JAX pages no stack of
    (dense, MoE) pairs (llama4)."""
    if not (cfg.family == "dense" or (cfg.family == "moe" and cfg.moe.interleave == 1)):
        raise NotImplementedError(
            f"paged serving caches support dense/moe(interleave=1) stacks; {cfg.name} is "
            f"family {cfg.family!r}")


def init_paged_lm_caches(cfg: ArchConfig, n_pages: int, page_size: int, device) -> list:
    """The device state of the paged serving cache: one ``{"pool_k",
    "pool_v"}`` a layer, each (n_pages, page_size, KV, dh) in
    ``cfg.cache_dtype``; page 0 is the trash page (JAX
    ``init_paged_lm_caches``).  The page table, the resident lengths and
    the liveness are host control that the scheduler merges into each
    layer's dict for a step (``serve/scheduler.py``).  Refuses the SSM and
    hybrid families (``check_paged``)."""
    check_paged(cfg)
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    dt = cache_dtype(cfg)
    return [{"pool_k": torch.zeros(shape, dtype=dt, device=device),
             "pool_v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in range(cfg.n_layers)]
