"""Whisper-style encoder-decoder transformer: the port of
``repro.models.encdec``.

The conv audio frontend is a stub, as there: the encoder takes
precomputed frame embeddings (B, F, d_model).  Encoder: bidirectional
self-attention with rope, the FFN, ``enc_norm``.  Decoder: causal
self-attention over a ring KV cache, then cross-attention into the encoder
states (``causal=False``, no rope: K/V projected from the encoder states
again at every call, as in JAX, which keeps no cross-attention cache),
then the FFN, ``final_norm`` and the head at site "head".  Every GEMM and
both attention contractions route through the policy: the GEMM kernel and
the attention kernel (bidirectional in the encoder and the cross-attention)
under an ``amsim`` leaf.  The decoder is gelu, so a decode step runs per op
(the decode chain is swiglu-only, in both packages).

Layers run in a Python loop (JAX scans over stacked layer parameters);
``train=True`` runs with grad, each block under ``torch.utils.checkpoint``
when ``cfg.remat``.  Parameter names follow JAX's tree with layers
unstacked: ``enc_layers.<i>.{attn,ffn,n1,n2}``,
``dec_layers.<i>.{self,cross,ffn,n1,n2,n3}``, ``embed``, ``enc_norm``,
``final_norm``, ``head``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import NumericsPolicy
from repro_torch.device import resolve_device
from .attention import attention, init_attention, init_cache
from .layers import Embedding, Linear, Norm, embed, init_linear, linear, rmsnorm
from .mlp import ffn, init_ffn
from .transformer import label_xent

# The serving entry points' answer to an encoder-decoder arch, the JAX
# package's (launch/serve.py): no serving engine takes one, in either package.
ENGINE_REFUSAL = "use examples/whisper-style driver for encdec"


def _layer(tree: dict) -> nn.ModuleDict:
    """A layer's modules: attention and FFN projections as ``Linear``s, norms
    as ``Norm``s."""
    return nn.ModuleDict({
        k: Norm(**v) if k.startswith("n") else
        nn.ModuleDict({n: Linear(**lp) for n, lp in v.items()})
        for k, v in tree.items()})


class EncDec(nn.Module):
    """An encoder-decoder built from a JAX-layout tree of tensors
    (``init_tree``, or ``convert.encdec_params_from_jax``)."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(**tree["embed"], tied=False)
        self.enc_layers = nn.ModuleList(_layer(lp) for lp in tree["enc_layers"])
        self.dec_layers = nn.ModuleList(_layer(lp) for lp in tree["dec_layers"])
        self.enc_norm = Norm(**tree["enc_norm"])
        self.final_norm = Norm(**tree["final_norm"])
        self.head = Linear(**tree["head"])


def encdec_param_shapes(cfg: ArchConfig) -> dict:
    """{dotted name: shape} of the JAX-layout tree of ``cfg``, layers
    unstacked, computed without allocating it."""
    d, dh, F = cfg.d_model, cfg.head_dim, cfg.d_ff
    hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    ffn_dims = {"wg": (d, F), "wu": (d, F), "wd": (F, d)}
    ffn_names = ("wg", "wu", "wd") if cfg.act == "swiglu" else ("wu", "wd")

    def layer(pre, attns, norms):
        shapes = {}
        for a in attns:
            for name, shape in (("wq", (d, hq)), ("wk", (d, hkv)), ("wv", (d, hkv)),
                                ("wo", (hq, d))):
                shapes[f"{pre}{a}.{name}.w"] = shape
                if cfg.qkv_bias and name != "wo":
                    shapes[f"{pre}{a}.{name}.b"] = (shape[1],)
        shapes.update({f"{pre}ffn.{n}.w": ffn_dims[n] for n in ffn_names})
        shapes.update({f"{pre}{n}.g": (d,) for n in norms})
        return shapes

    shapes = {"embed.emb": (cfg.vocab, d)}
    for i in range(cfg.n_enc_layers):
        shapes.update(layer(f"enc_layers.{i}.", ("attn",), ("n1", "n2")))
    for i in range(cfg.n_layers):
        shapes.update(layer(f"dec_layers.{i}.", ("self", "cross"), ("n1", "n2", "n3")))
    shapes.update({"enc_norm.g": (d,), "final_norm.g": (d,), "head.w": (d, cfg.vocab)})
    return shapes


def encdec_stacks(cfg: ArchConfig) -> dict:
    """{JAX leaf name: [port names, layer by layer]}: the per-layer tensors
    that the JAX package stacks into one leaf (``enc_layers.<i>.attn.wq.w``
    for every i is its ``enc_layers.attn.wq.w``)."""
    stacks: dict = {}
    for name in encdec_param_shapes(cfg):
        top, _, rest = name.partition(".")
        if top in ("enc_layers", "dec_layers"):
            stacks.setdefault(f"{top}.{rest.partition('.')[2]}", []).append(name)
    return stacks


def init_tree(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """JAX-layout parameters on the generator's device, at the JAX
    package's scales: N(0, 1/d_in) weights, N(0, 0.02^2) embeddings, unit
    norm scales."""
    g, dev = generator, generator.device
    ones = lambda: {"g": torch.ones((cfg.d_model,), device=dev)}  # noqa: E731

    def enc_layer():
        return {"attn": init_attention(cfg, generator=g),
                "ffn": init_ffn(cfg.d_model, cfg.d_ff, cfg.act, generator=g),
                "n1": ones(), "n2": ones()}

    def dec_layer():
        return {"self": init_attention(cfg, generator=g),
                "cross": init_attention(cfg, generator=g),
                "ffn": init_ffn(cfg.d_model, cfg.d_ff, cfg.act, generator=g),
                "n1": ones(), "n2": ones(), "n3": ones()}

    return {"embed": {"emb": torch.randn((cfg.vocab, cfg.d_model), generator=g, device=dev)
                      * 0.02},
            "enc_layers": [enc_layer() for _ in range(cfg.n_enc_layers)],
            "dec_layers": [dec_layer() for _ in range(cfg.n_layers)],
            "enc_norm": ones(), "final_norm": ones(),
            "head": init_linear(cfg.d_model, cfg.vocab, generator=g)}


def init_encdec(cfg: ArchConfig, *, generator: torch.Generator | None = None,
                device=None) -> EncDec:
    """Random parameters drawn from ``generator`` (default: seed 0 on the
    CPU) on its device, then moved to ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    return EncDec(cfg, init_tree(cfg, generator)).to(device)


# ---------------------------------------------------------------- forward
def _enc_block(p: nn.ModuleDict, x, cfg: ArchConfig, policy: NumericsPolicy):
    a, _ = attention(p["attn"], rmsnorm(p["n1"], x, cfg.norm_eps), cfg, policy, causal=False)
    x = x + a
    return x + ffn(p["ffn"], rmsnorm(p["n2"], x, cfg.norm_eps), policy, cfg.act)


def encode(model: EncDec, frames: torch.Tensor, policy: NumericsPolicy,
           train: bool = False) -> torch.Tensor:
    """frames (B, F, d) precomputed embeddings -> encoder states (B, F, d)."""
    cfg = model.cfg
    with torch.set_grad_enabled(train):
        x = frames.to(torch.float32)
        for layer in model.enc_layers:
            if train and cfg.remat:
                x = checkpoint(_enc_block, layer, x, cfg, policy, use_reentrant=False)
            else:
                x = _enc_block(layer, x, cfg, policy)
        return rmsnorm(model.enc_norm, x, cfg.norm_eps)


def _dec_block(p: nn.ModuleDict, x, enc_out, cfg: ArchConfig, policy: NumericsPolicy, cache):
    a, cache = attention(p["self"], rmsnorm(p["n1"], x, cfg.norm_eps), cfg, policy,
                         cache=cache)
    x = x + a
    c, _ = attention(p["cross"], rmsnorm(p["n2"], x, cfg.norm_eps), cfg, policy,
                     kv_src=enc_out, causal=False, use_rope=False)
    x = x + c
    return x + ffn(p["ffn"], rmsnorm(p["n3"], x, cfg.norm_eps), policy, cfg.act), cache


def decode(model: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor,
           policy: NumericsPolicy, *, caches=None, train: bool = False):
    """tokens (B, S) -> (logits (B, S, vocab), caches or None).  ``caches``
    (``init_encdec_caches``: a ring a decoder layer) are updated in place."""
    cfg = model.cfg
    with torch.set_grad_enabled(train):
        x = embed(model.embed, tokens)
        new_caches = []
        for i, layer in enumerate(model.dec_layers):
            cache = None if caches is None else caches[i]
            if train and cfg.remat and cache is None:
                x, cache = checkpoint(_dec_block, layer, x, enc_out, cfg, policy, None,
                                      use_reentrant=False)
            else:
                x, cache = _dec_block(layer, x, enc_out, cfg, policy, cache)
            new_caches.append(cache)
        x = rmsnorm(model.final_norm, x, cfg.norm_eps)
        logits = linear(model.head, x, policy, site="head")
    return logits, (new_caches if caches is not None else None)


def encdec_loss(model: EncDec, batch: dict, policy: NumericsPolicy):
    """batch {"embeds": (B, F, d) frames, "tokens", "labels": (B, S) (-1 =
    no loss)} -> (mean token cross-entropy, {"xent"})."""
    enc = encode(model, batch["embeds"], policy, train=True)
    logits, _ = decode(model, batch["tokens"], enc, policy, train=True)
    loss = label_xent(logits, batch["labels"])
    return loss, {"xent": loss}


def init_encdec_caches(cfg: ArchConfig, batch: int, max_len: int, device) -> list:
    """The decoder's self-attention caches: a ring of ``max_len`` slots a
    layer."""
    return [init_cache(cfg, batch, max_len, device) for _ in range(cfg.n_layers)]


# ---------------------------------------------------------------- serving
def serve_step(model: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor, caches,
               policy: NumericsPolicy):
    """One greedy step (the JAX package's encdec decode cell): tokens (B, S)
    through ``decode`` with the caches, then the argmax of the last
    position.  Returns (logits (B, 1, vocab) of that position, next token
    (B, 1) int32, caches)."""
    logits, caches = decode(model, tokens, enc_out, policy, caches=caches)
    last = logits[:, -1:]
    return last, torch.argmax(last, dim=-1).to(torch.int32), caches


def greedy(model: EncDec, frames: torch.Tensor, prompts: torch.Tensor, new_tokens: int,
           policy: NumericsPolicy):
    """``encode`` the frames once, then ``serve_step`` over the prompt and
    once a new token, with rings of prompt + new_tokens slots.  Returns
    (encoder states, tokens (B, new_tokens) int32, the logits that chose
    them (B, new_tokens, vocab))."""
    B, P = prompts.shape
    enc = encode(model, frames, policy)
    caches = init_encdec_caches(model.cfg, B, P + new_tokens, frames.device)
    logits, nxt, caches = serve_step(model, prompts, enc, caches, policy)
    toks, kept = [nxt], [logits]
    for _ in range(new_tokens - 1):
        logits, nxt, caches = serve_step(model, nxt, enc, caches, policy)
        toks.append(nxt)
        kept.append(logits)
    return enc, torch.cat(toks, dim=1), torch.cat(kept, dim=1)
