"""Batched serving: prefill + greedy decode steps with ring KV caches.

The port of ``repro.serve.engine`` (single device).  ``make_prefill`` and
``make_serve_step`` build the prefill and the one-token decode step;
``ServingEngine`` drives batched greedy generation on top of them
(``python -m repro_torch.serve``).  Under an ``amsim`` policy the prefill
runs the GEMM and attention kernels and every decode step the decode
chain (``models/transformer.py``); the caches are updated in place.  The
caches are the family's (``init_lm_caches``): ring KV caches, Mamba2
states (SSM), or both (hybrid, whose rings hold min(max_len, sliding
window) slots).

Sharded serving (``mesh=``, a ``launch.mesh.Mesh``; the model's
parameters this rank's blocks, ``init_lm(mesh=)``): the prompts are split
over the data axes, each rank's ring caches hold its rows and its KV heads
(``distributed.sharding.cache_specs``), the prefill and decode steps run
inside the mesh through the per-op sharded path, and each step's greedy
tokens are gathered to every rank.  A batch the data axes do not divide
would need sequence-parallel caches: it raises.
"""
from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.core.policy import NumericsPolicy
from repro_torch.models.transformer import LM, init_lm_caches, lm_forward


def _last_argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def make_prefill(model: LM, policy: NumericsPolicy, max_len: int):
    def prefill(tokens, caches):
        """tokens (B, S_prompt) -> (logits (B, S, vocab), next token (B, 1),
        caches).  The prefill runs at the architecture's own window."""
        logits, caches, _ = lm_forward(model, tokens, policy, caches=caches)
        return logits, _last_argmax(logits), caches
    return prefill


def make_serve_step(model: LM, policy: NumericsPolicy, window: int | None = None):
    def serve_step(tokens, caches):
        """One decode step: tokens (B, 1) -> (logits (B, 1, vocab), next
        token (B, 1), caches)."""
        logits, caches, _ = lm_forward(model, tokens, policy, caches=caches, window=window)
        return logits, _last_argmax(logits), caches
    return serve_step


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    """Greedy batched generation over prefill + decode on the model's
    device."""

    def __init__(self, model: LM, policy: NumericsPolicy, max_len: int = 512,
                 window: int | None = None, mesh=None):
        self.model, self.policy, self.max_len = model, policy, max_len
        self.mesh = mesh
        # None -> the architecture's own sliding window (0 = off), the
        # default lm_forward applies; threaded into every decode step.
        self.window = model.cfg.sliding_window if window is None else window
        self.device = model.embed.emb.device
        self.prefill = make_prefill(model, policy, max_len)
        self.step = make_serve_step(model, policy, window=self.window)

    def generate(self, prompts: torch.Tensor, max_new_tokens: int = 32, *,
                 return_logits: bool = False, timings: dict | None = None):
        """prompts (B, S) int -> int32 (B, max_new_tokens).

        Token i is the argmax of the logits at position len(prompt) + i - 1,
        the sequence a full-prefill argmax recomputation gives.  With
        ``return_logits`` also returns those logits, (B, max_new_tokens,
        vocab).  A ``timings`` dict receives ``prefill_s`` and ``decode_s``
        (host clock around work ended by a device synchronise) and
        ``decode_steps``.
        """
        B, S = prompts.shape
        if max_new_tokens <= 0:
            empty = torch.zeros((B, 0), dtype=torch.int32, device=self.device)
            return (empty, empty.float()) if return_logits else empty
        if S + max_new_tokens > self.max_len:
            # The ring would wrap and overwrite the oldest keys, corrupting
            # every token after the wrap.  (S + max_new == max_len is fine:
            # the last generated token is never written back to the cache.)
            raise ValueError(
                f"prompt length {S} + max_new_tokens {max_new_tokens} exceeds the engine's "
                f"max_len {self.max_len}; raise max_len or shorten the request")
        prompts = prompts.to(self.device)
        mesh = self.mesh
        with contextlib.nullcontext() if mesh is None else mesh:
            if mesh is not None:
                prompts, caches = self._mesh_rows(prompts)
            else:
                caches = init_lm_caches(self.model.cfg, B, self.max_len, self.device)
            out = torch.zeros((B, max_new_tokens), dtype=torch.int32, device=self.device)
            kept = []
            if timings is not None:
                _sync(self.device)      # time this call's work only
            t0 = time.perf_counter()
            logits, nxt, caches = self.prefill(prompts, caches)
            if timings is not None:
                _sync(self.device)
                t1 = time.perf_counter()
            out[:, 0:1] = self._whole_batch(nxt)
            kept.append(logits[:, -1:])
            for i in range(1, max_new_tokens):
                logits, nxt, caches = self.step(nxt, caches)
                out[:, i:i + 1] = self._whole_batch(nxt)
                kept.append(logits)
            if timings is not None:
                _sync(self.device)
                timings.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                               decode_steps=max_new_tokens - 1)
            if return_logits:
                return out, self._whole_batch(torch.cat(kept, dim=1))
        return out

    def _mesh_rows(self, prompts: torch.Tensor):
        """This rank's prompt rows and its blocks of the ring caches, placed
        by ``cache_specs``: its rows, and its KV heads over "model"."""
        from repro_torch.distributed.sharding import cache_specs, shard_tree
        mesh, cfg = self.mesh, self.model.cfg
        B = prompts.shape[0]
        if B % mesh.data_size:
            raise NotImplementedError(
                f"a batch of {B} over {mesh.data_size} data ranks: sequence-parallel caches "
                f"(cache_specs' SP layout) are a later slice; serve a batch they divide")
        whole = init_lm_caches(cfg, B, self.max_len, self.device)
        caches = shard_tree(whole, cache_specs(whole, mesh, B), mesh)
        return mesh.block(prompts, mesh.data_axes, 0), caches

    def _whole_batch(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of this rank's rows -> of every row (gathered over the data
        axes under a mesh)."""
        if self.mesh is None:
            return t
        return self.mesh.all_gather(t.contiguous(), self.mesh.data_axes, dim=0)
