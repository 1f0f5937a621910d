"""Deterministic synthetic data: the port of the JAX package's
``data/pipeline.py``.

LM batches are step-indexed: ``lm_batch(cfg, shape, step)`` is a pure
function of the step, so a run resumed from a checkpoint at step N sees
the batches N, N+1, ... of the run it continues.  Vision data is class
prototypes plus gaussian noise, so the paper's models see learnable
images without a dataset download.  Vision seeds come from a CRC32 of the
dataset key, so the data is the same in every process (Python's
``hash()`` of a tuple is salted per process).  Vision arrays are numpy,
NHWC in [0, 1]; callers move batches to their device.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


# ---------------------------------------------------------------- LM side
def lm_batch(cfg: ArchConfig, shape: tuple[int, int], step: int, device="cpu") -> dict:
    """The synthetic next-token batch of global step ``step``: shape (B, S)
    -> {"tokens", "labels"} int64 (B, text length) on ``device``, the labels
    the tokens shifted left with -1 (no loss) last.  Tokens mix the JAX
    package's way: uniform ids, each replaced with probability 1/2 by its
    left neighbour (the row rolled by one), so the loss is learnable.  The
    draw comes from a ``torch.Generator`` seeded from (1234, step) (JAX's
    threefry stream cannot be matched).

    With frontend tokens (``cfg.n_frontend_tokens`` = F) the batch also
    holds "embeds", (B, F, d_model) standard normals from the same
    generator.  An encdec's frames feed the encoder and the decoder keeps
    all S positions as text; a decoder-only frontend takes F of the S
    positions, so its text is S - F tokens."""
    B, S = shape
    F = cfg.n_frontend_tokens
    text_len = S if cfg.family == "encdec" or not F else S - F
    gen = torch.Generator().manual_seed(1234 * 2 ** 32 + int(step))
    base = torch.randint(0, cfg.vocab, (B, text_len), generator=gen)
    mix = torch.rand((B, text_len), generator=gen) < 0.5
    tokens = torch.where(mix, torch.roll(base, 1, dims=1) % cfg.vocab, base)
    labels = torch.cat([tokens[:, 1:], torch.full((B, 1), -1, dtype=tokens.dtype)], dim=1)
    batch = {"tokens": tokens.to(device), "labels": labels.to(device)}
    if F:
        batch["embeds"] = torch.randn((B, F, cfg.d_model), generator=gen).to(device)
    return batch


# ------------------------------------------------------------ vision side


def _key_seed(name, hw, ch, n_classes, seed) -> int:
    return zlib.crc32(f"{name}|{hw}|{ch}|{n_classes}|{seed}".encode())


def vision_dataset(name: str, n_train: int, n_test: int, hw: int, ch: int,
                   n_classes: int, noise: float = 0.35, seed: int = 0):
    """Synthetic learnable image dataset: class prototypes + gaussian noise.

    Returns {x_train, y_train, x_test, y_test}, NHWC float32 in [0, 1];
    deterministic in (name, shape, seed).
    """
    base = _key_seed(name, hw, ch, n_classes, seed)
    rng = np.random.default_rng(base)
    protos = rng.uniform(0, 1, (n_classes, hw, hw, ch)).astype(np.float32)
    # low-pass the prototypes so they have learnable spatial structure
    for _ in range(2):
        protos = (protos + np.roll(protos, 1, 1) + np.roll(protos, 1, 2)) / 3

    def make(n, salt):
        r = np.random.default_rng((base + salt) % (2**32))
        y = r.integers(0, n_classes, n).astype(np.int32)
        x = protos[y] + r.normal(0, noise, (n, hw, hw, ch)).astype(np.float32)
        return np.clip(x, 0, 1).astype(np.float32), y

    x_train, y_train = make(n_train, 1)
    x_test, y_test = make(n_test, 2)
    return {"x_train": x_train, "y_train": y_train,
            "x_test": x_test, "y_test": y_test}


def vision_batches(data, batch: int, epoch: int, seed: int = 0):
    """Deterministic epoch shuffling; yields {"x", "y"} numpy batches."""
    n = data["x_train"].shape[0]
    order = np.random.default_rng(seed + epoch).permutation(n)
    for i in range(0, n - batch + 1, batch):
        idx = order[i:i + batch]
        yield {"x": data["x_train"][idx], "y": data["y_train"][idx]}
