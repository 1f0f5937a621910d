"""Checkpoints: an atomic npz store of a tree of tensors and a keep-K
manager, the port of ``repro.checkpoint.store``.

A tree is nested dicts and lists of tensors and Python ints (a model's
parameters, an optimizer state with its step); each leaf is saved as a
numpy array under its "/"-joined path.  Every leaf carries a CRC32 in the
``__meta__`` JSON (``__crc__``) that loading checks, so a truncated or
bit-rotted file raises :class:`CheckpointCorruptError` instead of
restoring garbage.  A write goes to a temporary file and then
``os.replace``, so a crash mid-write leaves the previous checkpoint
whole.  ``CheckpointManager.restore_latest`` walks back past corrupt
files and raises only when every one is corrupt.
"""
from __future__ import annotations

import json
import os
import re
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file is unreadable or failed CRC verification."""


def _flatten(tree, prefix="") -> dict:
    """{path: leaf} of a nested dict/list tree, paths "/"-joined."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for key, sub in items:
        out.update(_flatten(sub, f"{prefix}{key}/"))
    return out


def _unflatten_like(like, leaves: dict, prefix=""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaves, f"{prefix}{i}/") for i, v in enumerate(like))
    return leaves[prefix[:-1]]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, leaf):
    """``arr`` as the kind of leaf ``leaf`` is: a tensor of its dtype on
    its device, or a Python number."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    return type(leaf)(arr.item())


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def save_tree(path: str | os.PathLike, tree, extra: dict | None = None):
    """Save ``tree`` to ``path`` atomically, every leaf's CRC32 in
    ``__meta__`` beside ``extra``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    meta = dict(extra or {})
    meta["__crc__"] = {k: _leaf_crc(v) for k, v in flat.items()}
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_tree(path: str | os.PathLike, like, *, verify: bool = True):
    """(tree of ``like``'s structure, meta): each leaf from the file, as a
    tensor of the like leaf's dtype on its device (or a Python number).
    With ``verify`` every leaf's CRC32 is checked; a mismatch or any read
    failure raises :class:`CheckpointCorruptError`.  A file without CRCs
    loads unchecked."""
    want = _flatten(like)
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z else None
            crcs = (meta or {}).pop("__crc__", None)
            leaves = {}
            for key in want:
                arr = z[key]
                if verify and crcs is not None and (crcs.get(key) is None
                                                    or _leaf_crc(arr) != crcs[key]):
                    raise CheckpointCorruptError(f"{path}: CRC mismatch on leaf {key!r}")
                leaves[key] = arr
    except CheckpointCorruptError:
        raise
    except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile,
            json.JSONDecodeError) as e:
        # np.load raises BadZipFile on a truncated file, KeyError on a
        # missing leaf, ValueError on a garbled member.
        raise CheckpointCorruptError(f"{path}: unreadable ({e!r})") from e
    tree = _unflatten_like(like, {k: _like(a, want[k]) for k, a in leaves.items()})
    return tree, meta


class CheckpointManager:
    """step-NNNNNNNN.npz files under a directory; the newest ``keep`` kept."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3, log_fn=print):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.log_fn = log_fn

    def _steps(self) -> list[int]:
        steps = []
        for f in self.dir.glob("step-*.npz"):
            m = re.fullmatch(r"step-(\d+)\.npz", f.name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def path(self, step: int) -> Path:
        return self.dir / f"step-{step:08d}.npz"

    def latest_step(self):
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree, extra: dict | None = None):
        save_tree(self.path(step), tree, extra={"step": step, **(extra or {})})
        for s in self._steps()[:-self.keep]:
            self.path(s).unlink(missing_ok=True)

    def restore_latest(self, like):
        """(tree, meta) of the newest checkpoint that verifies, walking back
        past corrupt ones; (None, None) when the directory holds none;
        :class:`CheckpointCorruptError` when every one is corrupt."""
        steps = self._steps()
        if not steps:
            return None, None
        for step in reversed(steps):
            try:
                tree, meta = load_tree(self.path(step), like)
            except CheckpointCorruptError as e:
                self.log_fn(f"[checkpoint] {e}; falling back to the previous checkpoint")
                continue
            return tree, (meta or {"step": step})
        raise CheckpointCorruptError(
            f"{self.dir}: all {len(steps)} checkpoints failed verification")
