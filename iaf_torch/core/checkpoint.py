"""Checkpoint / resume (``iaf_tpu/core/checkpoint.py``): numpy ``.npz`` files.

The whole ``{step, params, opt: {step, m, u, ema}, rng}`` tree is written
as one ``.npz`` with ``//``-joined keys, atomically (a temporary file, then
a rename), keeping the newest ``keep``; under a process group by rank 0
alone. The keys and layouts are JAX's
(``train_lib.state_to_tree`` converts), so either package resumes the
other's checkpoints.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np

from iaf_torch.parallel import mesh

_SEP = "//"
_CKPT = re.compile(r"ckpt-\d+\.npz")


def flatten_pytree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_pytree(v, f"{prefix}{_SEP}{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_pytree(v, f"{prefix}{_SEP}{i}" if prefix
                                      else str(i)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def unflatten_pytree(flat: dict[str, np.ndarray]) -> Any:
    root: dict = {}
    for key, val in flat.items():
        node = root
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _checkpoints(logdir: str) -> list[str]:
    return sorted(p for p in os.listdir(logdir) if _CKPT.fullmatch(p))


def save(logdir: str, step: int, tree: Any, keep: int = 5) -> str:
    """Write ``ckpt-<step>.npz`` atomically; ``keep`` retains only the
    newest N checkpoints (0 keeps everything). Under a process group
    (``parallel/mesh.py``) every rank calls it, rank 0 alone writes and
    prunes (the others may pass ``tree=None``), and a barrier on each
    side keeps the ranks together, as the JAX package's ``save``."""
    path = os.path.join(logdir, f"ckpt-{step:09d}.npz")
    mesh.barrier(f"ckpt_pre_{step}")
    if mesh.rank() == 0:
        os.makedirs(logdir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **flatten_pytree(tree))
        os.rename(tmp, path)
        if keep:
            for old in _checkpoints(logdir)[:-keep]:
                os.remove(os.path.join(logdir, old))
    mesh.barrier(f"ckpt_post_{step}")
    return path


def latest_checkpoint(logdir: str) -> str | None:
    """Newest complete checkpoint in ``logdir``, or None."""
    if not os.path.isdir(logdir):
        return None
    ckpts = _checkpoints(logdir)
    return os.path.join(logdir, ckpts[-1]) if ckpts else None


def restore(path: str) -> Any:
    with np.load(path) as f:
        return unflatten_pytree({k: f[k] for k in f.files})


class CheckpointLoader:
    """Polls a logdir for new checkpoints, so that a separate eval process
    can follow a live training run."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._seen: str | None = None

    def maybe_load(self) -> tuple[str, Any] | None:
        path = latest_checkpoint(self.logdir)
        if path is None or path == self._seen:
            return None
        self._seen = path
        return path, restore(path)
