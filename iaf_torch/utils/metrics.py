"""Metrics: one JSON row per logged step in ``metrics.jsonl`` (or the file
named), with the keys of ``iaf_tpu/utils/metrics.py``, and image tiles
under ``images/`` (``log_image``, ``img_tile``); with ``tensorboard`` the
scalars, per-layer vectors and tiles are mirrored into TensorBoard event
files under ``<logdir>/tb``."""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch


def _value(v: Any):
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    try:
        arr = np.asarray(v)
        if arr.size == 1:   # scalar, or a shape-(1, ...) wrapper
            return float(arr.reshape(()))
        return [round(float(e), 6) for e in arr.ravel()]  # per-layer KL
    except (TypeError, ValueError):
        return str(v)


class MetricsLogger:
    """Appends rows to ``<logdir>/<filename>``. A logger made with
    ``enabled=False`` (every rank but 0 of a process group, as in the JAX
    package) opens no file and writes nothing. With ``tensorboard`` each
    row's scalars (and each per-layer vector as ``<key>/<i>``) and each
    image also go to a ``torch.utils.tensorboard`` writer on
    ``<logdir>/tb``, imported only then; where it does not import, one
    line says so and the logger goes on without it."""

    def __init__(self, logdir: str, filename: str = "metrics.jsonl",
                 enabled: bool = True, tensorboard: bool = False):
        self.path = os.path.join(logdir, filename)
        self.enabled = enabled
        self._f = self._tb = None
        if enabled:
            os.makedirs(logdir, exist_ok=True)
            self._f = open(self.path, "a", buffering=1)
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(log_dir=os.path.join(logdir,
                                                                  "tb"))
                except ImportError as e:
                    print(f"[metrics] tensorboard writer unavailable: {e}")
        self._t0 = time.time()

    def log(self, step: int, **metrics: Any) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        rec.update({k: _value(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is None:
            return
        for k, v in rec.items():
            if k in ("step", "wall"):
                continue
            if isinstance(v, float):
                self._tb.add_scalar(k, v, rec["step"])
            elif isinstance(v, list):       # per-layer vectors
                for i, e in enumerate(v):
                    self._tb.add_scalar(f"{k}/{i}", e, rec["step"])

    def log_image(self, tag: str, image, step: int) -> None:
        """An HWC uint8 tile as ``images/<tag>_<step:08d>.npy`` beside the
        metrics file, and a ``.png`` of it when PIL imports (the npy is
        the authoritative file)."""
        if not self.enabled:
            return
        image = np.asarray(image)
        img_dir = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(img_dir, exist_ok=True)
        stem = os.path.join(img_dir, f"{tag}_{step:08d}")
        np.save(stem + ".npy", image)
        if self._tb is not None:
            self._tb.add_image(tag, image, step, dataformats="HWC")
        try:
            from PIL import Image
        except ImportError:
            return
        Image.fromarray(image[..., 0] if image.shape[-1] == 1
                        else image).save(stem + ".png")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


def img_stretch(images) -> np.ndarray:
    """Float images stretched to [0, 1] over the whole batch."""
    images = np.asarray(images, np.float32)
    lo, hi = images.min(), images.max()
    return (images - lo) / max(hi - lo, 1e-12)


def img_tile(images, pad: int = 1) -> np.ndarray:
    """[N, H, W, C] images as one square grid image, ``pad`` zero pixels
    between tiles, row-major."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    side = int(np.ceil(np.sqrt(n)))
    grid = np.zeros((side * (h + pad) - pad, side * (w + pad) - pad, c),
                    images.dtype)
    for i in range(n):
        r, col = divmod(i, side)
        grid[r * (h + pad):r * (h + pad) + h,
             col * (w + pad):col * (w + pad) + w] = images[i]
    return grid
