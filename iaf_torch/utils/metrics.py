"""Metrics: one JSON row per logged step in ``metrics.jsonl``, with the
keys of ``iaf_tpu/utils/metrics.py``. TensorBoard mirroring and image
tiles are not ported yet."""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch

FILENAME = "metrics.jsonl"


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
    def __init__(self, logdir: str):
        self.path = os.path.join(logdir, FILENAME)
        os.makedirs(logdir, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        rec.update({k: _value(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
