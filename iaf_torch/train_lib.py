"""Evaluation driver (``iaf_tpu/train_lib.py — evaluate``).

``evaluate`` scores a split with the k-sample importance-weighted bound on
the Polyak (EMA) weights of the newest checkpoint in ``cfg.logdir`` (an
``iaf_tpu`` checkpoint; the port's use the same keys), or on the
caller's model, and returns bits/dim. Progress-file resume, ``eval_loop``
and training come with later slices of the port.
"""

from __future__ import annotations

import math
import os
import re
from typing import Mapping

import numpy as np
import torch

from iaf_torch.bridge import load_jax_checkpoint
from iaf_torch.core.config import Config
from iaf_torch.core.device import resolve_device
from iaf_torch.core.rng import fold
from iaf_torch.data.datasets import load_dataset
from iaf_torch.models.cvae import CVAE
from iaf_torch.parallel.eval_step import make_eval_step

LOG2 = math.log(2.0)


def latest_checkpoint(logdir: str) -> str | None:
    if not os.path.isdir(logdir):
        return None
    ckpts = sorted(p for p in os.listdir(logdir)
                   if re.fullmatch(r"ckpt-\d+\.npz", p))
    return os.path.join(logdir, ckpts[-1]) if ckpts else None


def _model(cfg: Config, params, use_ema: bool, device) -> CVAE:
    if isinstance(params, CVAE):
        if params.h_top.device != device:
            raise ValueError(f"model is on {params.h_top.device}, "
                             f"eval device is {device}")
        return params
    if params is None:
        latest = latest_checkpoint(cfg.logdir)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint in {cfg.logdir}")
        params = load_jax_checkpoint(latest, use_ema=use_ema)
    if not isinstance(params, Mapping):
        raise TypeError("params must be a CVAE, a state_dict or None")
    model = CVAE(cfg, device=device)
    model.load_state_dict(params)
    return model


def evaluate(cfg: Config, mode: str = "eval_test", params=None,
             use_ema: bool = True, k: int | None = None,
             max_batches: int | None = None, device="cuda") -> float:
    """Importance-weighted eval of the ``eval_train``/``eval_test`` split.
    The tail remainder is padded to the batch shape (repeating its first
    row) and only its real rows count. Returns bits/dim."""
    if mode not in ("eval_train", "eval_test"):
        raise ValueError(f"mode {mode!r} not in ('eval_train', 'eval_test')")
    if cfg.likelihood != "dlogistic" or cfg.binarize:
        raise NotImplementedError("the MNIST family is not ported yet")
    dev = resolve_device(device)
    k = cfg.eval_k if k is None else k
    model = _model(cfg, params, use_ema, dev)
    ds, _ = load_dataset(cfg.dataset, cfg.data_dir, cfg.image_size,
                         cfg.channels)
    images = ds.train_x if mode == "eval_train" else ds.test_x
    eval_fn = make_eval_step(cfg, dev, k=k)
    key = cfg.seed + 999

    bs = cfg.eval_batch_size
    n_full = len(images) // bs
    tail = len(images) - n_full * bs
    n_batches = n_full
    if max_batches is not None:
        # the tail counts as one batch, reached only by a cap beyond the
        # full batches
        n_batches = min(n_full, max_batches)
        if max_batches <= n_full:
            tail = 0
    total_nats, total_n = 0.0, 0
    for i in range(n_batches):
        nats = eval_fn(model, fold(key, i), images[i * bs:(i + 1) * bs])
        total_nats += float(torch.sum(nats))
        total_n += bs
    if tail:
        rem = images[n_full * bs:]
        pad = np.concatenate([rem] + [rem[:1]] * (bs - tail))[:bs]
        nats = eval_fn(model, fold(key, n_full), pad)
        total_nats += float(torch.sum(nats[:tail]))
        total_n += tail
    nats_mean = total_nats / max(total_n, 1)
    bits_per_dim = nats_mean / (LOG2 * cfg.num_pixels)
    print(f"[{mode}] k={k} n={total_n} nats {nats_mean:.2f} "
          f"bits/dim {bits_per_dim:.4f}")
    return bits_per_dim
