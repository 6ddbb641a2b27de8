"""Training and evaluation drivers (``iaf_tpu/train_lib.py``).

``train`` runs the training loop with the JAX package's key discipline,
cadences and checkpoints (same ``.npz`` keys, so either package resumes
the other's runs). ``evaluate`` scores a split with the k-sample
importance-weighted bound on the Polyak (EMA) weights of the newest
checkpoint in ``cfg.logdir``, or on the caller's model, and returns
bits/dim. Progress-file resume, ``eval_loop``, image summaries, the
prefetch thread and TensorBoard come with later slices of the port.
"""

from __future__ import annotations

import math
import time
from typing import Iterator, Mapping

import numpy as np
import torch

from iaf_torch.bridge import from_jax_params, load_jax_checkpoint, \
    to_jax_params
from iaf_torch.core import checkpoint as ckpt
from iaf_torch.core.checkpoint import latest_checkpoint
from iaf_torch.core.config import Config, save_hparams
from iaf_torch.core.device import full_f32, resolve_device
from iaf_torch.core.rng import fold
from iaf_torch.data import feed
from iaf_torch.data.datasets import load_dataset
from iaf_torch.models.cvae import CVAE
from iaf_torch.optim import AdamaxState
from iaf_torch.parallel import train_step as ts
from iaf_torch.parallel.eval_step import make_eval_step
from iaf_torch.utils.metrics import MetricsLogger
from iaf_torch.utils.params import describe

LOG2 = math.log(2.0)
_INIT_FOLD = 0x0001A51A      # the param-init key: fold(base key, this)


def key_to_words(key: int) -> np.ndarray:
    """A port key (63-bit int) as JAX's uint32[2] key words; the base key
    ``seed`` gives ``[0, seed]``, which is ``jax.random.PRNGKey(seed)``."""
    return np.array([key >> 32, key & 0xFFFFFFFF], dtype=np.uint32)


def words_to_key(words) -> int:
    hi, lo = (int(w) for w in np.asarray(words, dtype=np.uint32))
    return (hi << 32) | lo


def state_to_tree(step: int, state: ts.TrainState, rng: int) -> dict:
    """The checkpoint tree, in JAX's keys and layouts (stacked blocks)."""
    opt = state.opt
    return {
        "step": np.asarray(step),
        "params": to_jax_params(state.params.state_dict()),
        "opt": {"step": np.asarray(int(opt.step), dtype=np.int32),
                "m": to_jax_params(opt.m), "u": to_jax_params(opt.u),
                "ema": to_jax_params(opt.ema)},
        "rng": key_to_words(rng),
    }


def tree_to_state(tree: dict, cfg: Config, device
                  ) -> tuple[int, ts.TrainState, int]:
    """(step, state on ``device``, base key) from a checkpoint tree."""
    dev = torch.device(device)
    model = CVAE(cfg, device=dev)
    model.load_state_dict(from_jax_params(tree["params"]))

    def leaves(sub):
        return {k: v.to(dev) for k, v in from_jax_params(sub).items()}

    opt = AdamaxState(
        step=torch.tensor(int(tree["opt"]["step"]), dtype=torch.int32,
                          device=dev),
        m=leaves(tree["opt"]["m"]), u=leaves(tree["opt"]["u"]),
        ema=leaves(tree["opt"]["ema"]))
    return int(tree["step"]), ts.TrainState(model, opt), \
        words_to_key(tree["rng"])


def _config_line(cfg: Config, dev: torch.device) -> None:
    """The ``[config]`` line of a run: a recipe other than the reference's
    f32, or the f32 recipe on the card run in full f32 (``full_f32``: TF32
    off for cuDNN's convs and for matmuls)."""
    if full_f32(cfg.compute_dtype, dev):
        print("[config] compute_dtype=float32 on the card: TF32 off for "
              "cuDNN convs and matmuls, as the reference recipe computes")
    elif cfg.compute_dtype != "float32":
        print(f"[config] compute_dtype={cfg.compute_dtype} (reference "
              "recipe: float32 — pin compute_dtype=float32 to reproduce "
              "it exactly)")


def train(cfg: Config, max_steps: int | None = None,
          data_iter: Iterator[np.ndarray] | None = None,
          device="cuda") -> ts.TrainState:
    """The training loop on one device (the card unless ``device`` is
    "cpu"). Returns the final state."""
    if cfg.likelihood != "dlogistic" or cfg.binarize:
        raise NotImplementedError("the MNIST family is not ported yet")
    dev = resolve_device(device)
    logger = MetricsLogger(cfg.logdir)
    save_hparams(cfg, cfg.logdir)
    _config_line(cfg, dev)

    # restore before the data iterator, so that the data order continues
    # where the checkpointed run left it
    start_step, restored = 0, None
    latest = latest_checkpoint(cfg.logdir)
    if latest is not None:
        start_step, restored, restored_key = tree_to_state(
            ckpt.restore(latest), cfg, dev)
        print(f"[train] restored {latest} at step {start_step}")

    ds = None
    if data_iter is None:
        ds, is_real = load_dataset(cfg.dataset, cfg.data_dir, cfg.image_size,
                                   cfg.channels)
        if not is_real and cfg.dataset != "synthetic":
            print(f"[train] dataset {cfg.dataset!r} unavailable -> synthetic")
        data_iter = feed.batch_iterator(ds.train_x, cfg.batch_size, cfg.seed,
                                        start_step=start_step)
    base_key = cfg.seed

    # heartbeat eval on the Polyak (EMA) weights
    eval_fn = eval_images = ema_model = None
    if cfg.eval_every > 0:
        if ds is None:
            ds, _ = load_dataset(cfg.dataset, cfg.data_dir, cfg.image_size,
                                 cfg.channels)
        eval_images = ds.test_x[:cfg.eval_batch_size]
        eval_fn = make_eval_step(cfg, dev, k=min(cfg.eval_k, 64))
        ema_model = CVAE(cfg, device=dev)
        if cfg.image_summaries:
            print("[train] image summaries skipped: sampling is not ported "
                  "yet")

    first = next(data_iter)
    if restored is not None:
        state, base_key = restored, restored_key
    else:
        state = ts.init_train_state(cfg, fold(base_key, _INIT_FOLD), first,
                                    dev)
        print(f"[train] {describe(state.params)}")

    total = cfg.total_steps if max_steps is None else max_steps
    t_last, steps_since = time.time(), 0
    step = start_step
    try:
        while step < total:
            batch = first if first is not None else next(data_iter)
            first = None
            state, metrics = ts.train_step(cfg, state, fold(base_key, step),
                                           batch)
            step += 1
            steps_since += 1

            if cfg.fail_after_step and step == cfg.fail_after_step:
                raise RuntimeError(f"fault injection: crash at step {step}")

            if step % cfg.log_every == 0 or step == total:
                loss = float(metrics["loss"])   # waits for the step
                dt = time.time() - t_last
                sps = steps_since / dt if dt > 0 else 0.0
                logger.log(step, steps_per_sec=sps,
                           examples_per_sec=sps * cfg.batch_size, **metrics)
                print(f"[train] step {step} loss {loss:.2f} bits/dim "
                      f"{float(metrics['bits_per_dim']):.4f} "
                      f"{sps:.3f} steps/s")
                t_last, steps_since = time.time(), 0

            if eval_fn is not None and step % cfg.eval_every == 0:
                with torch.no_grad():
                    for k, p in ema_model.named_parameters():
                        p.copy_(state.opt.ema[k])
                nats = eval_fn(ema_model, fold(base_key, 2**31 + step),
                               eval_images)
                logger.log(step, eval_bits_per_dim=float(nats.mean())
                           / (LOG2 * cfg.num_pixels))

            if step % cfg.ckpt_every == 0 or step == total:
                ckpt.save(cfg.logdir, step,
                          state_to_tree(step, state, base_key),
                          keep=cfg.ckpt_keep)
    finally:
        logger.close()
    return state


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
    _config_line(cfg, dev)
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
