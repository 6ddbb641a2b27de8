"""Training, evaluation and serving entry points (``iaf_tpu/train_lib.py``).

``train`` runs the training loop with the JAX package's key discipline,
cadences and checkpoints (same ``.npz`` keys, so either package resumes
the other's runs), with image summaries at the heartbeat eval. It takes
``steps_per_dispatch`` steps per dispatch from a prefetch thread
(``feed.ChunkPrefetcher``) through ``train_step.make_train_chunk``: on
the card a captured CUDA graph of the whole step, replayed.
``evaluate`` scores a split with the k-sample importance-weighted bound
on the Polyak (EMA) weights of the newest checkpoint in ``cfg.logdir``,
or on the caller's model, and returns bits/dim (the MNIST family: NLL in
nats); with ``progress_path`` a killed eval resumes mid-split.
``eval_loop`` follows a training run's checkpoints. ``sample``,
``reconstruct`` and ``invert_check`` serve the newest checkpoint: prior
samples, posterior reconstructions and the AR inversion of the top IAF
step (the CIFAR family's only, as in the JAX package). Each entry point
takes the config's model family (``models.get_model``); with
``cfg.binarize`` the MNIST images are binarized afresh at every training
step and once, at a fixed key, for the evals (``data/feed.py``).
Multi-GPU and TensorBoard come with later slices of the port.
"""

from __future__ import annotations

import json
import math
import os
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
from iaf_torch.models import cvae, get_model
from iaf_torch.optim import AdamaxState
from iaf_torch.parallel import train_step as ts
from iaf_torch.parallel.eval_step import make_eval_step
from iaf_torch.utils.metrics import MetricsLogger, img_tile
from iaf_torch.utils.params import describe, param_device

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
    model = get_model(cfg).Model(cfg, device=dev)
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
    "cpu"), ``cfg.steps_per_dispatch`` steps a dispatch: the loop of
    ``iaf_tpu/train_lib.py``, step i of a chunk keyed fold(base key,
    start + i), each cadence firing when a multiple of it lies in the
    chunk. Returns the final state, whose tensors (on the card the ones
    the step's graph updated) hold the last step's values. With
    ``cfg.binarize`` the batches of the iterator built here are binarized
    by (seed, step); a caller's ``data_iter`` comes binarized already."""
    dev = resolve_device(device)
    family = get_model(cfg)
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
        if cfg.binarize:
            data_iter = feed.binarized_iterator(data_iter, cfg.seed,
                                                start_step=start_step)
    base_key = cfg.seed

    # heartbeat eval on the Polyak (EMA) weights
    eval_fn = eval_images = ema_model = None
    if cfg.eval_every > 0:
        if ds is None:
            ds, _ = load_dataset(cfg.dataset, cfg.data_dir, cfg.image_size,
                                 cfg.channels)
        eval_images = ds.test_x[:cfg.eval_batch_size]
        if cfg.binarize:
            # the training protocol: sampled binarization, at a fixed key
            eval_images = feed.dynamic_binarize(
                eval_images, feed.binarize_rng(cfg.seed, -1))
        eval_fn = make_eval_step(cfg, dev, k=min(cfg.eval_k, 64))
        ema_model = family.Model(cfg, device=dev)

    first = next(data_iter)
    if restored is not None:
        state, base_key = restored, restored_key
    else:
        state = ts.init_train_state(cfg, fold(base_key, _INIT_FOLD), first,
                                    dev)
        print(f"[train] {describe(state.params)}")

    S = max(1, cfg.steps_per_dispatch)
    total = cfg.total_steps if max_steps is None else max_steps
    t_last, steps_since = time.time(), 0
    # at S > 1: (chunk start step, length, stacked device metrics) kept
    # until the log flush, which writes one row per trained step
    pending: list[tuple[int, int, dict]] = []
    step = start_step
    chunk_fn = ts.make_train_chunk(cfg, state)
    # the next chunk's batches are stacked on a thread while the card runs
    prefetch = feed.ChunkPrefetcher(data_iter, S, total,
                                    start_step=start_step,
                                    first_local=first)
    try:
        for n, batches in prefetch:
            state, stacked = chunk_fn(state, base_key, step, batches)
            if S > 1:
                pending.append((step, n, stacked))
            metrics = {k: v[-1] for k, v in stacked.items()}
            step += n
            steps_since += n

            if cfg.fail_after_step and step >= cfg.fail_after_step > step - n:
                raise RuntimeError(f"fault injection: crash at step {step}")

            # each cadence fires when a multiple of it lies in (step-n, step]
            if step % cfg.log_every < n or step == total:
                loss = float(metrics["loss"])   # waits for the chunk
                dt = time.time() - t_last
                sps = steps_since / dt if dt > 0 else 0.0
                if pending:
                    for c_start, c_n, stk in pending:
                        host = {k: v.cpu().numpy() for k, v in stk.items()}
                        for j in range(c_n):
                            logger.log(c_start + j + 1,
                                       **{k: v[j] for k, v in host.items()})
                    pending.clear()
                    logger.log(step, steps_per_sec=sps,
                               examples_per_sec=sps * cfg.batch_size)
                else:
                    logger.log(step, steps_per_sec=sps,
                               examples_per_sec=sps * cfg.batch_size,
                               **metrics)
                if "bits_per_dim" in metrics:
                    head = f"bits/dim {float(metrics['bits_per_dim']):.4f}"
                else:
                    head = f"nll {float(metrics['nll_nats']):.2f} nats"
                print(f"[train] step {step} loss {loss:.2f} {head} "
                      f"{sps:.3f} steps/s")
                t_last, steps_since = time.time(), 0

            if (eval_fn is not None and step % cfg.eval_every < n
                    and step >= cfg.eval_every):
                with torch.no_grad():
                    for k, p in ema_model.named_parameters():
                        p.copy_(state.opt.ema[k])
                nats = float(eval_fn(ema_model, fold(base_key, 2**31 + step),
                                     eval_images).mean())
                if cfg.likelihood == "bernoulli":
                    logger.log(step, eval_nll_nats=nats)
                else:
                    logger.log(step, eval_bits_per_dim=nats
                               / (LOG2 * cfg.num_pixels))
                if cfg.image_summaries:
                    _log_image_summaries(cfg, ema_model, base_key, step,
                                         eval_images, logger)

            if (step % cfg.ckpt_every < n and step >= cfg.ckpt_every) \
                    or step == total:
                ckpt.save(cfg.logdir, step,
                          state_to_tree(step, state, base_key),
                          keep=cfg.ckpt_keep)
    finally:
        prefetch.close()
        chunk_fn.close()
        logger.close()
    return state


def _log_image_summaries(cfg: Config, ema_model: torch.nn.Module,
                         base_key: int, step: int, eval_images: np.ndarray,
                         logger: MetricsLogger) -> None:
    """Sample and reconstruction tiles on the EMA weights at the heartbeat
    eval, key ``fold(base_key, 2**31 - 5)``: ``images/samples_*`` and
    ``images/recons_*`` (originals and reconstructions in pairs; the
    MNIST family's are its Bernoulli means)."""
    family = get_model(cfg)
    key = fold(base_key, 2**31 - 5)
    n = min(16, cfg.eval_batch_size)
    with torch.inference_mode():
        samples = _uint8(family.sample(cfg, ema_model, key, n))
        out = family.apply_fn(cfg, ema_model, key, eval_images[:n],
                              mode="eval", k=1)
        recon = _uint8(family.pixels(out))
    logger.log_image("samples", img_tile(samples), step)
    logger.log_image("recons", _pairs(eval_images[:n], recon), step)


def _uint8(images: torch.Tensor) -> np.ndarray:
    return images.cpu().numpy().astype(np.uint8)


def _pairs(x: np.ndarray, recon: np.ndarray) -> np.ndarray:
    """One tile of each original next to its reconstruction."""
    pairs = np.stack([np.asarray(x).astype(np.uint8), recon], axis=1)
    return img_tile(pairs.reshape((-1,) + recon.shape[1:]))


def _latest(cfg: Config) -> str:
    latest = latest_checkpoint(cfg.logdir)
    if latest is None:
        raise FileNotFoundError(f"no checkpoint in {cfg.logdir}")
    return latest


def _model(cfg: Config, params, device) -> torch.nn.Module:
    """The config family's ``Model`` on ``device`` from one (used as it
    is) or a state_dict."""
    Model = get_model(cfg).Model
    if isinstance(params, Model):
        if param_device(params) != device:
            raise ValueError(f"model is on {param_device(params)}, "
                             f"eval device is {device}")
        return params
    if not isinstance(params, Mapping):
        raise TypeError(f"params must be a {Model.__name__}, a state_dict "
                        "or None")
    model = Model(cfg, device=device)
    model.load_state_dict(params)
    return model


def make_eval_setup(cfg: Config, mode: str, k: int, device="cuda"):
    """(the split's images, the eval step at ``k``), built once:
    ``eval_loop`` reuses them across its checkpoint polls."""
    if mode not in ("eval_train", "eval_test"):
        raise ValueError(f"mode {mode!r} not in ('eval_train', 'eval_test')")
    ds, _ = load_dataset(cfg.dataset, cfg.data_dir, cfg.image_size,
                         cfg.channels)
    images = ds.train_x if mode == "eval_train" else ds.test_x
    if cfg.binarize:
        # the training protocol: sampled binarization, at a fixed key
        images = feed.dynamic_binarize(images, feed.binarize_rng(cfg.seed,
                                                                 -2))
    return images, make_eval_step(cfg, resolve_device(device), k=k)


def evaluate(cfg: Config, mode: str = "eval_test", params=None,
             use_ema: bool = True, k: int | None = None,
             max_batches: int | None = None, setup=None,
             progress_path: str | None = None,
             progress_id: str | None = None, progress_every: int = 10,
             device="cuda") -> float:
    """Importance-weighted eval of the ``eval_train``/``eval_test`` split
    on ``params`` (the family's ``Model``, a state_dict, or None: the
    newest checkpoint's EMA weights, or its raw ones without
    ``use_ema``). ``setup`` is ``make_eval_setup``'s pair. The tail
    remainder is padded to the batch shape (repeating its first row) and
    only its real rows count. Returns bits/dim, or for the MNIST family
    the NLL in nats (the paper's metric there).

    With ``progress_path`` the running sums are written there atomically
    every ``progress_every`` batches and at the last; a killed run resumes
    at the next batch with the same result, since each batch's key is a
    function of its index. The file is tied to the eval's identity (mode,
    k, batch size, split size, seed, ``progress_id``: the checkpoint's
    name for checkpoint weights, required for caller-supplied ones, and
    this package's name, since the JAX package draws other noise); a file
    of another identity is ignored, a capped rerun leaves a more complete
    one alone, and a full pass deletes it."""
    if mode not in ("eval_train", "eval_test"):
        raise ValueError(f"mode {mode!r} not in ('eval_train', 'eval_test')")
    dev = resolve_device(device)
    _config_line(cfg, dev)
    k = cfg.eval_k if k is None else k
    if params is None:
        latest = _latest(cfg)
        params = load_jax_checkpoint(latest, use_ema=use_ema)
        if progress_id is None:
            progress_id = os.path.basename(latest) + ("/ema" if use_ema
                                                      else "/raw")
    elif progress_path and progress_id is None:
        # with no checkpoint name to tie the file to, a constant id would
        # mix partial sums of different weights
        raise ValueError("progress_path with caller-supplied params "
                         "requires an explicit progress_id")
    model = _model(cfg, params, dev)
    if setup is None:
        setup = make_eval_setup(cfg, mode, k, dev)
    images, eval_fn = setup
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
    full_pass = n_batches == n_full and tail == len(images) - n_full * bs
    identity = {"mode": mode, "k": k, "bs": bs, "n": int(len(images)),
                "seed": cfg.seed, "id": progress_id or "external-params",
                "impl": "iaf_torch"}

    start_i, total_nats, total_n = 0, 0.0, 0
    protect_progress = False
    if progress_path and os.path.isfile(progress_path):
        with open(progress_path) as f:
            prog = json.load(f)
        if prog.get("identity") == identity and prog["i"] <= n_batches:
            start_i = prog["i"]
            total_nats, total_n = prog["total_nats"], prog["total_n"]
            print(f"[{mode}] resuming at batch {start_i}/{n_batches} from "
                  f"{progress_path}")
        elif prog.get("identity") == identity:
            protect_progress = True
            print(f"[{mode}] progress file has {prog['i']} batches > this "
                  f"run's {n_batches}; preserving it (this capped run will "
                  "not write progress)")
        else:
            print(f"[{mode}] ignoring stale eval progress {progress_path}")
    # one process: the multi-GPU eval (ROADMAP queue 1, item 4) must also
    # broadcast rank 0's resume point to the other ranks

    def save_progress(i: int) -> None:
        if not progress_path or protect_progress:
            return
        tmp = progress_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"identity": identity, "i": i,
                       "total_nats": total_nats, "total_n": total_n}, f)
        os.replace(tmp, progress_path)

    t0 = time.time()
    for i in range(start_i, n_batches):
        nats = eval_fn(model, fold(key, i), images[i * bs:(i + 1) * bs])
        total_nats += float(torch.sum(nats))
        total_n += bs
        done = i + 1
        if done % progress_every == 0 or done == n_batches:
            save_progress(done)
            if done != n_batches:
                rate = (done - start_i) / max(time.time() - t0, 1e-9)
                print(f"[{mode}] batch {done}/{n_batches} running nats/ex "
                      f"{total_nats / total_n:.2f} eta "
                      f"{(n_batches - done) / max(rate, 1e-9) / 60:.1f} min")
    if tail:
        rem = images[n_full * bs:]
        pad = np.concatenate([rem] + [rem[:1]] * (bs - tail))[:bs]
        nats = eval_fn(model, fold(key, n_full), pad)
        total_nats += float(torch.sum(nats[:tail]))
        total_n += tail
    if progress_path and full_pass and os.path.isfile(progress_path):
        os.remove(progress_path)
    nats_mean = total_nats / max(total_n, 1)
    if cfg.likelihood == "bernoulli":
        print(f"[{mode}] k={k} n={total_n} NLL {nats_mean:.2f} nats")
        return nats_mean
    bits_per_dim = nats_mean / (LOG2 * cfg.num_pixels)
    print(f"[{mode}] k={k} n={total_n} nats {nats_mean:.2f} "
          f"bits/dim {bits_per_dim:.4f}")
    return bits_per_dim


def eval_loop(cfg: Config, mode: str = "eval_test", poll_secs: float = 30.0,
              max_evals: int | None = None, k: int | None = None,
              max_batches: int | None = None, device="cuda") -> None:
    """Follow a training run: poll ``cfg.logdir`` for new checkpoints and
    score each one's EMA weights, logging ``bits_per_dim`` (the MNIST
    family: ``nll_nats``) at its step to ``<logdir>/{mode}_metrics.jsonl``.
    The split, the eval step and the model are built once; runs until
    interrupted, or ``max_evals``."""
    dev = resolve_device(device)
    k = cfg.eval_k if k is None else k
    setup = make_eval_setup(cfg, mode, k, dev)
    model = get_model(cfg).Model(cfg, device=dev)
    metric_name = ("nll_nats" if cfg.likelihood == "bernoulli"
                   else "bits_per_dim")
    loader = ckpt.CheckpointLoader(cfg.logdir)
    logger = MetricsLogger(cfg.logdir, filename=f"{mode}_metrics.jsonl")
    done = 0
    try:
        while max_evals is None or done < max_evals:
            item = loader.maybe_load()
            if item is None:
                time.sleep(poll_secs)
                continue
            path, tree = item
            step = int(np.asarray(tree["step"]))
            model.load_state_dict(from_jax_params(tree["opt"]["ema"]))
            metric = evaluate(
                cfg, mode=mode, params=model, k=k, max_batches=max_batches,
                setup=setup, progress_path=os.path.join(
                    cfg.logdir, f"eval_progress_{mode}.json"),
                progress_id=os.path.basename(path) + "/ema", device=dev)
            logger.log(step, **{metric_name: metric})
            print(f"[eval_loop] {path} step {step} -> {metric:.4f}")
            done += 1
    finally:
        logger.close()


def _serving_model(cfg: Config, use_ema: bool, device) -> torch.nn.Module:
    """The newest checkpoint's EMA (or raw) weights as the family's
    ``Model`` on ``device``."""
    return _model(cfg, load_jax_checkpoint(_latest(cfg), use_ema=use_ema),
                  device)


def inversion_inputs(cfg: Config, model: cvae.CVAE, batch: int):
    """What ``invert_check`` inverts: the top IAF step's probe on the
    first ``batch`` test images (key seed + 31337) and its forward flow.
    Returns (z0, context, ar_fn, z')."""
    ds, _ = load_dataset(cfg.dataset, cfg.data_dir, cfg.image_size,
                         cfg.channels)
    z0, context, ar_fn = cvae.posterior_flow_probe(
        cfg, model, cfg.seed + 31337, ds.test_x[:batch])
    z_prime, _ = cvae.iaf_flow(cfg, model.blocks[-1], z0, context,
                               torch.zeros_like(z0))
    return z0, context, ar_fn, z_prime


def invert_check(cfg: Config, use_ema: bool = True, batch: int | None = None,
                 run_exact: bool = True, device="cuda") -> dict:
    """Invert the top IAF step on the newest checkpoint: forward its flow
    on the posterior sample of ``batch`` test images (default
    min(4, eval_batch_size)), then invert it exactly (per position), by
    D Jacobi sweeps and by early-exit fixed-point sweeps (tol 1e-6),
    reporting each one's round-trip error and seconds and the sweeps the
    fixed point took. Returns {"err_*", "t_*", "iters_fixed_point",
    "D"}. The CIFAR family's only: the JAX package probes no MNIST flow
    (``posterior_flow_probe`` is ``cvae``'s)."""
    from iaf_torch.models.inversion import (invert_ar_exact,
                                            invert_ar_fixed_point,
                                            invert_ar_jacobi)
    if cfg.likelihood == "bernoulli":
        raise NotImplementedError(
            "invert_check inverts the CIFAR family's top conv IAF step "
            "(likelihood=dlogistic); the MNIST family has no inversion "
            "check, in the JAX package either")
    dev = resolve_device(device)
    _config_line(cfg, dev)
    model = _serving_model(cfg, use_ema, dev)
    form, bias = cfg.flow_update, cfg.gate_forget_bias
    with torch.inference_mode():
        z0, _, ar_fn, z_prime = inversion_inputs(
            cfg, model, batch or min(4, cfg.eval_batch_size))
        D = z_prime.shape[1] * z_prime.shape[2] * z_prime.shape[3]
        variants = []
        if run_exact:
            variants.append(("exact", lambda: invert_ar_exact(
                ar_fn, z_prime, form=form, gate_bias=bias)))
        variants.append(("jacobi", lambda: invert_ar_jacobi(
            ar_fn, z_prime, iters=D, form=form, gate_bias=bias)))
        variants.append(("fixed_point", lambda: invert_ar_fixed_point(
            ar_fn, z_prime, tol=1e-6, form=form, gate_bias=bias)))
        results: dict = {"D": D}
        for name, fn in variants:
            t0 = time.time()
            z_rec = fn()
            if name == "fixed_point":
                z_rec, results["iters_fixed_point"] = z_rec
            results[f"err_{name}"] = float(torch.max(torch.abs(z_rec - z0)))
            results[f"t_{name}"] = time.time() - t0
    parts = [f"[invert_check] shape {tuple(z_prime.shape)} D={D}"]
    for name, _ in variants:
        parts.append(f"{name} err {results[f'err_{name}']:.2e} "
                     f"({results[f't_{name}']:.1f}s)")
    parts.append(f"fixed-point converged in {results['iters_fixed_point']} "
                 f"iters ({results['iters_fixed_point'] / D:.1%} of D)")
    print(" | ".join(parts))
    return results


def reconstruct(cfg: Config, num: int = 16, use_ema: bool = True,
                out_path: str | None = None, device="cuda") -> np.ndarray:
    """Posterior reconstructions of the first ``num`` test images (one
    eval-mode forward, k = 1); with ``out_path`` a tile of each original
    next to its reconstruction is saved there. Returns the uint8
    reconstructions [num, H, W, C] (the MNIST family's Bernoulli
    means)."""
    family = get_model(cfg)
    dev = resolve_device(device)
    _config_line(cfg, dev)
    model = _serving_model(cfg, use_ema, dev)
    ds, _ = load_dataset(cfg.dataset, cfg.data_dir, cfg.image_size,
                         cfg.channels)
    x = np.asarray(ds.test_x[:num])
    with torch.inference_mode():
        out = family.apply_fn(cfg, model, cfg.seed + 777, x, mode="eval",
                              k=1)
        recon = _uint8(family.pixels(out))
    if out_path:
        np.save(out_path, _pairs(x, recon))
        print(f"[recon] wrote {out_path} ({num} original/recon pairs)")
    return recon


def sample(cfg: Config, num: int = 16,
           temperature: float | list[float] = 1.0, use_ema: bool = True,
           out_path: str | None = None, device="cuda") -> np.ndarray:
    """``num`` prior samples at each temperature of ``temperature`` (a
    float or a list: a sweep, every temperature on the same base noise);
    with ``out_path`` each temperature's tile is saved (``<out>_T<t>.npy``
    for a sweep). Returns the last temperature's uint8 images (the MNIST
    family's Bernoulli means)."""
    family = get_model(cfg)
    dev = resolve_device(device)
    _config_line(cfg, dev)
    model = _serving_model(cfg, use_ema, dev)
    temps = (list(temperature) if isinstance(temperature, (list, tuple))
             else [temperature])
    imgs = None
    for t in temps:
        with torch.inference_mode():
            imgs = _uint8(family.sample(cfg, model, cfg.seed + 4242, num,
                                        t))
        if out_path:
            path = (out_path if len(temps) == 1 else
                    out_path.replace(".npy", "") + f"_T{t}.npy")
            np.save(path, img_tile(imgs))
            print(f"[sample] wrote {path} ({num} images, T={t})")
    return imgs
