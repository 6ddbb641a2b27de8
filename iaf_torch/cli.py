#!/usr/bin/env python
"""CLI driver with the flags of ``iaf_tpu/cli.py``:

    python -m iaf_torch.cli --logdir /tmp/iaf --mode eval_test

``--mode train`` trains (resuming from the newest checkpoint in
``--logdir``, the port's or the JAX package's); ``--mode
eval_test|eval_train`` runs the importance-weighted eval on the EMA
weights of the newest checkpoint, resumable from
``<logdir>/eval_progress_<mode>.json``; ``--mode eval_loop`` scores each
new checkpoint of a training run as it appears; ``--mode sample`` writes
prior samples (``<logdir>/samples.npy``, ``--num_samples``,
``--temperature`` one value or a comma list), ``--mode recon``
original/reconstruction pairs (``<logdir>/recons.npy``) and ``--mode
invert_check`` inverts the top IAF step three ways (the CIFAR family
only). A Bernoulli ``--hpconfig`` (``likelihood=bernoulli``) runs the
MNIST family in every other mode. Every mode runs on
the card unless ``--device cpu`` asks for the plain twins. ``--mode
export`` is not ported yet and raises, naming the ROADMAP item that
brings it. ``--profile_dir D``
traces whichever mode runs with ``torch.profiler`` (host activity, and
the card's kernels when it runs there) and writes the trace into D as
``*.pt.trace.json``, as the JAX package's CLI traces into its profile
directory.
``--num_gpus`` is accepted for command-line parity and ignored.
"""

from __future__ import annotations

import argparse
import contextlib

from iaf_torch import train_lib
from iaf_torch.core.config import resolve_config

_NOT_YET = {"export": "ROADMAP queue 1, item 5 (export)"}


@contextlib.contextmanager
def _profiled(profile_dir: str, device: str):
    """A ``torch.profiler`` trace of the block into ``profile_dir`` (none
    for ""): host activity always, the card's too when ``device`` is a
    CUDA device; the trace is written when the block ends, by an
    exception too."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        print(f"[profile] trace written to {profile_dir}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--logdir", type=str, default="/tmp/iaf_tpu")
    p.add_argument("--hpconfig", type=str, default="",
                   help="comma-separated k=v hyperparameter overrides")
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "eval_train", "eval_test", "eval_loop",
                            "sample", "recon", "invert_check", "export"])
    p.add_argument("--export_platforms", type=str, default="")
    p.add_argument("--num_gpus", type=int, default=None,
                   help="reference-CLI parity; ignored")
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--max_batches", type=int, default=None,
                   help="cap eval batches (eval_* modes); a full eval's "
                   "partial progress persists to the logdir either way")
    p.add_argument("--temperature", type=str, default="1.0")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the plain twins)")
    args = p.parse_args(argv)

    cfg = resolve_config(args.logdir, args.hpconfig, mode=args.mode)
    if args.mode in _NOT_YET:
        raise NotImplementedError(
            f"--mode {args.mode} is not ported to iaf_torch yet: "
            f"{_NOT_YET[args.mode]}")
    if cfg.dataset in ("cifar10", "mnist"):
        from iaf_torch.data.datasets import real_data_available
        found = real_data_available(cfg.dataset, cfg.data_dir)
        print(f"[data] real {cfg.dataset} found at {found}" if found else
              f"[data] no real {cfg.dataset} on disk -> synthetic fallback")
    dev = args.device
    with _profiled(args.profile_dir, dev):
        if args.mode == "train":
            train_lib.train(cfg, device=dev)
        elif args.mode in ("eval_train", "eval_test"):
            train_lib.evaluate(
                cfg, mode=args.mode, max_batches=args.max_batches,
                progress_path=f"{args.logdir}/eval_progress_{args.mode}.json",
                device=dev)
        elif args.mode == "eval_loop":
            train_lib.eval_loop(cfg, max_batches=args.max_batches, device=dev)
        elif args.mode == "invert_check":
            train_lib.invert_check(cfg, device=dev)
        elif args.mode == "recon":
            train_lib.reconstruct(cfg, num=args.num_samples,
                                  out_path=f"{args.logdir}/recons.npy",
                                  device=dev)
        elif args.mode == "sample":
            train_lib.sample(cfg, num=args.num_samples,
                             temperature=[float(t) for t in
                                          args.temperature.split(",")],
                             out_path=f"{args.logdir}/samples.npy",
                             device=dev)


if __name__ == "__main__":
    main()
