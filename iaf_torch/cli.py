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
only). ``--mode export`` writes the serving artifacts of the newest
checkpoint's EMA weights, ``<logdir>/export/sample.pt2`` and
``elbo.pt2`` (``torch.export`` programs that launch the kernels; the
noise is an input, see ``core/export.py``), for the devices of
``--export_platforms`` (a comma list of cuda, alias gpu, and cpu;
default the run's device) and ``--num_samples`` images a sample call.
A Bernoulli ``--hpconfig`` (``likelihood=bernoulli``) runs the MNIST
family in every other mode. Every mode runs on the card unless
``--device cpu`` asks for the plain twins. ``--profile_dir D``
traces whichever mode runs with ``torch.profiler`` (host activity, and
the card's kernels when it runs there) and writes the trace into D as
``*.pt.trace.json``, as the JAX package's CLI traces into its profile
directory; the model's and the step's named ranges (``iaf_up``,
``iaf_down``, ``ar_stack``, ``grads``, ``adamax_polyak``; in eager bodies
and captures) and the host spans around each replay (``iaf.train.*``,
``iaf.eval.*``) are in it. It also turns the device marks on
(``utils/trace.py``), so on the card every replayed step and eval chunk
shows its phases as ``iaf_mark_*`` kernels.

Data parallelism, one process per GPU (``parallel/mesh.py``)::

    torchrun --nproc_per_node 4 -m iaf_torch.cli --logdir /tmp/iaf \
        --mode train --hpconfig batch_size=128

``--hpconfig batch_size`` is the global batch; every mode runs so, with
rank 0 alone writing and printing. ``--num_gpus`` is accepted for
command-line parity and ignored, as in the JAX package: ``torchrun``
sets the ranks.
"""

from __future__ import annotations

import argparse
import contextlib

from iaf_torch import train_lib
from iaf_torch.core.config import resolve_config
from iaf_torch.core.device import resolve_device
from iaf_torch.parallel import mesh
from iaf_torch.utils import trace


@contextlib.contextmanager
def _profiled(profile_dir: str, device: str):
    """A ``torch.profiler`` trace of the block into ``profile_dir`` (none
    for ""), with the device marks on inside it: host activity always,
    the card's too when ``device`` is a CUDA device; the trace is written
    and the marks set back when the block ends, by an exception too."""
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
    marks = trace.set_marks(True)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        trace.set_marks(marks)
        mesh.print0(f"[profile] trace written to {profile_dir}")


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
    dev = resolve_device(args.device)
    mesh.init_distributed(dev)
    if cfg.dataset in ("cifar10", "mnist"):
        from iaf_torch.data.datasets import real_data_available
        found = real_data_available(cfg.dataset, cfg.data_dir)
        mesh.print0(f"[data] real {cfg.dataset} found at {found}" if found
                    else f"[data] no real {cfg.dataset} on disk -> "
                    "synthetic fallback")
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
        elif args.mode == "export":
            train_lib.export_saved(
                cfg, num_samples=args.num_samples,
                platforms=(args.export_platforms.split(",")
                           if args.export_platforms else None), device=dev)


if __name__ == "__main__":
    main()
