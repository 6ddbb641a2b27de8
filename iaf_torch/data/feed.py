"""Host-side input order (``iaf_tpu/data/feed.py``), numpy only, so the
port's batches equal the JAX package's for the same seed.

Each process draws its shard of every global batch from an epoch
permutation that is a pure function of (seed, epoch); ``start_step``
fast-forwards the order on resume.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def host_shard_indices(n: int, process_index: int, process_count: int,
                       rng: np.random.RandomState) -> np.ndarray:
    """One epoch's sample indices for this process: a permutation every
    process agrees on, split statically by process."""
    perm = rng.permutation(n)
    per = n // process_count
    return perm[process_index * per:(process_index + 1) * per]


def batch_iterator(images: np.ndarray, global_batch: int, seed: int,
                   process_index: int = 0, process_count: int = 1,
                   start_step: int = 0) -> Iterator[np.ndarray]:
    """Infinite iterator of this process's [global_batch / nprocs, ...]
    slices, continuing at ``start_step`` as an uninterrupted run would."""
    if global_batch % process_count:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{process_count} processes")
    local_batch = global_batch // process_count
    per_proc = len(images) // process_count
    if local_batch > per_proc:
        raise ValueError(
            f"per-process batch {local_batch} exceeds the per-process "
            f"dataset size {per_proc} ({len(images)} examples / "
            f"{process_count} processes)")
    batches_per_epoch = max(1, per_proc // local_batch)
    epoch = start_step // batches_per_epoch
    skip = start_step % batches_per_epoch
    while True:
        rng = np.random.RandomState((seed * 1_000_003 + epoch) % (2**31 - 1))
        idx = host_shard_indices(len(images), process_index, process_count,
                                 rng)
        starts = range(0, len(idx) - local_batch + 1, local_batch)
        for start in list(starts)[skip:]:
            yield images[idx[start:start + local_batch]]
        skip = 0
        epoch += 1
