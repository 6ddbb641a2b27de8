"""Host-side input order (``iaf_tpu/data/feed.py``), numpy only, so the
port's batches equal the JAX package's for the same seed.

Each process draws its shard of every global batch from an epoch
permutation that is a pure function of (seed, epoch); ``start_step``
fast-forwards the order on resume. ``ChunkPrefetcher`` stacks the next
dispatch's batches on a background thread while the card runs the
current one. ``binarized_iterator`` binarizes MNIST batches afresh at
every step, keyed by (seed, step), so a resumed run binarizes as a
straight one.
"""

from __future__ import annotations

import queue
import sys
import threading
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


class ChunkPrefetcher:
    """Double-buffered input assembly (``iaf_tpu/data/feed.py —
    ChunkPrefetcher``): a background thread stacks the next dispatch's
    ``steps_per_dispatch`` batches of ``data_iter`` into one [n, B, ...]
    numpy array while the card runs the current chunk. Yields ``(n,
    chunk)``, ``first_local`` (a batch already taken from ``data_iter``)
    first, and sizes the tail chunk so that exactly ``total_steps -
    start_step`` steps come out. The thread does numpy only: pinning and
    the copy to the card are the consumer's. An error in the thread is
    raised on the consumer's side."""

    def __init__(self, data_iter, steps_per_dispatch: int, total_steps: int,
                 start_step: int = 0, first_local=None, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._done = False   # terminal: never block on the queue again
        S = max(1, steps_per_dispatch)

        def put(item) -> bool:
            # a bounded put that watches the stop event, so that close()
            # releases a worker blocked on a full queue
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                step, first = start_step, first_local
                while step < total_steps and not self._stop.is_set():
                    n = min(S, total_steps - step)
                    batches = []
                    for _ in range(n):
                        if first is not None:
                            batches.append(first)
                            first = None
                        else:
                            batches.append(next(data_iter))
                    if not put((n, np.stack(batches))):
                        return
                    step += n
            except BaseException as e:   # raised on the consumer's side
                self._err = e
            finally:
                put(None)

        self._t = threading.Thread(target=worker, daemon=True,
                                   name="iaf-input-prefetch")
        self._t.start()

    def close(self) -> None:
        """Release the worker thread and its queued chunks; safe to call
        again. A worker still alive after 5 s (stuck in ``data_iter``) is
        reported: it is a daemon thread and does not block the exit."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=5.0)
        if self._t.is_alive():
            print("[feed] WARNING: prefetch worker still alive after a 5 s "
                  "join (stuck in the data iterator); it is a daemon "
                  "thread and will not block the exit", file=sys.stderr)
        self._done = True

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is None:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def dynamic_binarize(batch: np.ndarray,
                     rng: np.random.RandomState) -> np.ndarray:
    """Dynamic binarization: each pixel Bernoulli(intensity / 255), drawn
    afresh, as uint8 0 or 255 (the model's x / 255 sees 0 or 1)."""
    p = batch.astype(np.float32) / 255.0
    return (rng.uniform(size=batch.shape) < p).astype(np.uint8) * 255


def binarize_rng(seed: int, step: int) -> np.random.RandomState:
    """The binarization draws of one step: a pure function of (seed,
    step); the evals use steps -1 (heartbeat) and -2 (``evaluate``)."""
    return np.random.RandomState((seed * 9_176_471 + 17 + step) % (2**31 - 1))


def binarized_iterator(it: Iterator[np.ndarray], seed: int,
                       start_step: int = 0) -> Iterator[np.ndarray]:
    """``it``'s batches binarized, the one of step s with
    ``binarize_rng(seed, s)``, counting from ``start_step``."""
    step = start_step
    for b in it:
        yield dynamic_binarize(b, binarize_rng(seed, step))
        step += 1
