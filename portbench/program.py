"""The system under test, as the benchmark drives it: ``iaf_torch``.

This is the only module of the benchmark that imports the program. It
hands the program what the benchmark made (the configuration, the
weights, the images, the posterior draws) through the program's own
entries, and takes back only what those entries return: the training
chunk's metrics, the optimizer state that the step updates, and the IW
eval's per-image bounds.
"""

from __future__ import annotations

import concurrent.futures
import time

import numpy as np
import torch


def config(c: dict, traffic: dict):
    """The program's ``Config`` for a configuration file's ``config``
    and a traffic mix's batch and eval settings."""
    from iaf_torch.core.config import Config
    cfg = Config().replace(**c)
    if traffic["kind"] == "train":
        return cfg.replace(batch_size=traffic["batch_size"],
                           steps_per_dispatch=traffic["steps_per_dispatch"],
                           log_every=traffic["log_every"])
    return cfg.replace(eval_batch_size=traffic["batch_size"],
                       eval_k=traffic["k"], eval_k_chunk=traffic["k_chunk"])


def build_kernels() -> dict[str, float]:
    """Every CUDA source of the program loaded, built first where its
    library is missing or stale, the builds in parallel. Returns nvcc's
    seconds per source built (empty when every library was there)."""
    from iaf_torch.ops import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(_build.load, n) for n in names]:
            f.result()
    return dict(_build.build_seconds)


def model(cfg, P: dict[str, torch.Tensor], device):
    """The family's model on ``device`` with the benchmark's parameters
    copied in; names and shapes must match exactly."""
    from iaf_torch.models import get_model
    m = get_model(cfg).Model(cfg, device=device)
    have = {n: tuple(p.shape) for n, p in m.named_parameters()}
    want = {n: tuple(t.shape) for n, t in P.items()}
    if have != want:
        raise RuntimeError(
            "the program's parameters differ from the reference's: only "
            f"the program's {sorted(set(have) - set(want))[:5]}, only the "
            f"reference's {sorted(set(want) - set(have))[:5]}, shapes "
            f"{[n for n in have.keys() & want.keys() if have[n] != want[n]][:5]}")
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(P[n])
    return m


def sites(cfg, rows: int) -> list[str]:
    """The posterior noise sites, layer 0 (bottom) first, checked against
    the benchmark's per-layer draw shape."""
    from iaf_torch.models import get_model
    family = get_model(cfg)
    shapes = family.noise_shapes(cfg, rows)
    hw = cfg.image_size // 2
    names = [f"{n}/z_post" for n in family.layer_names(cfg)]
    if list(shapes) != names or any(
            s != (rows, hw, hw, cfg.z_size) for s in shapes.values()):
        raise RuntimeError(f"unexpected noise sites {shapes}")
    return names


class Train:
    """The training path as ``train_lib.train`` drives it: a
    ``make_train_chunk`` over fixed buffers, its batches from a
    ``ChunkPrefetcher`` over ``batch_iterator``."""

    def __init__(self, cfg, P, images: np.ndarray, seed: int, device):
        from iaf_torch import optim
        from iaf_torch.data import feed
        from iaf_torch.parallel import train_step as ts
        self.cfg, self.seed = cfg, seed
        m = model(cfg, P, device)
        self.state = ts.TrainState(
            m, optim.init_state(dict(m.named_parameters())))
        self.chunk = ts.make_train_chunk(cfg, self.state)
        self.sites = sites(cfg, cfg.batch_size)
        it = feed.batch_iterator(images, cfg.batch_size, seed)
        self.prefetch = feed.ChunkPrefetcher(it, cfg.steps_per_dispatch,
                                             total_steps=2 ** 62)
        self.step = 0
        self.feed_wait = 0.0

    def next_batches(self) -> np.ndarray:
        t = time.perf_counter()
        _, batches = next(self.prefetch)
        self.feed_wait += time.perf_counter() - t
        return batches

    def run(self, batches: np.ndarray, noise: list[list[torch.Tensor]]):
        """One chunk on ``batches`` [n, B, ...] with step i's draws
        ``noise[i]`` (per layer); returns its stacked metrics."""
        given = [dict(zip(self.sites, eps)) for eps in noise]
        self.state, metrics = self.chunk(self.state, self.seed, self.step,
                                         batches, given)
        self.step += batches.shape[0]
        return metrics

    def named(self) -> dict[str, torch.Tensor]:
        return dict(self.state.params.named_parameters())

    def close(self) -> None:
        self.prefetch.close()
        self.chunk.close()
        self.state = self.chunk = None


class Eval:
    """The IW eval as ``train_lib.evaluate`` drives it:
    ``make_graphed_eval_step`` on whole batches, a wait for each batch's
    result."""

    def __init__(self, cfg, P, device):
        from iaf_torch.parallel.eval_step import make_graphed_eval_step
        self.cfg = cfg
        self.model = model(cfg, P, device)
        self.step = make_graphed_eval_step(cfg, device, k=cfg.eval_k)
        self.rows = cfg.eval_batch_size * self.step.k_chunk
        self.sites = sites(cfg, self.rows)
        self.n_chunks = self.step.n_chunks

    def run(self, key: int, batch: np.ndarray, chunk_noise):
        """The batch's per-image negative IW bounds (nats, on the host);
        ``chunk_noise(c)`` gives chunk c's draws per layer."""
        return self.step(self.model, key, batch,
                         _Chunks(self.n_chunks, self.sites, chunk_noise)
                         ).cpu()

    def close(self) -> None:
        self.step.close()
        self.model = self.step = None


class _Chunks:
    """The eval step's per-chunk noise argument, each chunk's dict made
    when the step asks for it (a batch's draws do not fit at once)."""

    def __init__(self, n: int, sites: list[str], draw):
        self.n, self.sites, self.draw = n, sites, draw

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, c: int) -> dict[str, torch.Tensor]:
        return dict(zip(self.sites, self.draw(c)))
