"""Importance-weighted eval (``iaf_tpu/parallel/eval_step.py``).

The k samples are streamed in ``eval_k_chunk`` chunks with an online
(running max, rescaled sum-exp) logsumexp, so memory stays at B *
eval_k_chunk model replicas. Under a process group (``parallel/mesh.py``)
the k axis is sharded: every rank scores the whole batch with its k / N
samples, keyed as JAX's shards are (the step key folded with the rank,
then with the chunk index), and the ranks' (max, sum-exp) pairs are
combined: all-reduce MAX of the running max, then all-reduce SUM of
``s * exp(m - m_glob)``. With no group the key is folded with shard 0,
as on a one-shard mesh. ``make_batch_sharded_elbo`` is the path for a k
that the world size does not divide (the k = 1 plain ELBO): the batch is
sharded instead, each rank drawing its rows of the global noise.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch

from iaf_torch.core.config import Config
from iaf_torch.core.device import resolve_device
from iaf_torch.core.rng import fold
from iaf_torch.models import get_model
from iaf_torch.parallel import mesh
from iaf_torch.utils.params import param_device


def k_chunking(k: int, eval_k_chunk: int) -> tuple[int, int]:
    """(chunk size, chunk count): the chunk is ``eval_k_chunk`` rounded
    down to a divisor of k."""
    k_chunk = min(k, max(1, eval_k_chunk))
    while k % k_chunk:
        k_chunk -= 1
    return k_chunk, k // k_chunk


def make_eval_step(cfg: Config, device="cuda", k: int | None = None):
    """Returns f(model, rng, batch, noise=None) -> per-example negative IW
    bound in nats, [B], for the config's model family; under a process
    group each rank draws k / world samples (k must divide) and every
    rank returns the combined bound. ``noise``, when given, holds one
    site-keyed noise dict per chunk of this rank's samples."""
    k = cfg.eval_k if k is None else k
    resolve_device(device)
    group, world = mesh.active(), mesh.world()
    if k % world:
        raise ValueError(f"k={k} does not shard over {world} ranks; "
                         "make_eval_setup takes the batch-sharded path")
    k_chunk, n_chunks = k_chunking(k // world, cfg.eval_k_chunk)
    apply_fn = get_model(cfg).apply_fn

    def step(model: torch.nn.Module, rng: int, batch,
             noise: Sequence[Mapping[str, torch.Tensor]] | None = None):
        rng_shard = fold(rng, mesh.rank())
        with torch.inference_mode():
            n = len(batch)
            dev = param_device(model)
            m_run = torch.full((n,), -math.inf, device=dev)
            s_run = torch.zeros((n,), device=dev)
            for i in range(n_chunks):
                out = apply_fn(
                    cfg, model, fold(rng_shard, i), batch, mode="eval",
                    k=k_chunk, noise=None if noise is None else noise[i])
                log_w = out.log_w.reshape(n, k_chunk)
                m_new = torch.maximum(m_run, torch.amax(log_w, dim=1))
                s_run = (s_run * torch.exp(m_run - m_new)
                         + torch.sum(torch.exp(log_w - m_new[:, None]), dim=1))
                m_run = m_new
            if group:
                m_glob = mesh.all_reduce_(m_run.clone(), "max")
                s_run = mesh.all_reduce_(s_run * torch.exp(m_run - m_glob))
                m_run = m_glob
            return -(torch.log(s_run) + m_run - math.log(float(k)))

    return step


def make_batch_sharded_elbo(cfg: Config, device="cuda", k: int = 1):
    """The batch-sharded eval (``make_batch_sharded_elbo``): returns
    f(model, rng, batch, noise=None) -> [B] nats, ``apply_fn``'s
    ``elbo_nats`` at k. Under a process group rank r scores its B / world
    images with its rows of the global noise (an injected ``noise`` dict
    is the global draw) and the ranks' results are gathered, so every
    rank returns all B."""
    resolve_device(device)
    world = mesh.world()
    apply_fn = get_model(cfg).apply_fn

    def step(model: torch.nn.Module, rng: int, batch,
             noise: Mapping[str, torch.Tensor] | None = None):
        n = len(batch)
        if n % world:
            raise ValueError(f"batch {n} does not shard over {world} ranks")
        per = n // world
        mine = batch[mesh.rank() * per:(mesh.rank() + 1) * per]
        with torch.inference_mode(), mesh.data_rows():
            out = apply_fn(cfg, model, rng, mine, mode="eval", k=k,
                           noise=noise)
            return mesh.all_gather(out.elbo_nats)

    return step
