"""Importance-weighted eval on one GPU (``iaf_tpu/parallel/eval_step.py``).

The k samples are streamed in ``eval_k_chunk`` chunks with an online
(running max, rescaled sum-exp) logsumexp, so memory stays at B *
eval_k_chunk model replicas. The key chain mirrors JAX on a one-shard
mesh: the step key, folded with shard 0, then with the chunk index. The
cross-GPU combine (max then sum over ranks) comes with the multi-GPU port.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch

from iaf_torch.core.config import Config
from iaf_torch.core.device import resolve_device
from iaf_torch.core.rng import fold
from iaf_torch.models import get_model
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
    bound in nats, [B], for the config's model family. ``noise``, when
    given, holds one site-keyed noise dict per chunk."""
    k = cfg.eval_k if k is None else k
    resolve_device(device)
    k_chunk, n_chunks = k_chunking(k, cfg.eval_k_chunk)
    apply_fn = get_model(cfg).apply_fn

    def step(model: torch.nn.Module, rng: int, batch,
             noise: Sequence[Mapping[str, torch.Tensor]] | None = None):
        rng_shard = fold(rng, 0)
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
            return -(torch.log(s_run) + m_run - math.log(float(k)))

    return step
