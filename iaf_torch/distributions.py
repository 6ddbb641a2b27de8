"""Distributions and variational objectives (``iaf_tpu/distributions.py``).

Tensors keep the JAX layout (NHWC); reductions are over all but the batch
dim. ``discretized_logistic`` here is the plain form; the eval path calls
the K4 kernel wrapper (``iaf_torch.ops.disc_logistic_logp``), whose CPU
twin is this same formula.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

_LOG2PI = math.log(2.0 * math.pi)


@dataclass(frozen=True)
class DiagonalGaussian:
    """N(mean, exp(logvar)); callers pass ``logvar = 2 * logsd``."""

    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, eps: torch.Tensor) -> torch.Tensor:
        """Reparameterized draw from standard-normal ``eps``."""
        return self.mean + torch.exp(0.5 * self.logvar) * eps

    def logps(self, x: torch.Tensor) -> torch.Tensor:
        return -0.5 * (_LOG2PI + self.logvar
                       + torch.square(x - self.mean) * torch.exp(-self.logvar))


def discretized_logistic(mean, logscale, sample, binsize: float = 1.0 / 256.0):
    """log p(sample) under a logistic discretized into ``binsize`` bins,
    summed over all but the batch dim: the floor snaps the sample to its
    bin's left edge, and ``+1e-7`` keeps the log finite."""
    scale = torch.exp(logscale)
    x = (torch.floor(sample / binsize) * binsize - mean) / scale
    logp = torch.log(torch.sigmoid(x + binsize / scale) - torch.sigmoid(x)
                     + 1e-7)
    return torch.sum(logp.reshape(logp.shape[0], -1), dim=1)


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """Stable logsumexp over the last axis, the max held constant."""
    m = torch.amax(x, dim=-1, keepdim=True).detach()
    return m.squeeze(-1) + torch.log(torch.sum(torch.exp(x - m), dim=-1))


def compute_lowerbound(log_pxz, sum_kl_costs, k: int = 1):
    """Negative k-sample importance-weighted bound per example; the flat
    [B*k] weights are grouped as ``[B, k]`` (the k-repeat is interleaved)."""
    if k == 1:
        return sum_kl_costs - log_pxz
    log_w = torch.reshape(log_pxz - sum_kl_costs, (-1, k))
    return -(logsumexp(log_w) - math.log(float(k)))


def bernoulli_logp(logits, sample):
    """Bernoulli log-likelihood summed over all but the batch dim."""
    z = torch.where(sample > 0.5, -logits, logits)
    logp = -F.softplus(z)
    return torch.sum(logp.reshape(logp.shape[0], -1), dim=1)
