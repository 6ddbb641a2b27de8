"""Port parity: ``iaf_torch.distributions`` against ``iaf_tpu.distributions``
on the same numpy inputs (f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu import distributions as jd
from iaf_torch import distributions as td

RTOL = 1e-6


def _rs(seed):
    return np.random.RandomState(seed)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_diagonal_gaussian_logps_and_sample():
    rs = _rs(0)
    mean, logsd, x, eps = (rs.randn(3, 4, 4, 5).astype(np.float32)
                           for _ in range(4))
    jg = jd.DiagonalGaussian(jnp.asarray(mean), 2.0 * jnp.asarray(logsd))
    tg = td.DiagonalGaussian(torch.from_numpy(mean),
                             2.0 * torch.from_numpy(logsd))
    _close(tg.logps(torch.from_numpy(x)), jg.logps(jnp.asarray(x)),
           atol=1e-6)
    want = jg.mean + jnp.exp(0.5 * jg.logvar) * jnp.asarray(eps)
    _close(tg.sample(torch.from_numpy(eps)), want)


def _dl_inputs(seed, far=False):
    rs = _rs(seed)
    img = rs.randint(0, 256, (4, 8, 8, 3))
    sample = (img / 256.0 - 0.5).astype(np.float32)  # bin edges exactly
    mean = (sample + 0.02 * rs.randn(*sample.shape)).astype(np.float32)
    if far:  # sigmoid difference underflows: the +1e-7 clip decides
        mean = (sample + np.where(rs.rand(*sample.shape) < 0.5, 3.0, -3.0)
                ).astype(np.float32)
    return mean, sample


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("logscale", [-4.5, 0.0])
def test_discretized_logistic(far, logscale):
    mean, sample = _dl_inputs(1, far)
    got = td.discretized_logistic(torch.from_numpy(mean),
                                  torch.tensor(logscale),
                                  torch.from_numpy(sample))
    want = jd.discretized_logistic(jnp.asarray(mean), jnp.float32(logscale),
                                   jnp.asarray(sample))
    _close(got, want)


def test_discretized_logistic_bin_edge_snaps_down():
    """A sample just below a bin edge belongs to the lower bin; one exactly
    on the edge to the upper: both frameworks floor the same way."""
    edge = np.float32(3.0 / 256.0)
    sample = np.array([[edge], [np.nextafter(edge, np.float32(0))]],
                      np.float32)
    mean = np.full_like(sample, 2.5 / 256.0)
    got = td.discretized_logistic(torch.from_numpy(mean), torch.tensor(-5.0),
                                  torch.from_numpy(sample))
    want = jd.discretized_logistic(jnp.asarray(mean), jnp.float32(-5.0),
                                   jnp.asarray(sample))
    _close(got, want)
    assert got[0] != got[1]


def test_logsumexp_and_lowerbound():
    rs = _rs(2)
    x = (100.0 * rs.randn(3, 7)).astype(np.float32)
    _close(td.logsumexp(torch.from_numpy(x)), jd.logsumexp(jnp.asarray(x)))
    log_pxz = (-1000.0 + 10.0 * rs.randn(12)).astype(np.float32)
    kl = (50.0 + rs.randn(12)).astype(np.float32)
    for k in (1, 4):
        _close(td.compute_lowerbound(torch.from_numpy(log_pxz),
                                     torch.from_numpy(kl), k),
               jd.compute_lowerbound(jnp.asarray(log_pxz), jnp.asarray(kl),
                                     k))


def test_bernoulli_logp():
    rs = _rs(3)
    logits = (4.0 * rs.randn(5, 6, 6, 1)).astype(np.float32)
    sample = (rs.rand(5, 6, 6, 1) < 0.5).astype(np.float32)
    _close(td.bernoulli_logp(torch.from_numpy(logits),
                             torch.from_numpy(sample)),
           jd.bernoulli_logp(jnp.asarray(logits), jnp.asarray(sample)))
