"""Inverting an IAF step (``iaf_tpu/models/inversion.py``).

Forward (division form): z' = (z - m(z)) * exp(-s(z)). The inverse,
z_t = z'_t * exp(s_t(z_<t)) + m_t(z_<t), is sequential over the AR order:
pixels in raster order, channels within a pixel (the order of the masks,
``iaf_torch.nn.masks``), so position (h, w, c) of an NHWC map is
``(h * W + w) * C + c``. Three loops, each a plain Python loop over
``ar_fn`` calls on tensors:

* ``invert_ar_exact``: one position per sweep, D = H * W * C sweeps.
* ``invert_ar_jacobi``: every position updated each sweep; exact once the
  sweeps reach the AR DAG's depth (at most D).
* ``invert_ar_fixed_point``: Jacobi sweeps until the largest change
  between two iterates is at most ``tol`` (or D sweeps); returns the count
  of sweeps, which means what JAX's ``while_loop`` count means. The change
  is read on the host once a sweep (``fixed_point_sweeps``, which
  ``sweep_changes`` also reads).

``ar_fn(z) -> (m, s)`` includes the model's 0.1 scaling and its context
(``iaf_torch.models.cvae.posterior_flow_probe``).
"""

from __future__ import annotations

import math
from typing import Callable, Iterator

import torch

ArFn = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def _ar_position_index(shape, device) -> torch.Tensor:
    """[H, W, C] int64: each position's place in the raster-then-channel
    AR order."""
    _, h, w, c = shape
    return torch.arange(h * w * c, device=device).reshape(h, w, c)


def _inverse_update(z_prime, m, s, gate_bias: float, form: str):
    if form == "division":
        return z_prime * torch.exp(s) + m
    if form == "gate":
        g = torch.sigmoid(s + gate_bias)
        return (z_prime - (1.0 - g) * m) / g
    raise ValueError(form)


def _positions(z_prime: torch.Tensor) -> int:
    return z_prime.shape[1] * z_prime.shape[2] * z_prime.shape[3]


def invert_ar_exact(ar_fn: ArFn, z_prime: torch.Tensor,
                    form: str = "division", gate_bias: float = 0.0
                    ) -> torch.Tensor:
    """Exact sequential inversion: sweep t fixes position t only."""
    pos = _ar_position_index(z_prime.shape, z_prime.device)
    z = torch.zeros_like(z_prime)
    for t in range(_positions(z_prime)):
        m, s = ar_fn(z)
        z = torch.where(pos == t, _inverse_update(z_prime, m, s, gate_bias,
                                                  form), z)
    return z


def invert_ar_jacobi(ar_fn: ArFn, z_prime: torch.Tensor, iters: int,
                     form: str = "division", gate_bias: float = 0.0
                     ) -> torch.Tensor:
    """``iters`` Jacobi sweeps from zeros; exact once ``iters`` reaches the
    AR DAG's depth."""
    z = torch.zeros_like(z_prime)
    for _ in range(iters):
        m, s = ar_fn(z)
        z = _inverse_update(z_prime, m, s, gate_bias, form)
    return z


def fixed_point_sweeps(ar_fn: ArFn, z_prime: torch.Tensor,
                       form: str = "division", gate_bias: float = 0.0
                       ) -> Iterator[tuple[torch.Tensor, float]]:
    """Jacobi sweeps from zeros, without end: yields each iterate and the
    max-abs change from the one before, read on the host."""
    z = torch.zeros_like(z_prime)
    while True:
        m, s = ar_fn(z)
        z_new = _inverse_update(z_prime, m, s, gate_bias, form)
        # in f32 whatever z's dtype: a bf16 difference could not fall
        # below bf16's resolution, and the exit would wait for identical
        # iterates
        delta = float(torch.max(torch.abs(z_new.float() - z.float())))
        z = z_new
        yield z, delta


def invert_ar_fixed_point(ar_fn: ArFn, z_prime: torch.Tensor,
                          tol: float = 1e-6, max_iters: int | None = None,
                          form: str = "division", gate_bias: float = 0.0
                          ) -> tuple[torch.Tensor, int]:
    """Jacobi sweeps until the max-abs change between two iterates is at
    most ``tol`` (or ``max_iters``, by default D). Returns (z, sweeps)."""
    limit = _positions(z_prime) if max_iters is None else max_iters
    sweeps = fixed_point_sweeps(ar_fn, z_prime, form, gate_bias)
    z, delta, iters = torch.zeros_like(z_prime), math.inf, 0
    while iters < limit and delta > tol:
        z, delta = next(sweeps)
        iters += 1
    return z, iters


def sweep_changes(ar_fn: ArFn, z_prime: torch.Tensor, tol: float,
                  form: str = "division", gate_bias: float = 0.0
                  ) -> list[float]:
    """The change of each fixed-point sweep, up to the first at most
    ``tol`` or D of them: what decides ``invert_ar_fixed_point``'s
    count."""
    changes: list[float] = []
    sweeps = fixed_point_sweeps(ar_fn, z_prime, form, gate_bias)
    while len(changes) < _positions(z_prime) and (not changes
                                                  or changes[-1] > tol):
        changes.append(next(sweeps)[1])
    return changes
