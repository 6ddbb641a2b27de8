"""Inverting an IAF step (``iaf_tpu/models/inversion.py``).

Forward (division form): z' = (z - m(z)) * exp(-s(z)). The inverse,
z_t = z'_t * exp(s_t(z_<t)) + m_t(z_<t), is sequential over the AR order:
pixels in raster order, channels within a pixel (the order of the masks,
``iaf_torch.nn.masks``), so position (h, w, c) of an NHWC map is
``(h * W + w) * C + c``. Three loops of ``ar_fn`` calls:

* ``invert_ar_exact``: one position per sweep, D = H * W * C sweeps.
* ``invert_ar_jacobi``: every position updated each sweep; exact once the
  sweeps reach the AR DAG's depth (at most D).
* ``invert_ar_fixed_point``: Jacobi sweeps until the largest change
  between two iterates is at most ``tol`` (or D sweeps); returns the count
  of sweeps, which means what JAX's ``while_loop`` count means.

As JAX keeps its ``fori_loop`` and ``while_loop`` on the device, so do
these: the loop's state (the iterate, the sweep counter, the last change
and whether the loop goes on) lives in device tensors, and each sweep is
predicated on it, so the sweeps past the loop's end change nothing. The
sweeps run in blocks (``EXACT_BLOCK``, ``FIXED_POINT_BLOCK``), on the
card one CUDA graph of a block per call, captured at the second block
after an eager first one and replayed (``ops.Graphed``); on the CPU the
same blocks run eagerly. The exact and Jacobi loops know their sweeps
on the host and read nothing back; the fixed point reads its one
``live`` flag once a block. The host loops are kept as the reference
(``*_host``, ``fixed_point_sweeps`` and ``sweep_changes``, which read
each sweep's change on the host): the blocked loops give their bits and
counts.

``ar_fn(z) -> (m, s)`` includes the model's 0.1 scaling and its context
(``iaf_torch.models.cvae.posterior_flow_probe``).
"""

from __future__ import annotations

import math
from typing import Callable, Iterator

import torch

from iaf_torch import ops

ArFn = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]

# sweeps a block of the exact and Jacobi loops runs (D = 8192 at the
# paper config: the eager first block, then 127 replays) and of the fixed
# point's. The fixed point converges in about 10 sweeps there, and a
# block's capture costs about 16 ms on an H100 (two blocks' worth of
# eager sweeps), so its first block, run eagerly, holds the whole loop:
# its idle sweeps cost less than a capture would
EXACT_BLOCK = 64
FIXED_POINT_BLOCK = 16


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


def _run_blocks(block, count: int, device) -> None:
    """``block`` (a block of predicated sweeps) ``count`` times, as one
    replayed graph on the card."""
    graphed = ops.Graphed(device)
    for _ in range(count):
        graphed(block)


def invert_ar_exact(ar_fn: ArFn, z_prime: torch.Tensor,
                    form: str = "division", gate_bias: float = 0.0,
                    block: int = EXACT_BLOCK) -> torch.Tensor:
    """Exact sequential inversion: sweep t fixes position t only (the
    counter t a device tensor; past D no position matches)."""
    dev = z_prime.device
    pos = _ar_position_index(z_prime.shape, dev)
    with torch.no_grad():
        z = torch.zeros_like(z_prime)
        t = torch.zeros((), dtype=torch.int64, device=dev)

        def sweeps():
            for _ in range(block):
                m, s = ar_fn(z)
                z.copy_(torch.where(pos == t, _inverse_update(
                    z_prime, m, s, gate_bias, form), z))
                t.add_(1)
        _run_blocks(sweeps, -(-_positions(z_prime) // block), dev)
    return z


def invert_ar_jacobi(ar_fn: ArFn, z_prime: torch.Tensor, iters: int,
                     form: str = "division", gate_bias: float = 0.0,
                     block: int = EXACT_BLOCK) -> torch.Tensor:
    """``iters`` Jacobi sweeps from zeros (a sweep past ``iters`` keeps
    z); exact once ``iters`` reaches the AR DAG's depth."""
    dev = z_prime.device
    with torch.no_grad():
        z = torch.zeros_like(z_prime)
        i = torch.zeros((), dtype=torch.int64, device=dev)

        def sweeps():
            for _ in range(block):
                m, s = ar_fn(z)
                z.copy_(torch.where(i < iters, _inverse_update(
                    z_prime, m, s, gate_bias, form), z))
                i.add_(1)
        _run_blocks(sweeps, -(-iters // block), dev)
    return z


class _FixedPoint:
    """The fixed point's loop state on the device (the iterate ``z``, the
    count ``i``, the last change ``delta`` and ``live``, JAX's
    ``while_loop`` condition: count below ``limit`` and last change above
    ``tol``, compared in f64 as the host loop compares it) and a block of
    sweeps predicated on it: once the condition fails, z, the change and
    the count stay as they are."""

    def __init__(self, ar_fn: ArFn, z_prime: torch.Tensor, tol: float,
                 limit: int, form: str, gate_bias: float, block: int):
        self.ar_fn, self.z_prime, self.tol, self.limit = (ar_fn, z_prime,
                                                          tol, limit)
        self.form, self.gate_bias, self.block = form, gate_bias, block
        dev = z_prime.device
        self.z = torch.zeros_like(z_prime)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        self.delta = torch.full((), math.inf, device=dev)
        self.live = self._going()

    def _going(self) -> torch.Tensor:
        return (self.i < self.limit) & (self.delta.double() > self.tol)

    def sweeps(self) -> None:
        for _ in range(self.block):
            m, s = self.ar_fn(self.z)
            z_new = _inverse_update(self.z_prime, m, s, self.gate_bias,
                                    self.form)
            # in f32 whatever z's dtype (see fixed_point_sweeps)
            change = torch.max(torch.abs(z_new.float() - self.z.float()))
            go = self._going()
            self.z.copy_(torch.where(go, z_new, self.z))
            self.delta.copy_(torch.where(go, change, self.delta))
            self.i.add_(go)
        self.live.copy_(self._going())


def invert_ar_fixed_point(ar_fn: ArFn, z_prime: torch.Tensor,
                          tol: float = 1e-6, max_iters: int | None = None,
                          form: str = "division", gate_bias: float = 0.0,
                          block: int = FIXED_POINT_BLOCK
                          ) -> tuple[torch.Tensor, int]:
    """Jacobi sweeps until the max-abs change between two iterates is at
    most ``tol`` (or ``max_iters``, by default D). Returns (z, sweeps),
    the count JAX's ``while_loop`` returns (``_FixedPoint``); ``live`` is
    read on the host once a block."""
    limit = _positions(z_prime) if max_iters is None else max_iters
    with torch.no_grad():
        loop = _FixedPoint(ar_fn, z_prime, tol, limit, form, gate_bias,
                           block)
        graphed = ops.Graphed(z_prime.device)
        while bool(loop.live):
            graphed(loop.sweeps)
    return loop.z, int(loop.i)


def invert_ar_exact_host(ar_fn: ArFn, z_prime: torch.Tensor,
                         form: str = "division", gate_bias: float = 0.0
                         ) -> torch.Tensor:
    """``invert_ar_exact`` as a host loop, one ``ar_fn`` call a sweep from
    Python (the reference)."""
    pos = _ar_position_index(z_prime.shape, z_prime.device)
    z = torch.zeros_like(z_prime)
    for t in range(_positions(z_prime)):
        m, s = ar_fn(z)
        z = torch.where(pos == t, _inverse_update(z_prime, m, s, gate_bias,
                                                  form), z)
    return z


def invert_ar_jacobi_host(ar_fn: ArFn, z_prime: torch.Tensor, iters: int,
                          form: str = "division", gate_bias: float = 0.0
                          ) -> torch.Tensor:
    """``invert_ar_jacobi`` as a host loop (the reference)."""
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


def invert_ar_fixed_point_host(ar_fn: ArFn, z_prime: torch.Tensor,
                               tol: float = 1e-6,
                               max_iters: int | None = None,
                               form: str = "division",
                               gate_bias: float = 0.0
                               ) -> tuple[torch.Tensor, int]:
    """``invert_ar_fixed_point`` as a host loop, each sweep's change read
    on the host (the reference)."""
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
