"""Noise discipline.

As in ``iaf_tpu.core.rng``, every stochastic site derives its randomness
from (seed, step or chunk counters, stable hash of the site path), never
from device layout. A key here is a plain 63-bit integer; ``fold`` mixes a
32-bit datum into it (splitmix64 finalizer) the way ``jax.random.fold_in``
does for threefry keys, and a site's draws come from a ``torch.Generator``
seeded with the folded key. The bits differ from JAX's threefry stream, so
parity tests inject JAX's draws through a ``noise`` dict keyed by site path
(``"block_3/layer_0/z_post"``). ``normal_into`` writes a site's draw into
a buffer that already exists (the noise buffers a captured CUDA graph of
the training step reads), with the same bits as ``site_normal``.

Data parallelism shares a batch's rows among ranks (``parallel/mesh.py``):
inside ``rows_of(rank, world)`` every draw is made at the global shape
(the leading, row dim ``world`` times the local one) and the rank keeps
its own contiguous rows, and an injected tensor must have the global
shape and is sliced the same way, so a row's noise is the same whatever
the number of ranks. Rows are images x k, interleaved, so a rank's
images own one slice.
"""

from __future__ import annotations

import contextlib
import contextvars
import zlib
from typing import Mapping, Sequence

import torch

_MASK64 = (1 << 64) - 1
# (rank, world): whose rows of the global draw the sites hand out
_ROWS: contextvars.ContextVar[tuple[int, int]] = contextvars.ContextVar(
    "iaf_torch_rows", default=(0, 1))


def stable_hash(name: str) -> int:
    """Deterministic 32-bit hash of a site path (crc32, as in JAX)."""
    return zlib.crc32(name.encode("utf-8"))


def fold(key: int, data: int) -> int:
    """Derive a new key from ``key`` and a non-negative integer."""
    x = (key * 0x9E3779B97F4A7C15 + (data & 0xFFFFFFFF) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1  # 63 bits: manual_seed takes a signed int64


def fold_name(key: int, name: str) -> int:
    return fold(key, stable_hash(name))


def generator(key: int, device: torch.device | str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(key)
    return g


@contextlib.contextmanager
def rows_of(rank: int, world: int):
    """Inside the block each site hands out rank ``rank``'s rows of the
    global draw over ``world`` ranks (see the module's docstring)."""
    token = _ROWS.set((rank, world))
    try:
        yield
    finally:
        _ROWS.reset(token)


def _global_shape(shape: Sequence[int]) -> tuple[int, ...]:
    world = _ROWS.get()[1]
    return (shape[0] * world,) + tuple(shape[1:])


def local_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """This rank's ``rows`` rows of the global tensor ``t``."""
    rank, world = _ROWS.get()
    if t.shape[0] != rows * world:
        raise ValueError(f"a global draw of {t.shape[0]} rows; {world} "
                         f"ranks of {rows} rows need {rows * world}")
    return t if world == 1 else t[rank * rows:(rank + 1) * rows]


def site_normal(key: int, site: str, shape: Sequence[int],
                device: torch.device | str,
                noise: Mapping[str, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """Standard-normal draw for ``site``: the injected tensor when
    ``noise`` has one, else a draw from the site's own generator (this
    rank's rows of either, ``rows_of``)."""
    want = _global_shape(shape)
    if noise is not None and site in noise:
        eps = torch.as_tensor(noise[site], dtype=torch.float32, device=device)
        if tuple(eps.shape) != want:
            raise ValueError(f"injected noise {site!r} has shape "
                             f"{tuple(eps.shape)}, want {want}")
        return local_rows(eps, shape[0])
    return local_rows(torch.randn(want, generator=generator(key, device),
                                  device=device, dtype=torch.float32),
                      shape[0])


def normal_into(key: int, out: torch.Tensor) -> torch.Tensor:
    """``site_normal``'s draw for ``key`` written into ``out`` (float32,
    contiguous): the same generator, the same bits (this rank's rows,
    ``rows_of``). Returns ``out``."""
    if _ROWS.get()[1] == 1:
        return torch.randn(tuple(out.shape),
                           generator=generator(key, out.device), out=out)
    full = torch.randn(_global_shape(out.shape),
                       generator=generator(key, out.device),
                       device=out.device, dtype=out.dtype)
    return out.copy_(local_rows(full, out.shape[0]))
