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
"""

from __future__ import annotations

import zlib
from typing import Mapping, Sequence

import torch

_MASK64 = (1 << 64) - 1


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


def site_normal(key: int, site: str, shape: Sequence[int],
                device: torch.device | str,
                noise: Mapping[str, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """Standard-normal draw for ``site``: the injected tensor when
    ``noise`` has one, else a draw from the site's own generator."""
    if noise is not None and site in noise:
        eps = torch.as_tensor(noise[site], dtype=torch.float32, device=device)
        if tuple(eps.shape) != tuple(shape):
            raise ValueError(f"injected noise {site!r} has shape "
                             f"{tuple(eps.shape)}, want {tuple(shape)}")
        return eps
    return torch.randn(tuple(shape), generator=generator(key, device),
                       device=device, dtype=torch.float32)


def normal_into(key: int, out: torch.Tensor) -> torch.Tensor:
    """``site_normal``'s draw for ``key`` written into ``out`` (float32,
    contiguous): the same generator, the same bits. Returns ``out``."""
    return torch.randn(tuple(out.shape), generator=generator(key, out.device),
                       out=out)
