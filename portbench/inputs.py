"""Everything a run feeds both sides, made from ``--seed``.

- Images: a uint8 CIFAR-shaped set, on the host (the data feed's side),
  each image a random 8x8 colour field blown up to 32x32 plus noise.
- Weights: on the device, in a few large calls. Every V (and ``h_top``
  and the biases) comes from one draw of a generator on the card; each
  conv's g is set so that W = V / |V| * g * mask has norm ``init_scale``
  per output unit, which keeps unit-variance inputs at unit variance (the
  posterior statistics' convs at ``stat_init_scale``). ``dec_log_stdv``
  is 0, as the data-dependent init leaves it.
- Noise: the posterior draws, one flat standard-normal buffer per
  training step or per eval chunk, drawn by one call of a generator
  seeded from (seed, stream, index), and cut into one view per layer.

A seed may be any non-negative integer; keys are folded to 63 bits.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from portbench import reference as ref


def key(*parts) -> int:
    """A 63-bit key from the seed and counters (sha256 of their text)."""
    h = hashlib.sha256(":".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def images(seed: int, n: int, size: int = 32, channels: int = 3
           ) -> np.ndarray:
    """[n, size, size, channels] uint8, a pure function of the seed."""
    rng = np.random.default_rng(key(seed, "images"))
    base = rng.integers(0, 240, (n, size // 4, size // 4, channels),
                        dtype=np.int16)
    img = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)
    img += rng.integers(0, 16, img.shape, dtype=np.int16)
    return img.astype(np.uint8)


def weights(c: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The parameters by name (``reference.param_shapes``), f32 on
    ``device``."""
    shapes = ref.param_shapes(c)
    drawn = [n for n, s in shapes.items()
             if n.endswith((".V", ".b")) or n == "h_top"]
    total = sum(int(np.prod(shapes[n])) for n in drawn)
    g = torch.Generator(device=device)
    g.manual_seed(key(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for n in drawn:
        size = int(np.prod(shapes[n]))
        t = flat[off:off + size].view(shapes[n])
        off += size
        # biases and h_top small, V as drawn (only its direction counts)
        out[n] = t if n.endswith(".V") else t * 0.05
    masks = ref.masks(c, device)
    with torch.no_grad():
        for name, _, _, _, scale, masked in ref.conv_specs(c):
            V = out[name + ".V"]
            full = V.flatten(1).norm(dim=1)
            kept = (V * masks[name]).flatten(1).norm(dim=1) if masked \
                else full
            out[name + ".g"] = scale * full / kept
        out["x_dec.g"] = torch.ones(shapes["x_dec.g"], device=device)
        out["dec_log_stdv"] = torch.zeros((), device=device)
    return {n: out[n].contiguous() for n in shapes}


class NoiseStream:
    """Flat standard-normal buffers cut into per-layer views [rows, H/2,
    W/2, z]: ``draw(index)`` refills the one buffer with draw ``index``
    of this (seed, stream), layer i's view ``views[i]``."""

    def __init__(self, c: dict, seed: int, stream: str, rows: int, device):
        hw = c["image_size"] // 2
        self.shape = (rows, hw, hw, c["z_size"])
        self.per = int(np.prod(self.shape))
        self.seed, self.stream = seed, stream
        self.buf = torch.empty(self.per * ref.n_layers(c), device=device)
        self.gen = torch.Generator(device=device)
        self.views = [self.buf[i * self.per:(i + 1) * self.per]
                      .view(self.shape) for i in range(ref.n_layers(c))]

    def draw(self, index: int) -> list[torch.Tensor]:
        self.gen.manual_seed(key(self.seed, self.stream, index))
        self.buf.normal_(generator=self.gen)
        return self.views
