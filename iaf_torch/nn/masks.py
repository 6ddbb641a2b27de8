"""MADE autoregressive mask builders, bitwise equal to ``iaf_tpu.nn.masks``.

Latent channels are ordered 0..z-1 within a pixel and pixels in raster
order; ``zerodiagonal=True`` forbids an output from seeing its own channel
group at its own pixel. Masks are numpy constants (HWIO for convs).
"""

from __future__ import annotations

import numpy as np


def get_linear_ar_mask(n_in: int, n_out: int, zerodiagonal: bool = False) -> np.ndarray:
    """[n_in, n_out] 0/1 mask making a dense layer autoregressive over
    channel order (MADE with evenly strided degrees)."""
    assert n_in % n_out == 0 or n_out % n_in == 0, (n_in, n_out)
    mask = np.ones((n_in, n_out), dtype=np.float32)
    if n_out >= n_in:
        k = n_out // n_in
        for i in range(n_in):
            mask[i + 1:, i * k:(i + 1) * k] = 0.0
            if zerodiagonal:
                mask[i:i + 1, i * k:(i + 1) * k] = 0.0
    else:
        k = n_in // n_out
        for i in range(n_out):
            mask[(i + 1) * k:, i:i + 1] = 0.0
            if zerodiagonal:
                mask[i * k:(i + 1) * k, i:i + 1] = 0.0
    return mask


def get_conv_ar_mask(h: int, w: int, n_in: int, n_out: int,
                     zerodiagonal: bool = False) -> np.ndarray:
    """[h, w, n_in, n_out] 0/1 conv mask: taps before the centre in raster
    order pass everything, taps after it nothing, and the centre tap gets
    the linear channel mask."""
    l = (h - 1) // 2
    m = (w - 1) // 2
    mask = np.ones((h, w, n_in, n_out), dtype=np.float32)
    mask[l + 1:, :, :, :] = 0.0
    mask[l, m + 1:, :, :] = 0.0
    mask[l, m, :, :] = get_linear_ar_mask(n_in, n_out, zerodiagonal)
    return mask


def nonzero_taps(mask: np.ndarray) -> tuple[tuple[int, int], ...]:
    """(dy, dx) taps of an HWIO mask with any nonzero weight."""
    kh, kw = mask.shape[:2]
    flat = mask.reshape(kh, kw, -1)
    return tuple((dy, dx) for dy in range(kh) for dx in range(kw)
                 if flat[dy, dx].any())
