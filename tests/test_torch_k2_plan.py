"""K2's forward launch plan (``iaf_torch.ops.masked_conv.fwd_plan``): the
grid it picks from the shapes alone (128-pixel tiles, or 64-pixel tiles of
one warpgroup where the 128-pixel ones leave SMs idle), and a plain torch
model of the tensor-core kernel's walk over its tiles (staged rows with
their halo, the live taps in order, K in the kernel's slice depth) held to
the twin and to the JAX package's Pallas kernel (interpret mode) and
``xla_conv2d_same`` on the same numpy inputs (f32, 1e-5). Needs no card
and no built library."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from iaf_tpu.ops.masked_conv import masked_conv2d as j_masked_conv2d
from iaf_tpu.ops.masked_conv import xla_conv2d_same
from iaf_torch import ops
from iaf_torch.nn.masks import get_conv_ar_mask, nonzero_taps
from iaf_torch.ops import masked_conv as mc
from iaf_torch.ops.masked_conv import FwdPlan

SMS = 132          # an H100 SXM's SMs
TOL = dict(rtol=1e-5, atol=1e-5)

# (N, W) -> the plan at H = W, cin = cout = 160 (either dtype), 132 SMs
PLANS = {
    16: {1: (64, 4), 2: (64, 8), 16: (64, 64), 32: (64, 128),
         64: (128, 128), 1024: (128, 132)},
    32: {1: (64, 16), 2: (64, 32), 16: (128, 128), 32: (128, 132),
         64: (128, 132), 1024: (128, 132)},
    64: {1: (64, 64), 2: (64, 128), 16: (128, 132), 32: (128, 132),
         64: (128, 132), 1024: (128, 132)},
    128: {1: (128, 128), 2: (128, 132), 16: (128, 132), 32: (128, 132),
          64: (128, 132), 1024: (128, 132)},
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w", sorted(PLANS))
@pytest.mark.parametrize("n", [1, 2, 16, 32, 64, 1024])
def test_fwd_plan_grid(dtype, w, n):
    """The tile and blocks of each shape: the training step's batch 32 at
    W = 16 takes 128 tiles of 64 pixels; N = 1024 and W = 128 keep
    128-pixel tiles; where 64-pixel tiles leave a block no less to walk
    (N = 16 at W = 32, N = 64 at W = 16) the 128-pixel plan stays."""
    tile, blocks = PLANS[w][n]
    plan = mc.fwd_plan(dtype, n, w, w, 160, 160, SMS)
    assert plan == FwdPlan(tile, blocks)
    assert plan == mc.tile_plan(n, w, w, tile, SMS)


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_fwd_plan_rule(sms):
    """Over image counts and heights: 128-pixel tiles wherever n*h*w /
    128 >= SMs or W = 128, else 64-pixel tiles exactly where each block
    then walks one of them; the blocks never exceed the SMs."""
    for w in (16, 32, 64, 128):
        for h in (w, w + 3):
            for n in range(1, 3 * sms, 7):
                plan = mc.fwd_plan(torch.bfloat16, n, h, w, 32, 160, sms)
                assert plan.blocks <= sms
                tiles64 = n * -(-h // max(1, 64 // w))
                if n * h * w // 128 >= sms or w == 128:
                    assert plan == mc.tile_plan(n, h, w, 128, sms)
                else:
                    assert (plan.tile_pixels == 64) == (tiles64 <= sms)
                    assert plan.blocks == min(
                        n * -(-h // (plan.tile_pixels // w)), sms)


def test_fwd_plan_leaves_the_fma_route_alone(monkeypatch):
    """Shapes no tensor-core kernel tiles get no plan (``FwdPlan(0, 0)``,
    which the FMA kernel does not read) and, with any stage count, still
    route to ``"fma"``; the tensor-core shapes keep their routes, whatever
    plan their launch takes."""
    class Lib:
        @staticmethod
        def masked_conv_wgmma_stages(*args):
            return 8
    mc._route.cache_clear()
    monkeypatch.setattr(mc, "_lib", lambda: Lib)
    try:
        for dtype, w, cin, cout in ((torch.bfloat16, 48, 32, 160),
                                    (torch.bfloat16, 16, 24, 160),
                                    (torch.float32, 16, 160, 256),
                                    (torch.float32, 16, 8, 64)):
            assert mc.fwd_plan(dtype, 32, 16, w, cin, cout, SMS) == (0, 0)
            x = torch.empty(32, 16, w, cin, dtype=dtype)
            assert mc.fwd_route(x, torch.empty(5, 5, cin, cout,
                                               dtype=dtype)) == "fma"
        for dtype, route in ((torch.bfloat16, "wgmma"),
                             (torch.float32, "3xtf32")):
            x = torch.empty(32, 16, 16, 160, dtype=dtype)
            assert mc.fwd_plan(dtype, 32, 16, 16, 160, 64, SMS) == (64, 128)
            assert mc.fwd_route(x, torch.empty(5, 5, 160, 64,
                                               dtype=dtype)) == route
    finally:
        mc._route.cache_clear()


def _tile_walk(x, live, taps, kh, kw, tile_pixels, depth):
    """The tensor-core forward's walk in plain torch (f32): per tile of
    ``tile_pixels`` (tile_pixels / W whole rows of one image, the last
    tile of an image cut at its bottom) the staged rows, tile rows + the
    taps' row span with the SAME halo (zero rows outside the image, pw
    zero columns each side), then for each live tap in ``taps`` order and
    each ``depth``-deep K slice (32 in bf16, 16 in f32) acc += the
    shifted rows' slice @ the tap's weight slice; the tile's rows out."""
    n, h, w_, cin = x.shape
    cout = live.shape[-1]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    dys = [dy for dy, _ in taps]
    dy_lo, span = min(dys), max(dys) - min(dys)
    tr = tile_pixels // w_
    out = torch.zeros(n, h, w_, cout)
    for img in range(n):
        for y0 in range(0, h, tr):
            staged = torch.zeros(tr + span, w_ + 2 * pw, cin)
            for r in range(tr + span):
                yy = y0 + dy_lo - ph + r
                if 0 <= yy < h:
                    staged[r, pw:pw + w_] = x[img, yy]
            acc = torch.zeros(tr, w_, cout)
            for t, (dy, dx) in enumerate(taps):
                rows = staged[dy - dy_lo:dy - dy_lo + tr, dx:dx + w_]
                for k0 in range(0, cin, depth):
                    acc += rows[..., k0:k0 + depth] @ live[t, k0:k0 + depth]
            keep = min(tr, h - y0)
            out[img, y0:y0 + keep] = acc[:keep]
    return out


@functools.lru_cache(maxsize=None)
def _case(k, shape, cout):
    """Inputs from a seed (a raster AR mask, zero diagonal) and the JAX
    Pallas kernel's and ``xla_conv2d_same``'s outputs on them."""
    rs = np.random.RandomState(100 * k + shape[2])
    x = rs.randn(*shape).astype(np.float32)
    m = get_conv_ar_mask(k, k, shape[-1], cout, True)
    w = (rs.randn(k, k, shape[-1], cout) / np.sqrt(k * shape[-1]) * m
         ).astype(np.float32)
    pallas = np.asarray(j_masked_conv2d(jnp.asarray(x), jnp.asarray(w)))
    xla = np.asarray(xla_conv2d_same(jnp.asarray(x), jnp.asarray(w)))
    return x, w, m, pallas, xla


# W = 16, 32 and 64 (64-pixel tiles of 4, 2 and 1 rows; H cut so the last
# tile of an image is short), cin a whole number of 16-deep steps but not
# always of 32-deep slices
WALK_SHAPES = [((2, 6, 16, 48), 16), ((1, 3, 32, 16), 32),
               ((1, 3, 64, 32), 64)]


@pytest.mark.parametrize("depth", [32, 16])
@pytest.mark.parametrize("tile_pixels", [64, 128])
@pytest.mark.parametrize("shape,cout", WALK_SHAPES)
@pytest.mark.parametrize("k", [3, 5])
def test_tile_walk_matches_twin_and_jax(k, shape, cout, tile_pixels, depth):
    """The walk on 64- and 128-pixel tiles, in bf16's and f32's slice
    depths, against the twin and JAX's Pallas kernel and XLA conv at 1e-5
    (f32 throughout: the point is the tiling, halo and tap order)."""
    x, w, m, pallas, xla = _case(k, shape, cout)
    taps = nonzero_taps(m)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = _tile_walk(tx, mc._live(tw, taps), taps, k, k, tile_pixels, depth)
    twin = ops.masked_conv2d_ref(tx, tw, taps)
    torch.testing.assert_close(got, twin, **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    np.testing.assert_allclose(got.numpy(), xla, **TOL)


def test_tile_walk_stages_the_halo_rows():
    """A 64-pixel tile at W = 16 stages 4 + span rows (6 for the 5x5
    raster mask's live taps, 10 for a 128-pixel tile): every output row
    of an image reads the rows above it and, with a full kernel, the rows
    below, zeros past the image's edges, as the all-taps conv does."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(1, 9, 16, 16).astype(np.float32))
    w = torch.from_numpy(rs.randn(5, 5, 16, 8).astype(np.float32))
    taps = tuple((dy, dx) for dy in range(5) for dx in range(5))
    full = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=2).permute(0, 2, 3, 1)
    for tile in (64, 128):
        got = _tile_walk(x, mc._live(w, taps), taps, 5, 5, tile, 16)
        torch.testing.assert_close(got, full, **TOL)
    raster = nonzero_taps(get_conv_ar_mask(5, 5, 16, 8, False))
    assert mc._span(raster) == 2 and len(raster) == 13
