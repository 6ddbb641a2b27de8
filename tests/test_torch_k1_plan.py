"""K1's forward launch plan (``ops.ar_stack.fwd_plan``): the grid it asks
for at the paper widths and image counts from the inversion's 2 to the
eval chunk's 1024, and a plain model of the tensor-core kernel's walk on
a plan (row bands whose tiles compute again the rows above that the
chain reaches back to) against K1's twin and JAX's ``ar_stack_xla``. The card runs the plans themselves in
test_torch_kernels.py and chip_smoke.py."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from iaf_tpu.ops.ar_stack import ar_stack_xla
from iaf_torch import ops
from iaf_torch.nn.masks import get_conv_ar_mask

k1 = importlib.import_module("iaf_torch.ops.ar_stack")
SMS = 132               # an H100 SXM's
PAPER = (16, 16, 32, 160, 64, 3)    # h, w, cz, ch, cout, convs
TOL = dict(rtol=1e-5, atol=1e-5)


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,n,band,blocks", [
    (F32, 1, 6, 3), (F32, 2, 6, 6), (F32, 16, 6, 48), (F32, 32, 6, 96),
    (F32, 131, 16, 131), (F32, 132, 16, 132), (F32, 1024, 16, 132),
    (BF16, 1, 6, 3), (BF16, 2, 6, 6), (BF16, 16, 6, 48), (BF16, 32, 6, 96),
    (BF16, 131, 16, 131), (BF16, 132, 16, 132), (BF16, 1024, 16, 132)])
def test_fwd_plan_grid(dtype, n, band, blocks):
    """At the paper widths (3 convs): bands of 6 rows (3 an image, one
    tile each) while they leave a block fewer tiles than whole images
    do; the whole-image plan from 45 images on (N = 1024 included). No
    plan asks for more blocks than the card has SMs (the kernel's shared
    memory holds one block an SM)."""
    plan = k1.fwd_plan(dtype, n, *PAPER, SMS)
    assert tuple(plan) == (band, blocks)
    assert plan.blocks <= SMS
    if band == 16:
        assert plan == k1.whole_plan(n, 16, SMS)
    else:
        items = n * -(-16 // band)
        assert plan.blocks == min(items, SMS)
        assert band + PAPER[-1] - 1 <= 8     # one tile an item


def test_fwd_plan_edges():
    """The FMA route keeps one block an image; a chain too deep for a
    one-tile band keeps the whole-image plan; a deeper chain takes
    narrower bands; f32 with cz in 8-deep steps takes bands as bf16
    does; a card with fewer SMs caps the blocks; shapes decide the plan
    alone (cached)."""
    assert k1.fwd_plan(torch.float32, 2, 16, 12, 32, 160, 64, 3, SMS) == (
        k1.FwdPlan(16, 2))
    assert k1.fwd_plan(torch.bfloat16, 2, 16, 16, 32, 160, 64, 9,
                       SMS) == k1.whole_plan(2, 16, SMS)
    assert k1.fwd_plan(torch.bfloat16, 32, 16, 16, 32, 160, 64, 5,
                       SMS) == k1.FwdPlan(4, 128)
    assert k1.fwd_plan(torch.float32, 2, 16, 16, 24, 160, 64, 3,
                       SMS) == k1.FwdPlan(6, 6)
    # 32-row images on 64 SMs: 96 bands, two a block, against four tiles
    assert k1.fwd_plan(torch.bfloat16, 16, 32, 16, 32, 160, 64, 3,
                       64) == k1.FwdPlan(6, 64)
    assert k1.fwd_plan(torch.bfloat16, 2, *PAPER, SMS) is k1.fwd_plan(
        torch.bfloat16, 2, *PAPER, SMS)


def _inputs(zs, hs, n, depth_ar, seed):
    rs = np.random.RandomState(seed)
    z = rs.randn(n, 16, 16, zs).astype(np.float32)
    c = rs.randn(n, 16, 16, hs).astype(np.float32)
    ws, bs, prev = [], [], zs
    for i in range(depth_ar):
        m = get_conv_ar_mask(3, 3, prev, hs, zerodiagonal=(i == 0))
        ws.append((rs.randn(3, 3, prev, hs) / np.sqrt(5 * prev) * m
                   ).astype(np.float32))
        bs.append((0.1 * rs.randn(hs)).astype(np.float32))
        prev = hs
    m = np.concatenate([get_conv_ar_mask(3, 3, hs, zs, False)] * 2, -1)
    ws.append((rs.randn(3, 3, hs, 2 * zs) / np.sqrt(5 * hs) * m
               ).astype(np.float32))
    bs.append((0.1 * rs.randn(2 * zs)).astype(np.float32))
    return z, c, ws, bs


def _plan_walk(z, ctx, weights, biases, plan, rows=8, seed=0):
    """A plain model of ``ar_stack_wgmma_kernel``'s walk on ``plan``:
    items of ``plan.band`` rows [r0, r1) of one image, each walked as
    tiles of ``rows`` rows from t0 = max(0, r0 - (convs - 1)). Per conv a
    tile's input is its rows with a zero column each side and the row
    above: z's read again, a hidden conv's the halo carried from the last
    tile of the item; at an item's first tile the halo is zeros where t0
    = 0 (the image's padding) and, where t0 > 0, garbage here (the kernel
    leaves zeros: either way rows it spoils lie above r0). Rows past the
    image get garbage context (the kernel's stale ring stage). Heads and
    pre-activations are
    stored for rows r0 .. r1 - 1 only; each row must be stored once.
    Products in f32 of inputs in the weights' dtype; bias, context and ELU
    in f32. Returns (heads, [pre-activations])."""
    gen = torch.Generator().manual_seed(seed)
    n, hh, ww, cz = z.shape
    dt = weights[0].dtype
    wts = [w.float() for w in weights]
    nc, ch = len(weights), weights[0].shape[-1]
    couts = [w.shape[-1] for w in weights]
    out = torch.zeros(n, hh, ww, couts[-1])
    pre = [torch.zeros(n, hh, ww, ch) for _ in range(nc - 1)]
    stored = torch.zeros(n, hh, dtype=torch.int64)
    bands = -(-hh // plan.band)
    taps = ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1))
    for item in range(n * bands):
        img, b = divmod(item, bands)
        r0 = b * plan.band
        r1 = min(hh, r0 + plan.band)
        t0 = max(0, r0 - (nc - 1))
        tiles = -(-(r1 - t0) // rows)
        halo = [torch.zeros(ww + 2, ch) if t0 == 0 else
                torch.randn(ww + 2, ch, generator=gen) for _ in range(nc)]
        for tile in range(tiles):
            y0 = t0 + tile * rows
            keep = [i for i in range(rows) if r0 <= y0 + i < r1]
            zb = torch.zeros(rows + 1, ww + 2, cz)
            for i in range(rows + 1):
                if 0 <= y0 - 1 + i < hh:
                    zb[i, 1:ww + 1] = z[img, y0 - 1 + i].to(dt).float()
            above, here = zb[:-1], zb[1:]
            for c in range(nc):
                acc = sum((above if dy == 0 else here)[:, dx:dx + ww]
                          @ wts[c][dy, dx] for dy, dx in taps) + biases[c]
                if c == 0:
                    for i in range(rows):
                        acc[i] += (ctx[img, y0 + i] if y0 + i < hh else
                                   torch.randn(ww, couts[0], generator=gen))
                if c == nc - 1:
                    for i in keep:
                        out[img, y0 + i] = acc[i]
                        stored[img, y0 + i] += 1
                    break
                for i in keep:
                    pre[c][img, y0 + i] = acc[i]
                here = torch.zeros(rows, ww + 2, ch)
                here[:, 1:ww + 1] = F.elu(acc).to(dt).float()
                above = torch.cat([halo[c + 1][None], here[:-1]])
                halo[c + 1] = here[-1].clone()
    assert bool((stored == 1).all()), stored
    return out, pre


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth_ar", [2, 4])
@pytest.mark.parametrize("band", [None, 16, 12, 3, 2, 1])
def test_plan_walk_matches_twin_and_jax(dtype, depth_ar, band):
    """The walk on the banded plan (bands of 9 - convs rows: 6 at
    depth_ar 2, 4 at depth_ar 4), on the whole-image plan, on bands of 12
    rows (two tiles, the halo carried between them) and of 3, 2 and 1
    (several bands a tile's reach): heads and pre-activations in
    f32 against the twin and the heads against JAX's ``ar_stack_xla`` at
    1e-5; in bf16 against the twin at the card's tolerance (2e-2 of each
    one's max)."""
    zs, hs = 16, 32
    z, c, ws, bs = _inputs(zs, hs, 2, depth_ar, seed=depth_ar)
    args = (torch.from_numpy(z).to(dtype), torch.from_numpy(c),
            [torch.from_numpy(w).to(dtype) for w in ws],
            [torch.from_numpy(b) for b in bs])
    nc = depth_ar + 1
    plan = k1.FwdPlan(band=band or 8 + 1 - nc, blocks=0)
    out, pre = _plan_walk(*args, plan)
    rout, rpre = ops.ar_stack_ref_pre(*args)
    for got, want in zip([out, *pre], [rout, *rpre]):
        if dtype == torch.bfloat16:
            err = float((got - want.float()).abs().max())
            assert err <= 2e-2 * float(want.float().abs().max()), err
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    if dtype == torch.float32:
        wb = [jnp.asarray(t) for pair in zip(ws, bs) for t in pair]
        want = np.asarray(ar_stack_xla(jnp.asarray(z), jnp.asarray(c), *wb))
        np.testing.assert_allclose(out.numpy(), want, **TOL)
