"""K1's backward on the tensor cores, the parts that run without a card:
the glue pass's plain twin against autograd of the twin's ELU step, its
packed G against ``masked_conv.wgrad_pack``, the route predicate, the glue
pass's blocking, and the whole data flow of the tensor-core backward
(dgrad per conv, glue between convs, wgrad per conv) composed from the
twins against autograd of K1's twin and of JAX's reference chain. The card
tests are in test_torch_kernels.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from iaf_tpu.ops.ar_stack import ar_stack_xla
from iaf_torch import ops
from iaf_torch.nn.masks import get_conv_ar_mask
from iaf_torch.ops import masked_conv as mc

# the module (``iaf_torch.ops.ar_stack`` is also the re-exported function)
k1 = importlib.import_module("iaf_torch.ops.ar_stack")

PAPER_SHAPES = ((32, 160), (160, 160), (160, 64))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _glue_inputs(shape, seed):
    rs = np.random.RandomState(seed)
    dx = _t(rs.randn(*shape).astype(np.float32)).bfloat16()
    pre = _t((2 * rs.randn(*shape)).astype(np.float32))
    return dx, pre


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 16, 16, 24)])
def test_glue_ref_is_autograd_of_the_elu_step(shape):
    """G = autograd of the twin's ELU step (``F.elu(pre).to(bf16)``, the
    next conv's input) for the bf16 dX, in f32 and rounded once to bf16;
    the wgrad input is that step's forward value; db sums G over the
    pixels (1e-5 of max: another summation order)."""
    dx, pre = _glue_inputs(shape, 3)
    gb, gp, g, x, db = k1.glue_ref(dx, pre)
    pre_ = pre.clone().requires_grad_()
    step = F.elu(pre_).to(torch.bfloat16)
    want = torch.autograd.grad(step, pre_, dx)[0]
    assert want.dtype == torch.float32
    torch.testing.assert_close(g, want, rtol=1e-6, atol=0.0)
    assert gb.dtype == torch.bfloat16
    assert torch.equal(gb, g.bfloat16())
    assert torch.equal(x, step.detach())
    torch.testing.assert_close(db, want.reshape(-1, shape[-1]).sum(0),
                               rtol=1e-5, atol=1e-5 * float(db.abs().max()))


@pytest.mark.parametrize("shape,hidden", [((2, 16, 16, 160), True),
                                          ((2, 16, 16, 64), False),
                                          ((1, 4, 8, 20), True)])
def test_glue_ref_packed_g_is_wgrad_pack(shape, hidden):
    """The glue's packed G, placed by the kernel's own store arithmetic
    (8 pixels of one channel per 16-byte store), equals
    ``masked_conv.wgrad_pack`` of its G element by element, zero columns
    past C included; the head (no pre) is G = f32(g) itself."""
    dx, pre = _glue_inputs(shape, 4)
    src = dx if hidden else dx.float()
    gb, gp, g, x, _ = k1.glue_ref(src, pre if hidden else None)
    assert (x is None) != hidden
    if not hidden:
        assert torch.equal(g, src)
    want = mc.wgrad_pack(g)
    assert gp.shape == want.shape and gp.dtype == want.dtype
    assert torch.equal(gp, want)


def test_bwd_route_predicate():
    """The tensor cores at the paper widths in bf16 (W = 16, convs 32->160,
    160->160, 160->64, batch maps of whole 8-row sub-tiles); FMA for f32,
    for W = 6, for an H that is not whole sub-tiles and for input channels
    that are not whole blocks of 32."""
    bf16 = torch.bfloat16
    assert k1.bwd_wgmma_path(bf16, 16, 16, PAPER_SHAPES)
    assert k1.bwd_wgmma_path(bf16, 16, 16, PAPER_SHAPES[:1] + PAPER_SHAPES[1:2]
                             * 3 + PAPER_SHAPES[2:])          # depth_ar=4
    assert not k1.bwd_wgmma_path(torch.float32, 16, 16, PAPER_SHAPES)
    assert not k1.bwd_wgmma_path(bf16, 6, 6, PAPER_SHAPES)
    assert not k1.bwd_wgmma_path(bf16, 12, 16, PAPER_SHAPES)
    assert not k1.bwd_wgmma_path(bf16, 16, 16, ((16, 160), (160, 160),
                                                (160, 32)))
    assert not k1.bwd_wgmma_path(bf16, 16, 16, ((32, 48), (48, 48),
                                                (48, 64)))
    # the route of a chain the predicate refuses needs no built library
    z = torch.empty(2, 6, 6, 4, dtype=bf16)
    ws = [torch.empty(3, 3, 4, 8, dtype=bf16),
          torch.empty(3, 3, 8, 8, dtype=bf16)]
    assert k1.bwd_route(z, ws) == (("fma", "fma"),) * 2
    assert k1.MIRRORED_TAPS == ((2, 2), (2, 1), (2, 0), (1, 2), (1, 1))


@pytest.mark.parametrize("pixels,npad", [(8192, 160), (8192, 64),
                                         (128, 32), (16 * 6 * 6 * 4, 256)])
def test_glue_blocks_cover_the_pixels(pixels, npad):
    """Every group of 8 pixels in exactly one block, one group a thread
    row, no block empty, at most 512 threads a block (the db partials'
    rows are the blocks)."""
    per, blocks = k1.glue_blocks(pixels, npad)
    groups = pixels // 8
    assert per >= 1 and per * blocks >= groups > per * (blocks - 1)
    assert per * npad <= k1._GLUE_THREADS


@pytest.mark.parametrize("shapes", [PAPER_SHAPES, ((16, 32), (32, 48))])
def test_dgrad_pack_kernel_arithmetic(shapes):
    """The pack kernel's item decoding, in plain torch: item i of conv c
    is (t, s, j, h, n) with its 8 k values the 16 bytes at W[t][8 j + n]
    [16 s + 8 h ..], stored at 16-byte slot i, zero for 8 j + n >= cin.
    That equals ``pack_dgrad_ref`` (``masked_conv.wgmma_pack`` of the
    transposed live taps) element for element; the live taps are the
    first 5 of HWIO's 9."""
    rs = np.random.RandomState(13)
    ws = [_t(rs.randn(3, 3, ci, co).astype(np.float32)) for ci, co in shapes]
    ref = k1.pack_dgrad_ref(ws)
    for w, want in zip(ws, ref):
        cin, cout = w.shape[2], w.shape[3]
        npad = mc.wgmma_width(cin)
        items = 5 * (cout // 8) * npad
        got = torch.zeros(items, 8)
        live = w.reshape(9, cin, cout)[:5]
        for i in range(items):
            r = i
            n, r = r & 7, r >> 3
            h, r = r & 1, r >> 1
            j, r = r % (npad // 8), r // (npad // 8)
            s_, t = r % (cout // 16), r // (cout // 16)
            if 8 * j + n < cin:
                co = 16 * s_ + 8 * h
                got[i] = live[t, 8 * j + n, co:co + 8]
        assert want.shape == (5, cout // 16, npad // 8, 2, 8, 8)
        assert torch.equal(got.reshape(want.shape), want)
        for t, (dy, dx) in enumerate(k1.LIVE_TAPS):
            assert torch.equal(live[t], w[dy, dx])


def _chain(seed, zs, hs, n, hw, depth_ar=2):
    rs = np.random.RandomState(seed)
    ws, bs, masks, prev = [], [], [], zs
    for i in range(depth_ar + 1):
        if i < depth_ar:
            m, cout = get_conv_ar_mask(3, 3, prev, hs, i == 0), hs
        else:
            m = np.concatenate([get_conv_ar_mask(3, 3, hs, zs, False)] * 2,
                               -1)
            cout = 2 * zs
        ws.append((rs.randn(3, 3, prev, cout) / np.sqrt(5 * prev) * m
                   ).astype(np.float32))
        bs.append((0.1 * rs.randn(cout)).astype(np.float32))
        masks.append(m)
        prev = hs
    z = rs.randn(n, hw, hw, zs).astype(np.float32)
    c = rs.randn(n, hw, hw, hs).astype(np.float32)
    g = rs.randn(n, hw, hw, 2 * zs).astype(np.float32)
    return z, c, ws, bs, masks, g


def _composed_bwd(z, ctx, ws, bs, g):
    """The tensor-core backward's data flow with each kernel replaced by
    its twin: the head's G through the glue; per conv, head first, dgrad
    (K2's conv twin's input gradient over the live taps, bf16 out) and, for
    a hidden conv, the glue on its pre-activation, giving the next G, the
    conv's own wgrad input and the next db; then per conv wgrad (K2's
    weight gradient twin on that input and G) and db from the G that the
    glue (or the head pass) summed. In f32 (the kernels' FMA route)
    nothing is rounded to bf16 on the way."""
    pre, h = [], z
    for i, (w, b) in enumerate(zip(ws[:-1], bs[:-1])):
        a = k1.conv_nhwc(h.to(w.dtype), w[:2], ((1, 0), (1, 1))) + b
        if i == 0:
            a = a + ctx
        pre.append(a)
        h = F.elu(a)
    bf16 = z.dtype == torch.bfloat16
    gb, _, gf, _, db = k1.glue_ref(g)
    feeds, dctx = [None] * len(ws), None
    for c in reversed(range(len(ws))):
        w = ws[c]
        x_in = torch.zeros(z.shape[:3] + (w.shape[2],), dtype=w.dtype)
        dx = mc.masked_conv2d_bwd_ref(x_in, w, gb.float() if bf16 else gf,
                                      k1.LIVE_TAPS)[0]
        if c == 0:
            feeds[0] = (z, gf, db)
            break
        gb, _, g_next, x, db_next = k1.glue_ref(dx, pre[c - 1])
        if not bf16:     # the f32 chain's conv input is not rounded
            x = F.elu(pre[c - 1])
        feeds[c] = (x, gf, db)
        gf, db = g_next, db_next
        if c == 1:
            dctx = g_next
    dws = [mc.masked_conv2d_bwd_ref(x, w, gg, k1.LIVE_TAPS)[1]
           for w, (x, gg, _) in zip(ws, feeds)]
    return dx, dctx, dws, [d for _, _, d in feeds]


def test_tensor_core_data_flow_matches_autograd_of_the_twin():
    """The composition, bf16 as on the card (G rounded to bf16 where the
    kernels round it), against autograd of K1's twin in bf16: dz and dW
    within one bf16 rounding of each output's max (2e-2, the card's
    limit; the two conv formulations sum in other orders), dcontext and
    db at 1e-5 of max (f32 glue on equal dX). In f32 the composition
    (without the bf16 casts) equals JAX's VJP of its XLA reference chain
    at 1e-5: which G, input and sum feeds each conv is the reference's."""
    z, c, ws, bs, masks, g = _chain(5, 16, 32, 2, 8)
    bf = torch.bfloat16
    zt, ct, gt = _t(z).to(bf), _t(c), _t(g)
    wt = [_t(w).to(bf) for w in ws]
    bt = [_t(b) for b in bs]
    got = _composed_bwd(zt, ct, wt, bt, gt)
    rz, rc, rws, rbs = ops.ar_stack_bwd_ref(zt, ct, wt, bt, gt)
    live = torch.zeros(3, 3, 1, 1)
    live[0], live[1, :2] = 1.0, 1.0
    pairs = [(got[0], rz, 2e-2), (got[1], rc, 1e-5)]
    pairs += [(a * live, b.float() * live, 2e-2)
              for a, b in zip(got[2], rws)]
    pairs += [(a, b, 1e-5) for a, b in zip(got[3], rbs)]
    for a, b, tol in pairs:
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (err, tol)

    wb = [jnp.asarray(a) for pair in zip(ws, bs) for a in pair]
    _, vjp = jax.vjp(ar_stack_xla, jnp.asarray(z), jnp.asarray(c), *wb)
    want = vjp(jnp.asarray(g))      # dz, dcontext, dW0, db0, dW1, ...
    got32 = _composed_bwd(_t(z), ct, [_t(w) for w in ws], bt, gt)
    flat = [got32[0], got32[1]] + [a for pair in zip(got32[2], got32[3])
                                   for a in pair]
    for i, (a, b) in enumerate(zip(flat, want)):
        b = torch.from_numpy(np.array(b))
        if i >= 2 and i % 2 == 0:
            a, b = a * live, b * live
        torch.testing.assert_close(a.float(), b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
