"""K1's backward on the tensor cores, bf16 and f32 (3xTF32), the parts
that run without a card: the glue pass's plain twin against autograd of
the twin's ELU step, its packed G against ``masked_conv.wgrad_pack``, the
weight pack's twin and its kernel's index arithmetic, the route
predicates and routes, the glue pass's blocking, and the whole data flow
of the tensor-core backward (dgrad per conv, glue between convs, wgrad
per conv, each reading the packed layouts) composed from the twins
against autograd of K1's twin and of JAX's reference chain. The card
tests of the f32 route are at the end (they skip without a card); the
others are in test_torch_kernels.py."""

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
from test_torch_kernels import cuda  # noqa: F401  (the card fixture)
from test_torch_masked_conv_f32 import _FakeLib, fake_libs  # noqa: F401

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
    # f32: K2's 3xTF32 kernels at the paper widths (and depth_ar=4), not
    # for bf16, W = 6, H not whole 4-row (64-pixel) sub-tiles or input
    # channels not in whole blocks of 32; W = 48 is no tile width
    f32 = torch.float32
    assert k1.bwd_tf32_path(f32, 16, 16, PAPER_SHAPES)
    assert k1.bwd_tf32_path(f32, 16, 16, PAPER_SHAPES[:1] + PAPER_SHAPES[1:2]
                            * 3 + PAPER_SHAPES[2:])
    assert not k1.bwd_tf32_path(bf16, 16, 16, PAPER_SHAPES)
    assert not k1.bwd_tf32_path(f32, 6, 6, PAPER_SHAPES)
    assert not k1.bwd_tf32_path(f32, 6, 16, PAPER_SHAPES)
    assert not k1.bwd_tf32_path(f32, 48, 48, PAPER_SHAPES)
    assert not k1.bwd_tf32_path(f32, 16, 16, ((16, 160), (160, 160),
                                              (160, 32)))
    assert not k1.bwd_tf32_path(f32, 16, 16, ((32, 48), (48, 48), (48, 64)))
    assert not k1.bwd_tf32_path(f32, 16, 16, ((32, 256), (256, 256),
                                              (256, 64)))      # N over 160
    # the route of a chain the predicate refuses needs no built library
    z = torch.empty(2, 6, 6, 4, dtype=bf16)
    ws = [torch.empty(3, 3, 4, 8, dtype=bf16),
          torch.empty(3, 3, 8, 8, dtype=bf16)]
    assert k1.bwd_route(z, ws) == (("fma", "fma"),) * 2
    assert k1.bwd_route(z.float(), [w.float() for w in ws]) == (
        ("fma", "fma"),) * 2
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


def _unpack(packed, n):
    """``masked_conv.wgmma_pack``'s inverse: [taps, K/2e, npad/8, 2, 8, e]
    -> [taps, K, n] (the zero columns past n dropped)."""
    taps, ks, jn, _, _, e = packed.shape
    return packed.permute(0, 1, 3, 5, 2, 4).reshape(
        taps, ks * 2 * e, jn * 8)[..., :n]


def _composed_bwd(z, ctx, ws, bs, g):
    """The tensor-core backward's data flow with each kernel replaced by
    its twin, in z's dtype (bf16, or f32 as the 3xTF32 route runs it), each
    product reading the packed operands the kernels read: the head's G
    through the glue; per conv, head first, dgrad (K2's conv twin's input
    gradient over the live taps, on the weights unpacked from
    ``pack_dgrad_ref``, dX in z's dtype) and, for a hidden conv, the glue
    on its pre-activation, giving the next G, the conv's own wgrad input
    and the next db; then per conv wgrad (K2's weight gradient twin on
    that input and the G unpacked from the glue's packed G) and db from
    the G that the glue (or the head pass) summed. In f32 nothing is
    rounded to bf16 on the way."""
    f32 = z.dtype == torch.float32
    pre, h = [], z
    for i, (w, b) in enumerate(zip(ws[:-1], bs[:-1])):
        a = k1.conv_nhwc(h.to(w.dtype), w[:2], ((1, 0), (1, 1))) + b
        if i == 0:
            a = a + ctx
        pre.append(a)
        h = F.elu(a)
    wts = [_unpack(p, w.shape[2]) for p, w in
           zip(k1.pack_dgrad_ref(ws, f32), ws)]      # [5, cout, cin]
    gt, gp, _, _, db = k1.glue_ref(g, f32=f32)
    feeds, dctx = [None] * len(ws), None
    for c in reversed(range(len(ws))):
        w = ws[c]
        cin, cout = w.shape[2], w.shape[3]
        w_packed = torch.zeros_like(w)
        w_packed.view(9, cin, cout)[:5] = wts[c].transpose(1, 2)
        x_in = torch.zeros(z.shape[:3] + (cin,), dtype=w.dtype)
        dx = mc.masked_conv2d_bwd_ref(x_in, w_packed, gt.float(),
                                      k1.LIVE_TAPS)[0]
        if c == 0:
            feeds[0] = (z, gp, db)
            break
        gt, gp_next, g_next, x, db_next = k1.glue_ref(dx, pre[c - 1],
                                                      f32=f32)
        feeds[c] = (x, gp, db)
        gp, db = gp_next, db_next
        if c == 1:
            dctx = g_next
    dws = [mc.masked_conv2d_bwd_ref(
        x, w, _unpack(p, w.shape[3]).reshape(z.shape[:3] + (w.shape[3],))
        .float(), k1.LIVE_TAPS)[1] for w, (x, p, _) in zip(ws, feeds)]
    return dx, dctx, dws, [d for _, _, d in feeds]


def test_tensor_core_data_flow_matches_autograd_of_the_twin():
    """The composition, bf16 as on the card (G rounded to bf16 where the
    kernels round it), against autograd of K1's twin in bf16: dz and dW
    within one bf16 rounding of each output's max (2e-2, the card's
    limit; the two conv formulations sum in other orders), dcontext and
    db at 1e-5 of max (f32 glue on equal dX). In f32 the composition
    through the f32 twins (the f32 glue and packs, the 3xTF32 route's
    layouts, no bf16 casts) equals JAX's VJP of its XLA reference chain at
    1e-5: which G, input and sum feeds each conv, and where the packs
    place them, is the reference's."""
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


# --- f32 (the 3xTF32 route) -------------------------------------------------

def _glue_inputs_f32(shape, seed):
    rs = np.random.RandomState(seed)
    dx = _t(rs.randn(*shape).astype(np.float32))
    pre = _t((2 * rs.randn(*shape)).astype(np.float32))
    return dx, pre


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 16, 16, 24)])
def test_f32_glue_ref_is_autograd_of_the_elu_step(shape):
    """In f32: G = autograd of the twin's f32 ELU step for the f32 dX at
    1e-6, and nothing rounds it (G in T is G); the wgrad input is that
    step's forward value in f32; db sums G over the pixels."""
    dx, pre = _glue_inputs_f32(shape, 7)
    gt, gp, g, x, db = k1.glue_ref(dx, pre, f32=True)
    pre_ = pre.clone().requires_grad_()
    step = F.elu(pre_)
    want = torch.autograd.grad(step, pre_, dx)[0]
    torch.testing.assert_close(g, want, rtol=1e-6, atol=0.0)
    assert gt.dtype == x.dtype == gp.dtype == torch.float32
    assert torch.equal(gt, g)
    assert torch.equal(x, step.detach())
    torch.testing.assert_close(db, want.reshape(-1, shape[-1]).sum(0),
                               rtol=1e-5, atol=1e-5 * float(db.abs().max()))


@pytest.mark.parametrize("shape,hidden", [((2, 16, 16, 160), True),
                                          ((2, 16, 16, 64), False),
                                          ((1, 4, 8, 20), True),
                                          ((1, 2, 4, 12), False)])
def test_f32_glue_ref_packed_g_is_wgrad_pack(shape, hidden):
    """In f32 the glue's packed G, placed by the kernel's own store
    arithmetic (4 pixels of one channel per 16-byte store, two stores a
    group of 8), equals ``masked_conv.wgrad_pack(G, f32=True)`` (the
    3xTF32 wgrad's tf32 order, [1, P/8, npad/8, 2, 8, 4]) bitwise, zero
    columns past C included; the head's G is its input itself."""
    dx, pre = _glue_inputs_f32(shape, 8)
    gt, gp, g, x, _ = k1.glue_ref(dx, pre if hidden else None, f32=True)
    assert (x is None) != hidden
    if not hidden:
        assert torch.equal(g, dx) and torch.equal(gt, dx)
    want = mc.wgrad_pack(g, f32=True)
    p = dx.numel() // shape[-1]
    assert gp.shape == want.shape == (1, p // 8, mc.wgmma_width(shape[-1])
                                      // 8, 2, 8, 4)
    assert gp.dtype == want.dtype == torch.float32
    assert torch.equal(gp, want)


@pytest.mark.parametrize("shapes", [PAPER_SHAPES, ((16, 32), (32, 24))])
def test_dgrad_pack_f32_ref_and_kernel_arithmetic(shapes):
    """``pack_dgrad_ref(f32=True)`` equals ``masked_conv.dgrad_pack(w,
    LIVE_TAPS, f32=True)`` per conv bitwise; the f32 pack kernel's item
    decoding, in plain torch (item i of conv c is (t, s, j, h, n) with
    its 4 k values the 16 bytes at W[t][8 j + n][8 s + 4 h ..], stored at
    16-byte slot i, zero for 8 j + n >= cin), equals it element for
    element."""
    rs = np.random.RandomState(14)
    ws = [_t(rs.randn(3, 3, ci, co).astype(np.float32)) for ci, co in shapes]
    ref = k1.pack_dgrad_ref(ws, f32=True)
    for w, want in zip(ws, ref):
        cin, cout = w.shape[2], w.shape[3]
        assert torch.equal(want, mc.dgrad_pack(w, k1.LIVE_TAPS, f32=True))
        npad = mc.wgmma_width(cin)
        items = 5 * (cout // 4) * npad
        got = torch.zeros(items, 4)
        live = w.reshape(9, cin, cout)[:5]
        for i in range(items):
            r = i
            n, r = r & 7, r >> 3
            h, r = r & 1, r >> 1
            j, r = r % (npad // 8), r // (npad // 8)
            s_, t = r % (cout // 8), r // (cout // 8)
            if 8 * j + n < cin:
                co = 8 * s_ + 4 * h
                got[i] = live[t, 8 * j + n, co:co + 4]
        assert want.shape == (5, cout // 8, npad // 8, 2, 8, 4)
        assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("n,hw,depth_ar,dtype,route", [
    (32, 16, 2, torch.float32, "3xtf32"), (1024, 16, 2, torch.float32,
                                           "3xtf32"),
    (32, 16, 4, torch.float32, "3xtf32"), (8, 32, 2, torch.float32, "3xtf32"),
    (8, 48, 2, torch.float32, "fma"), (32, 16, 2, torch.bfloat16, "wgmma")])
def test_bwd_route_from_the_kernels_byte_counts(fake_libs, n, hw, depth_ar,
                                                dtype, route):
    """With the kernels' own byte counts (``_FakeLib``, held to the built
    libraries by the card test below: ``wg_plan``'s stages at the mirrored
    3x3 taps, the wgrad's two stages): at the paper widths every
    conv's dgrad and wgrad fit and take the f32 tensor cores in f32 (the
    bf16 ones in bf16), also at W = 32 (``image_size=64``); W = 48 is no
    tile width and stays on FMA, decided from the shapes alone."""
    shapes = PAPER_SHAPES[:1] + PAPER_SHAPES[1:2] * (depth_ar - 1) \
        + PAPER_SHAPES[2:]
    z = torch.empty(n, hw, hw, 32, dtype=dtype)
    ws = [torch.empty(3, 3, ci, co, dtype=dtype) for ci, co in shapes]
    assert k1.bwd_route(z, ws) == ((route, route),) * len(ws)
    if route == "3xtf32":     # the stages the kernels would plan
        for ci, co in shapes:
            assert _FakeLib.masked_conv_wgmma_stages(
                hw, co, 3, 1, mc.wgmma_width(ci), 5, k1._SMEM_LIMIT, 1) >= 2
            assert 0 < _FakeLib.masked_conv_wgrad_tf32_smem(
                hw, hw, ci, 3, 1, mc.wgmma_width(co)) <= k1._SMEM_LIMIT


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,depth_ar", [(32, 2), (8, 4)])
def test_f32_route_matches_f64_twin_on_card(cuda, n, depth_ar):
    """K1's f32 backward at the paper widths on the 3xTF32 route: dz,
    dcontext, dW at the live taps (the dead ones zero) and db within 1e-5
    of each one's max of autograd of the twin in f64; 13 device launches'
    worth of kernels in one count; two calls bitwise equal."""
    z, c, ws, bs, _, g = _chain(9, 32, 160, n, 16, depth_ar)
    zt, ct, gt = (_t(a).to(cuda) for a in (z, c, g))
    wt = [_t(w).to(cuda) for w in ws]
    bt = [_t(b).to(cuda) for b in bs]
    assert k1.bwd_route(zt, wt) == (("3xtf32", "3xtf32"),) * len(ws)
    with torch.no_grad():
        pre = k1._fwd(zt, ct, wt, bt, save_pre=True)[1]
    ops.reset_launch_counts()
    first = ops.ar_stack_bwd(zt, wt, pre, gt)
    second = ops.ar_stack_bwd(zt, wt, pre, gt)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ar_stack_bwd"] == 2
    assert ops.launch_counts()["masked_conv2d_bwd"] == 0
    flat = [first[0], first[1], *first[2], *first[3]]
    assert all(torch.equal(a, b) for a, b in zip(
        flat, [second[0], second[1], *second[2], *second[3]]))
    want = ops.ar_stack_bwd_ref(zt.double(), ct.double(),
                                [w.double() for w in wt],
                                [b.double() for b in bt], gt.double())
    live = torch.zeros(3, 3, 1, 1, device=cuda)
    live[0], live[1, :2] = 1.0, 1.0
    pairs = [(first[0], want[0]), (first[1], want[1])]
    for a, b in zip(first[2], want[2]):
        assert a.dtype == torch.float32 and not (a * (1 - live)).any()
        pairs.append((a * live, b * live))
    pairs += list(zip(first[3], want[3]))
    for a, b in pairs:
        err = float((a.double() - b).abs().max())
        assert err <= 1e-5 * float(b.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape,hidden", [((8, 16, 16, 64), False),
                                          ((8, 16, 16, 160), True),
                                          ((2, 8, 16, 20), True)])
def test_f32_glue_kernel_matches_twin_on_card(cuda, shape, hidden):
    """The f32 glue kernel against its twin: G (NHWC, the f32 G the
    wrapper hands dcontext, and packed, zero columns past C) within 1e-6
    of max (expf against torch.exp), ELU give or take 4e-7 (the forward's
    fast exponential), the per-block db sums at 1e-5 of max; the head's G
    is its input, not a copy."""
    rs = np.random.RandomState(15)
    src = _t(rs.randn(*shape).astype(np.float32)).to(cuda)
    pre = _t((2 * rs.randn(*shape)).astype(np.float32)).to(cuda)
    p = pre if hidden else None
    gt, gp, g32, x, dbp = k1.glue(src, p, True, f32=True)
    rt, rp, r32, rx, rdb = k1.glue_ref(src, p, f32=True)
    assert g32 is gt and (hidden or gt is src)
    scale = float(r32.abs().max())
    for a, b in ((gt, rt), (gp, rp)):
        assert a.shape == b.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-6 * scale)
    if hidden:
        torch.testing.assert_close(x, rx, rtol=0.0, atol=4e-7)
    torch.testing.assert_close(dbp.sum(0), rdb, rtol=0.0,
                               atol=1e-5 * float(rdb.abs().max()))


@pytest.mark.cuda
def test_f32_dgrad_pack_kernel_equals_twin_on_card(cuda):
    """The f32 weight pack, all convs in one launch, bitwise equal to
    ``pack_dgrad_ref(f32=True)`` at the paper widths and at one that pads
    N, on contiguous HWIO weights and on the model's permuted OIHW
    views."""
    rs = np.random.RandomState(16)
    for shapes in (PAPER_SHAPES, ((16, 32), (32, 24))):
        ws = [_t(rs.randn(3, 3, ci, co).astype(np.float32)).to(cuda)
              for ci, co in shapes]
        views = [w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
                 for w in ws]
        assert not views[0].is_contiguous()
        for group in (ws, views):
            for a, b in zip(k1.pack_dgrad(group),
                            k1.pack_dgrad_ref(ws, f32=True)):
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_k1_byte_counts_match_the_built_libraries(cuda):
    """``_FakeLib`` against the built libraries at K1's backward shapes
    (the mirrored 3x3 taps: kw = 3, span 1, 5 taps; dgrad with the paper
    convs' cin and cout swapped, wgrad as they are) at W = 16, 32 and 64,
    f32 and bf16: the same stages where they fit, the same wgrad bytes."""
    fwd, bwd = mc._lib(), mc._bwd_lib()
    for w_ in (16, 32, 64):
        for ci, co in PAPER_SHAPES:
            for f32 in (1, 0):
                args = (w_, co, 3, 1, mc.wgmma_width(ci), 5, k1._SMEM_LIMIT,
                        f32)
                got = fwd.masked_conv_wgmma_stages(*args)
                want = _FakeLib.masked_conv_wgmma_stages(*args)
                assert (got >= 2) == (want >= 2), (args, got, want)
                if got >= 2:
                    assert got == want, (args, got, want)
            args = (16, w_, ci, 3, 1, mc.wgmma_width(co))
            assert (bwd.masked_conv_wgrad_tf32_smem(*args)
                    == _FakeLib.masked_conv_wgrad_tf32_smem(*args)), args
            assert (bwd.masked_conv_wgrad_wgmma_smem(*args)
                    == _FakeLib.masked_conv_wgrad_wgmma_smem(*args)), args
