"""K1/K3/K4: each plain twin against the JAX Pallas kernel (interpret mode)
and its XLA twin on the same numpy inputs (f32, 1e-5); the CPU wrappers
(K2's too) route to the twins; a non-CPU tensor never does. K1's f32
forward on the tensor cores splits each f32 operand into tf32 high and low
parts and forms every product as lo*hi + hi*lo + hi*hi: a plain emulation
of that arithmetic holds JAX's f32 ``ar_stack`` and the twin in f64 at the
card's limit, where one TF32 product does not. The card tests at the end
hold each kernel to its twin on CUDA and skip where there is no card.
K2's own tests are in test_torch_masked_conv.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from iaf_tpu.ops.ar_stack import ar_stack_fused, ar_stack_xla
from iaf_tpu.ops.fused import (disc_logistic_logp as j_dl_pallas,
                               disc_logistic_xla, iaf_update as j_iaf_pallas,
                               iaf_update_xla)
from iaf_torch import ops
from iaf_torch.core.device import resolve_device
from iaf_torch.nn.masks import get_conv_ar_mask, nonzero_taps

TOL = dict(rtol=1e-5, atol=1e-5)


def _chain(rs, zs, hs, depth_ar):
    ws, bs, masks, prev = [], [], [], zs
    for i in range(depth_ar):
        m = get_conv_ar_mask(3, 3, prev, hs, zerodiagonal=(i == 0))
        ws.append((rs.randn(3, 3, prev, hs) / np.sqrt(5 * prev) * m
                   ).astype(np.float32))
        bs.append((0.1 * rs.randn(hs)).astype(np.float32))
        masks.append(m)
        prev = hs
    m = np.concatenate([get_conv_ar_mask(3, 3, hs, zs, False)] * 2, -1)
    ws.append((rs.randn(3, 3, hs, 2 * zs) / np.sqrt(5 * hs) * m
               ).astype(np.float32))
    bs.append((0.1 * rs.randn(2 * zs)).astype(np.float32))
    masks.append(m)
    return ws, bs, masks


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _k1_inputs(zs, hs, n, hw, depth_ar=2, seed=0):
    rs = np.random.RandomState(seed)
    z = rs.randn(n, hw, hw, zs).astype(np.float32)
    c = rs.randn(n, hw, hw, hs).astype(np.float32)
    return (z, c, *_chain(rs, zs, hs, depth_ar))


@pytest.mark.parametrize("zs,hs,n,hw,depth_ar", [
    (4, 8, 3, 6, 2), (4, 8, 2, 5, 3), (4, 8, 2, 5, 4), (32, 160, 1, 16, 2)])
def test_ar_stack_ref_matches_pallas_and_xla(zs, hs, n, hw, depth_ar):
    """Through the ``ops.ar_stack`` wrapper (its twin on the CPU), at any
    AR depth JAX takes."""
    z, c, ws, bs, masks = _k1_inputs(zs, hs, n, hw, depth_ar)
    want_pl = np.asarray(ar_stack_fused(jnp.asarray(z), jnp.asarray(c),
                                        [jnp.asarray(w) for w in ws],
                                        [jnp.asarray(b) for b in bs], masks,
                                        batch_block=1))
    wb = [jnp.asarray(t) for pair in zip(ws, bs) for t in pair]
    want_xla = np.asarray(ar_stack_xla(jnp.asarray(z), jnp.asarray(c), *wb))
    got = ops.ar_stack(_t(z), _t(c), [_t(w) for w in ws],
                       [_t(b) for b in bs], masks).numpy()
    np.testing.assert_allclose(got, want_pl, **TOL)
    np.testing.assert_allclose(got, want_xla, **TOL)


def test_ar_stack_ref_bf16_matches_xla_bf16_twin():
    z, c, ws, bs, masks = _k1_inputs(4, 8, 2, 6)
    wb = [jnp.asarray(t) for pair in zip(ws, bs) for t in pair]
    want = np.asarray(ar_stack_xla(jnp.asarray(z), jnp.asarray(c), *wb,
                                   compute_dtype="bfloat16"))
    got = ops.ar_stack_ref(_t(z).bfloat16(), _t(c),
                           [_t(w).bfloat16() for w in ws],
                           [_t(b) for b in bs]).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def _k3_inputs(seed=1, shape=(3, 4, 4, 8)):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(4)]


def test_iaf_update_ref_matches_pallas_and_xla():
    args = _k3_inputs()
    got = ops.iaf_update_ref(*map(_t, args))
    for want in (j_iaf_pallas(*map(jnp.asarray, args)),
                 iaf_update_xla(*map(jnp.asarray, args))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _k4_inputs(seed=2, shape=(3, 8, 8, 3)):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, shape)
    sample = (img / 256.0 - 0.5).astype(np.float32)
    mean = (sample + 0.05 * rs.randn(*shape)).astype(np.float32)
    return mean, np.float32(-3.0), sample


def test_disc_logistic_ref_matches_pallas_and_xla():
    mean, ls, sample = _k4_inputs()
    got = ops.disc_logistic_ref(_t(mean), torch.tensor(ls), _t(sample))
    for want in (j_dl_pallas(jnp.asarray(mean), jnp.float32(ls),
                             jnp.asarray(sample)),
                 disc_logistic_xla(jnp.asarray(mean), jnp.float32(ls),
                                   jnp.asarray(sample))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_wrappers_route_to_twins():
    ops.reset_launch_counts()
    z, c, ws, bs, masks = _k1_inputs(4, 8, 2, 6)
    tz, tc, tws, tbs = _t(z), _t(c), [_t(w) for w in ws], [_t(b) for b in bs]
    assert torch.equal(ops.ar_stack(tz, tc, tws, tbs, masks),
                       ops.ar_stack_ref(tz, tc, tws, tbs))
    a = [_t(x) for x in _k3_inputs()]
    for g, w in zip(ops.iaf_update(*a), ops.iaf_update_ref(*a)):
        assert torch.equal(g, w)
    mean, ls, sample = _k4_inputs()
    assert torch.equal(
        ops.disc_logistic_logp(_t(mean), torch.tensor(ls), _t(sample)),
        ops.disc_logistic_ref(_t(mean), torch.tensor(ls), _t(sample)))
    taps = nonzero_taps(masks[0])
    assert torch.equal(ops.masked_conv2d(tz, tws[0], taps),
                       ops.masked_conv2d_ref(tz, tws[0], taps))
    counts = ops.launch_counts()
    assert {"ar_stack", "masked_conv2d", "iaf_update",
            "disc_logistic_logp"} <= set(counts)
    assert not any(counts.values()), counts


def test_non_cpu_tensors_never_reach_twins(monkeypatch):
    """A tensor off the CPU launches its kernel or raises; there is no
    fallback (meta tensors stand in for a device without a kernel). An AR
    net that K1 does not take (5x5) sends every conv to K2 and none to a
    library conv."""
    z, c, ws, bs, masks = _k1_inputs(4, 8, 2, 6)
    meta = lambda a: torch.empty(a.shape, device="meta")  # noqa: E731
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.ar_stack(meta(z), meta(c), [meta(w) for w in ws],
                     [meta(b) for b in bs], masks)
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.masked_conv2d(meta(z), meta(ws[0]), nonzero_taps(masks[0]))
    from iaf_torch.nn import layers as tl
    net = tl.ARMultiConv2d(4, [8, 8], [4, 4], (5, 5), device="meta")
    assert not net.fusable
    with pytest.raises(RuntimeError, match="no kernel"):
        net(meta(z), meta(c))
    calls = []

    def k2(x, w, taps):
        calls.append((tuple(w.shape), taps))
        return torch.empty((*x.shape[:3], w.shape[-1]), device=x.device)

    def no_library_conv(*args, **kwargs):
        raise AssertionError("an AR conv reached F.conv2d")

    monkeypatch.setattr(ops, "masked_conv2d", k2)
    monkeypatch.setattr(tl.F, "conv2d", no_library_conv)
    m, s = net(meta(z), meta(c))
    assert m.shape == s.shape == (2, 6, 6, 4)
    assert [shape for shape, _ in calls] == [(5, 5, 4, 8), (5, 5, 8, 8),
                                             (5, 5, 8, 8)]
    assert all(len(taps) == 13 for _, taps in calls)
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.iaf_update(*[meta(x) for x in _k3_inputs()])
    mean, _, sample = _k4_inputs()
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.disc_logistic_logp(meta(mean), torch.empty((), device="meta"),
                               meta(sample))


def test_non_cpu_backward_and_optimizer_never_reach_twins():
    """The backward wrappers and K5 launch or raise off the CPU too."""
    z, c, ws, bs, masks = _k1_inputs(4, 8, 2, 6)
    meta = lambda a: torch.empty(np.shape(a), device="meta")  # noqa: E731
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.ar_stack_bwd(meta(z), [meta(w) for w in ws],
                         [meta(c)], meta(z[..., :1].repeat(8, -1)))
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.masked_conv2d_bwd(meta(z), meta(ws[0]), meta(c),
                              nonzero_taps(masks[0]))
    a = [meta(x) for x in _k3_inputs()]
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.iaf_update_bwd(*a)
    mean, _, sample = _k4_inputs()
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.disc_logistic_bwd(meta(mean), torch.empty((1,), device="meta"),
                              meta(sample), torch.empty((3,), device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.adamax_polyak(a[:1], a[1:2], a[2:3], a[3:4], a[:1],
                          torch.empty((), device="meta"), beta1=0.9,
                          beta2=0.999, eps=1e-8, polyak_decay=0.999)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="not available"):
        resolve_device("cuda")
    from iaf_torch.core.config import Config
    from iaf_torch.parallel.eval_step import make_eval_step
    with pytest.raises(RuntimeError, match="not available"):
        make_eval_step(Config(), device="cuda", k=4)


def test_f32_recipe_turns_tf32_off_on_the_card(capsys):
    """``full_f32`` turns TF32 off for cuDNN and matmuls for f32 on CUDA
    only, and the ``[config]`` line of train and evaluate says so."""
    from iaf_torch import train_lib
    from iaf_torch.core.config import Config
    from iaf_torch.core.device import full_f32
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        for dtype, dev in (("bfloat16", "cuda"), ("float32", "cpu")):
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            assert not full_f32(dtype, torch.device(dev))
            assert torch.backends.cudnn.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32
        assert full_f32("float32", torch.device("cuda"))
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        train_lib._config_line(Config().parse("compute_dtype=float32"),
                               torch.device("cuda"))
        assert not torch.backends.cudnn.allow_tf32
        assert "TF32 off" in capsys.readouterr().out
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


def test_ar_stack_rejects_bad_masks_and_shapes():
    z, c, ws, bs, masks = _k1_inputs(4, 8, 2, 6)
    bad = [m.copy() for m in masks]
    bad[1][2, 2] = 1.0  # a tap below the centre
    with pytest.raises(ValueError, match="taps"):
        ops.ar_stack(_t(z), _t(c), [_t(w) for w in ws],
                     [_t(b) for b in bs], bad)
    with pytest.raises(ValueError, match="context"):
        ops.ar_stack(_t(z), _t(c[..., :4]), [_t(w) for w in ws],
                     [_t(b) for b in bs], masks)
    # masks checked once (``check_masks``) stand in for the arrays
    with pytest.raises(ValueError, match="taps"):
        ops.check_masks(bad)
    checked = ops.check_masks(masks)
    args = (_t(z), _t(c), [_t(w) for w in ws], [_t(b) for b in bs])
    torch.testing.assert_close(ops.ar_stack(*args, checked),
                               ops.ar_stack(*args, masks), rtol=0, atol=0)
    with pytest.raises(ValueError, match="mask"):
        ops.ar_stack(*args[:2], args[2][:2] + [args[2][2][..., :4]],
                     [args[3][0], args[3][1], args[3][2][:4]], checked)
    with pytest.raises(ValueError, match="differ in length"):
        ops.ar_stack(*args, ops.check_masks(masks[:2]))


@pytest.mark.parametrize("tap", [(1, 2), (2, 0), (2, 1), (2, 2)])
def test_mask_given_a_dead_tap_in_place_raises(tap):
    """A mask array that passed, then given a dead tap in place, is
    scanned again on the next call and raises; the ``check_masks`` made
    before the change holds no array and still stands for the masks that
    passed."""
    z, c, ws, bs, masks = _k1_inputs(4, 8, 2, 6)
    args = (_t(z), _t(c), [_t(w) for w in ws], [_t(b) for b in bs])
    checked = ops.check_masks(masks)
    ops.ar_stack(*args, masks)
    masks[2][tap] = 1.0
    with pytest.raises(ValueError, match="conv 2: mask has taps"):
        ops.ar_stack(*args, masks)
    with pytest.raises(ValueError, match="conv 2: mask has taps"):
        ops.check_masks(masks)
    assert checked.shapes == tuple(m.shape for m in masks)


@pytest.mark.parametrize("transposed", [False, True])
def test_tap_packing_takes_the_live_taps(transposed):
    """The FMA forward's [5, cin, cout] and dgrad's [5, cout, cin] packing
    hold tap t = LIVE_TAPS[t] of the HWIO weights."""
    from iaf_torch.ops.ar_stack import LIVE_TAPS, pack_weights, \
        pack_weights_t
    w = torch.randn(3, 3, 6, 10, generator=torch.Generator().manual_seed(0))
    pk = (pack_weights_t if transposed else pack_weights)(w)
    assert pk.is_contiguous()
    want = torch.stack([w[dy, dx].t() if transposed else w[dy, dx]
                        for dy, dx in LIVE_TAPS])
    assert torch.equal(pk, want)


def _fwd_pack_weights(shapes, seed=0):
    rs = np.random.RandomState(seed)
    return [_t(rs.randn(3, 3, ci, co).astype(np.float32)).bfloat16()
            for ci, co in shapes]


@pytest.mark.parametrize("permuted", [False, True])
def test_forward_packing_matches_wgmma_pack(permuted):
    """The tensor-core forward's weights, all convs in one buffer: conv c
    at its offset (5 * npad * the cin of the convs before it, each padded
    to whole 32-deep slices) is ``masked_conv.wgmma_pack`` of its live
    taps, npad = ``wgmma_width`` of its outputs, on contiguous HWIO weights
    and on the model's permuted OIHW views."""
    from iaf_torch.ops.ar_stack import _live_taps, pack_fwd_ref
    from iaf_torch.ops.masked_conv import wgmma_pack, wgmma_width
    shapes = ((32, 160), (160, 160), (160, 48))
    ws = _fwd_pack_weights(shapes)
    if permuted:
        ws = [w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
              for w in ws]
        assert not ws[0].is_contiguous()
    flat, offsets = pack_fwd_ref(ws)
    npads = [wgmma_width(co) for _, co in shapes]
    assert npads == [160, 160, 64]
    sizes = [5 * ci * npad for (ci, _), npad in zip(shapes, npads)]
    assert offsets == [0, sizes[0], sizes[0] + sizes[1]]
    assert flat.dtype == torch.bfloat16 and flat.numel() == sum(sizes)
    for w, (ci, _), npad, off, size in zip(ws, shapes, npads, offsets, sizes):
        block = flat[off:off + size].reshape(5, ci // 16, npad // 8, 2, 8, 8)
        assert torch.equal(block, wgmma_pack(_live_taps(w), npad))


def test_forward_packing_element_by_element():
    """Element [t][s][j][h][n][k] of conv c's block is W_c[dy, dx, 16 s +
    8 h + k, 8 j + n] at live tap t = (dy, dx), zero past cout and past cin
    (K is padded to whole 32-deep slices): the wgmma B operand of k-step
    s, K-major 8x8 core matrices."""
    from iaf_torch.ops.ar_stack import LIVE_TAPS, pack_fwd_ref
    shapes = ((16, 24), (16, 16))
    ws = _fwd_pack_weights(shapes, seed=1)
    flat, offsets = pack_fwd_ref(ws)
    kpad, npad = 32, 32
    assert offsets == [0, 5 * kpad * npad]
    assert flat.numel() == 2 * 5 * kpad * npad
    for w, (cin, cout), off in zip(ws, shapes, offsets):
        blk = flat[off:off + 5 * kpad * npad].reshape(5, kpad // 16,
                                                      npad // 8, 2, 8, 8)
        for t, (dy, dx) in enumerate(LIVE_TAPS):
            for s in range(kpad // 16):
                for j in range(npad // 8):
                    for h in range(2):
                        for n in range(8):
                            co = 8 * j + n
                            for k in range(8):
                                ci = 16 * s + 8 * h + k
                                want = (w[dy, dx, ci, co]
                                        if co < cout and ci < cin else 0.0)
                                assert blk[t, s, j, h, n, k] == want


def test_forward_packing_f32_element_by_element():
    """f32's packed block of conv c: element [t][s][j][h][n][k] is
    W_c[dy, dx, 8 s + 4 h + k, 8 j + n] at live tap t = (dy, dx), zero
    past cout, in f32 as it is: the tf32 wgmma B operand of k8 step s,
    K-major core matrices of 8 columns x 4 f32; conv blocks back to
    back."""
    from iaf_torch.ops.ar_stack import LIVE_TAPS, pack_fwd_ref
    shapes = ((8, 24), (24, 16))
    rs = np.random.RandomState(1)
    ws = [_t(rs.randn(3, 3, ci, co).astype(np.float32)) for ci, co in shapes]
    flat, offsets = pack_fwd_ref(ws)
    npad = 32
    assert flat.dtype == torch.float32
    assert offsets == [0, 5 * 8 * npad]
    assert flat.numel() == 5 * (8 + 24) * npad
    for w, (cin, cout), off in zip(ws, shapes, offsets):
        blk = flat[off:off + 5 * cin * npad].reshape(5, cin // 8, npad // 8,
                                                     2, 8, 4)
        for t, (dy, dx) in enumerate(LIVE_TAPS):
            for s in range(cin // 8):
                for j in range(npad // 8):
                    for h in range(2):
                        for n in range(8):
                            co = 8 * j + n
                            for k in range(4):
                                want = (w[dy, dx, 8 * s + 4 * h + k, co]
                                        if co < cout else 0.0)
                                assert blk[t, s, j, h, n, k] == want


@pytest.mark.parametrize("dtype,w,cz,ch,cout,route", [
    (torch.bfloat16, 16, 32, 160, 64, "wgmma"),      # the paper widths
    (torch.bfloat16, 16, 16, 32, 8, "wgmma"),
    (torch.float32, 16, 32, 160, 64, "3xtf32"),      # the f32 recipe
    (torch.float32, 16, 24, 40, 48, "3xtf32"),       # 8-deep steps
    (torch.float32, 12, 32, 160, 64, "fma"),         # W not one warp's row
    (torch.float32, 16, 12, 160, 64, "fma"),         # cz not 8-deep steps
    (torch.float32, 16, 96, 160, 64, "fma"),         # z wider than 64
    (torch.float32, 16, 32, 256, 64, "fma"),         # h wider than 160
    (torch.bfloat16, 12, 32, 160, 64, "fma"),        # W not one warp's row
    (torch.bfloat16, 32, 32, 160, 64, "fma"),
    (torch.bfloat16, 16, 24, 160, 64, "fma"),        # cz not 16-deep steps
    (torch.bfloat16, 16, 32, 160, 264, "fma"),       # wider than 256
])
def test_forward_route(dtype, w, cz, ch, cout, route):
    import importlib
    k1 = importlib.import_module("iaf_torch.ops.ar_stack")
    assert k1.fwd_route(dtype, w, cz, ch, cout) == route


def _tile_walk(z, ctx, weights, biases, rows=8):
    """A plain model of ``ar_stack_wgmma_kernel``'s walk: each image as
    tiles of ``rows`` rows, top to bottom. Per conv the input is the
    tile's rows with a zero column each side and the row above, which for
    z is read again and for a hidden conv's input is the halo row carried
    from the last tile (zeros at an image's first). Products in f32 of
    inputs rounded to the weights' dtype, bias, context and ELU in f32,
    the next conv's input rounded to the weights' dtype."""
    n, hh, ww, cz = z.shape
    dt = weights[0].dtype
    wts = [w.float() for w in weights]
    nc, ch = len(weights), weights[0].shape[-1]
    out = torch.zeros(n, hh, ww, weights[-1].shape[-1])
    for img in range(n):
        halo = [torch.zeros(ww + 2, ch) for _ in range(nc)]
        for y0 in range(0, hh, rows):
            zb = torch.zeros(rows + 1, ww + 2, cz)
            for i in range(rows + 1):
                if 0 <= y0 - 1 + i < hh:
                    zb[i, 1:ww + 1] = z[img, y0 - 1 + i].to(dt).float()
            above, here = zb[:-1], zb[1:]
            for c in range(nc):
                acc = sum((above if dy == 0 else here)[:, dx:dx + ww]
                          @ wts[c][dy, dx]
                          for dy, dx in ((0, 0), (0, 1), (0, 2), (1, 0),
                                         (1, 1))) + biases[c]
                if c == 0:
                    acc = acc + ctx[img, y0:y0 + rows]
                if c == nc - 1:
                    out[img, y0:y0 + rows] = acc
                    break
                here = torch.zeros(rows, ww + 2, ch)
                here[:, 1:ww + 1] = F.elu(acc).to(dt).float()
                above = torch.cat([halo[c + 1][None], here[:-1]])
                halo[c + 1] = here[-1].clone()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth_ar", [2, 4])
def test_tile_walk_matches_twin_and_jax(dtype, depth_ar):
    """The kernel's walk (two half-image tiles of a 16-row image, the
    halo rows carried between them) in plain ops: in f32 against the twin
    and JAX's ``ar_stack_xla`` at 1e-5; in bf16 against the twin at its
    tolerance on the card (2e-2)."""
    z, c, ws, bs, masks = _k1_inputs(4, 8, 2, 16, depth_ar, seed=3)
    args = (_t(z).to(dtype), _t(c), [_t(w).to(dtype) for w in ws],
            [_t(b) for b in bs])
    got = _tile_walk(*args)
    twin = ops.ar_stack_ref(*args)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got, twin, rtol=2e-2, atol=2e-2)
        return
    np.testing.assert_allclose(got.numpy(), twin.numpy(), **TOL)
    wb = [jnp.asarray(t) for pair in zip(ws, bs) for t in pair]
    want = np.asarray(ar_stack_xla(jnp.asarray(z), jnp.asarray(c), *wb))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# --- K1's f32 forward: the 3xTF32 arithmetic -------------------------------

LIMIT_F32 = 1e-5    # of the output's max: the card's check of the kernel
THREE = (("lo", "hi"), ("hi", "lo"), ("hi", "hi"))   # the kernel's order
ONE = (("hi", "hi"),)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 (10 mantissa bits), ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: half an ulp added to the magnitude's bits,
    the low 13 cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor) -> dict:
    hi = _tf32(x)
    return {"hi": hi, "lo": _tf32(x - hi)}


def _emulated(z, ctx, ws, bs, products):
    """The AR chain (``ar_stack_ref``'s) with every conv's products formed
    from the tf32 parts of its f32 input and weights, the ``products``
    (input part, weight part) summed in f32 in that order."""
    from iaf_torch.ops.ar_stack import conv_nhwc
    h = z
    for i, (w, b) in enumerate(zip(ws, bs)):
        xs, wsplit = _split(h), _split(w)
        acc = None
        for px, pw in products:
            y = conv_nhwc(xs[px], wsplit[pw][:2], ((1, 0), (1, 1)))
            acc = y if acc is None else acc + y
        h = acc + b
        if i == 0:
            h = h + ctx
        if i < len(ws) - 1:
            h = F.elu(h)
    return h


def _f64(*args):
    return [a.double() if torch.is_tensor(a) else [t.double() for t in a]
            for a in args]


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def test_tf32_rounding_is_nearest_ties_away():
    """Exact ties go away from zero, either sign; the low 13 bits of the
    result are zero; hi + lo carries x to 2^-22 of it."""
    one = 1.0 + 2.0 ** -10                    # a tf32 value
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        one + 2.0 ** -11, 1.0 + 2.0 ** -12],
                       dtype=torch.float32)
    want = torch.tensor([one, -one, 1.0 + 2.0 ** -9, 1.0])
    assert torch.equal(_tf32(tie), want)
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    parts = _split(x)
    for p in parts.values():
        assert not bool((p.view(torch.int32) & 0x1FFF).any())
    err = (parts["hi"].double() + parts["lo"].double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("zs,hs,n,depth_ar", [(32, 160, 1, 2),
                                              (16, 48, 2, 4)])
def test_3xtf32_emulation_holds_jax_and_f64_where_1xtf32_does_not(
        zs, hs, n, depth_ar):
    """On paper-like chains: the 3xTF32 emulation within 1e-5 of the
    output's max of JAX's f32 ``ar_stack`` (Pallas, interpret mode, and
    its XLA twin) and of the twin in f64; the 1xTF32 emulation beyond it
    against the f64 twin (the card's check would catch a kernel that drops
    the small terms)."""
    z, c, ws, bs, masks = _k1_inputs(zs, hs, n, 16, depth_ar)
    args = (_t(z), _t(c), [_t(w) for w in ws], [_t(b) for b in bs])
    three = _emulated(*args, THREE)
    assert three.dtype == torch.float32
    f64 = ops.ar_stack_ref(*_f64(*args))
    assert f64.dtype == torch.float64
    want_pl = ar_stack_fused(jnp.asarray(z), jnp.asarray(c),
                             [jnp.asarray(w) for w in ws],
                             [jnp.asarray(b) for b in bs], masks,
                             batch_block=1)
    wb = [jnp.asarray(t) for pair in zip(ws, bs) for t in pair]
    want_xla = ar_stack_xla(jnp.asarray(z), jnp.asarray(c), *wb)
    for want in (f64, _t(np.array(want_pl)), _t(np.array(want_xla))):
        assert _rel(three, want) <= LIMIT_F32
    assert _rel(_emulated(*args, ONE), f64) > LIMIT_F32


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zs,hs,n,hw,depth_ar", [
    (32, 160, 8, 16, 2), (4, 8, 3, 6, 2), (32, 160, 8, 16, 4),
    (16, 32, 8, 16, 2), (16, 48, 8, 16, 2), (32, 128, 8, 16, 2),
    (32, 256, 8, 16, 2), (32, 160, 2, 16, 2), (32, 160, 32, 16, 2)])
def test_ar_stack_kernel_matches_twin_on_card(cuda, dtype, zs, hs, n, hw,
                                              depth_ar):
    """The heads against the twin, 1e-4 (f32) / 2e-2 (bf16). In bf16 at
    W = 16 the tensor-core kernel runs (``fwd_route``), two calls give the
    same bits, and at batch 32 with the pre-activations written (the
    training forward) heads and pre-activations match the twin's at 2e-2
    of each one's max; in f32 at W = 16 up to h = 160 the 3xTF32
    tensor-core kernel runs (``test_3xtf32_kernel_matches_f64_twin_on_card``
    holds it to the f64 twin); elsewhere the FMA kernel runs. Beside the paper
    widths the bf16 cases run every wgmma width the kernel takes (N = 32,
    64, 128, 160 and the N = 256 instantiation) and input channels padded
    to whole 32-deep slices (cz = 16, ch = 48); N = 2 and 32 take
    ``fwd_plan``'s bands."""
    import importlib
    k1 = importlib.import_module("iaf_torch.ops.ar_stack")
    z, c, ws, bs, masks = _k1_inputs(zs, hs, n, hw, depth_ar)
    args = (_t(z).to(cuda, dtype), _t(c).to(cuda),
            [_t(w).to(cuda, dtype) for w in ws], [_t(b).to(cuda) for b in bs])
    with torch.inference_mode():
        got = ops.ar_stack(*args, masks)
        want = ops.ar_stack_ref(*args)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    wgmma = hw == 16 and dtype == torch.bfloat16
    tf32 = hw == 16 and dtype == torch.float32 and hs <= 160
    assert k1.fwd_route(dtype, hw, zs, hs, 2 * zs) == (
        "wgmma" if wgmma else "3xtf32" if tf32 else "fma")
    if not wgmma:
        return
    with torch.inference_mode():
        assert torch.equal(ops.ar_stack(*args, masks), got)
        z, c = _k1_inputs(zs, hs, 32, hw, depth_ar, seed=1)[:2]
        args = (_t(z).to(cuda, dtype), _t(c).to(cuda), *args[2:])
        out, pre = k1._fwd(*args, save_pre=True)
        rout, rpre = ops.ar_stack_ref_pre(*args)
    assert len(pre) == len(rpre) == depth_ar
    for a, b in zip([out, *pre], [rout, *rpre]):
        err = float((a - b.float()).abs().max())
        assert err <= 2e-2 * float(b.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,depth_ar", [(2, 2), (16, 2), (32, 2), (2, 4),
                                        (140, 2)])
def test_ar_stack_plans_agree_bitwise_on_card(cuda, dtype, n, depth_ar):
    """At the paper widths the picked plan and bands of 1, 3 and 9 - convs
    rows (at 140 images walked several a block) give the whole-image
    plan's heads and pre-activations bit for bit, within the twin's
    tolerance (f32: 1e-4, bf16 2e-2 of max)."""
    import importlib
    k1 = importlib.import_module("iaf_torch.ops.ar_stack")
    z, c, ws, bs, masks = _k1_inputs(32, 160, n, 16, depth_ar)
    args = (_t(z).to(cuda, dtype), _t(c).to(cuda),
            [_t(w).to(cuda, dtype) for w in ws], [_t(b).to(cuda) for b in bs])
    sms = k1._sms(cuda.index or 0)
    whole = k1.whole_plan(n, 16, sms)
    plans = {k1.fwd_plan(dtype, n, 16, 16, 32, 160, 64, len(ws), sms)}
    for band in (1, 3, 9 - len(ws)):
        plans.add(k1.FwdPlan(band=band, blocks=min(n * -(-16 // band), sms)))
    with torch.inference_mode():
        base = k1._fwd(*args, save_pre=True, plan=whole)
        rout, rpre = ops.ar_stack_ref_pre(*args)
        for plan in plans - {whole}:
            got = k1._fwd(*args, save_pre=True, plan=plan)
            for a, b in zip([got[0], *got[1]], [base[0], *base[1]]):
                assert torch.equal(a, b), plan
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip([base[0], *base[1]], [rout, *rpre]):
        err = float((a - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,most", [(torch.float32, 8),
                                        (torch.bfloat16, 16)])
def test_ar_stack_deeper_than_shared_memory_raises(cuda, dtype, most):
    """At the paper widths a block holds 8 convs on the tensor-core kernel
    in f32 (3xTF32: f32 buffers and slices) and 16 in bf16 (its halo rows
    and biases grow with the chain); one more raises, naming that
    limit."""
    for n_convs in (most, most + 1):
        z, c, ws, bs, masks = _k1_inputs(32, 160, 2, 16, n_convs - 1)
        args = (_t(z).to(cuda, dtype), _t(c).to(cuda),
                [_t(w).to(cuda, dtype) for w in ws],
                [_t(b).to(cuda) for b in bs], masks)
        with torch.inference_mode():
            if n_convs == most:
                assert torch.isfinite(ops.ar_stack(*args)).all()
                continue
            with pytest.raises(ValueError, match=f"at most {most} convs"):
                ops.ar_stack(*args)


@pytest.mark.cuda
def test_ar_fwd_pack_kernel_equals_twin_on_card(cuda):
    """K1 forward's weight pack, all convs in one launch, bitwise equal to
    its twin at the paper widths and at one that pads N, on contiguous
    HWIO weights and on the model's permuted OIHW views."""
    import importlib
    k1 = importlib.import_module("iaf_torch.ops.ar_stack")
    for shapes in (((32, 160), (160, 160), (160, 64)), ((16, 32), (32, 48))):
        ws = [w.to(cuda) for w in _fwd_pack_weights(shapes, seed=2)]
        views = [w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
                 for w in ws]
        want, offsets = k1.pack_fwd_ref(ws)
        for group in (ws, views):
            got, got_offsets = k1.pack_fwd(group)
            assert got_offsets == offsets and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("zs,hs,depth_ar", [
    (32, 160, 2), (32, 160, 7), (16, 32, 2), (8, 48, 2), (24, 48, 2),
    (16, 128, 2), (64, 128, 1)])
def test_3xtf32_kernel_matches_f64_twin_on_card(cuda, zs, hs, depth_ar):
    """K1's f32 kernel at the widths it takes (N = 32 to 160, K in 8-deep
    steps, the widest z, the deepest chain at the paper widths) against
    the twin in f64 at 1e-5 of the output's max, two calls bitwise equal;
    at batch 32 with the pre-activations written (the training forward)
    heads and pre-activations within 1e-5 of each one's max of the f64
    twin's."""
    import importlib
    k1 = importlib.import_module("iaf_torch.ops.ar_stack")
    assert k1.fwd_route(torch.float32, 16, zs, hs, 2 * zs) == "3xtf32"
    for n, pre in ((8, False), (32, True)):
        z, c, ws, bs, _ = _k1_inputs(zs, hs, n, 16, depth_ar, seed=n)
        args = (_t(z).to(cuda), _t(c).to(cuda), [_t(w).to(cuda) for w in ws],
                [_t(b).to(cuda) for b in bs])
        with torch.inference_mode():
            out, pres = k1._fwd(*args, save_pre=pre)
            again = k1._fwd(*args, save_pre=pre)
            rout, rpre = ops.ar_stack_ref_pre(*_f64(*args))
        assert all(torch.equal(a, b) for a, b in zip([out, *pres],
                                                     [again[0], *again[1]]))
        assert len(pres) == (depth_ar if pre else 0)
        for a, b in zip([out, *pres], [rout, *rpre]):
            assert _rel(a, b) <= LIMIT_F32


@pytest.mark.cuda
def test_ar_fwd_pack_kernel_equals_twin_on_card_f32(cuda):
    """K1 forward's f32 weight pack, all convs in one launch, bitwise
    equal to its twin at the paper widths and at ones that pad N, on
    contiguous HWIO weights and on the model's permuted OIHW views."""
    import importlib
    k1 = importlib.import_module("iaf_torch.ops.ar_stack")
    rs = np.random.RandomState(3)
    for shapes in (((32, 160), (160, 160), (160, 64)), ((8, 24), (24, 48))):
        ws = [_t(rs.randn(3, 3, ci, co).astype(np.float32)).to(cuda)
              for ci, co in shapes]
        views = [w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
                 for w in ws]
        want, offsets = k1.pack_fwd_ref(ws)
        for group in (ws, views):
            got, got_offsets = k1.pack_fwd(group)
            assert got_offsets == offsets and torch.equal(got, want)


@pytest.mark.cuda
def test_fused_kernels_match_twins_on_card(cuda):
    a = [_t(x).to(cuda) for x in _k3_inputs(shape=(64, 16, 16, 32))]
    mean, ls, sample = _k4_inputs(shape=(64, 32, 32, 3))
    with torch.inference_mode():
        for g, w in zip(ops.iaf_update(*a), ops.iaf_update_ref(*a)):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
        d = (_t(mean).to(cuda), torch.tensor(ls, device=cuda),
             _t(sample).to(cuda))
        torch.testing.assert_close(ops.disc_logistic_logp(*d),
                                   ops.disc_logistic_ref(*d),
                                   rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zs,hs,n,hw,depth_ar", [(32, 160, 8, 16, 2),
                                                 (4, 8, 3, 6, 3)])
def test_ar_stack_bwd_kernel_matches_twin_on_card(cuda, dtype, zs, hs, n, hw,
                                                  depth_ar):
    """dz, dcontext, db and dW at the live taps against autograd of the
    twin (the dead taps are zero), at 1e-4 (f32) / 2e-2 (bf16) of each
    output's max. At the paper widths every conv's dgrad and wgrad take
    the tensor cores (bf16 wgmma, f32 3xTF32), and the small shape FMA;
    two calls on the same inputs give the same bits on every route."""
    import importlib
    k1 = importlib.import_module("iaf_torch.ops.ar_stack")
    z, c, ws, bs, masks = _k1_inputs(zs, hs, n, hw, depth_ar)
    g = torch.randn(n, hw, hw, 2 * zs, generator=torch.Generator()
                    .manual_seed(0)).to(cuda)
    zt = _t(z).to(cuda, dtype).requires_grad_()
    ct = _t(c).to(cuda).requires_grad_()
    wt = [_t(w).to(cuda, dtype).requires_grad_() for w in ws]
    bt = [_t(b).to(cuda).requires_grad_() for b in bs]
    ops.reset_launch_counts()
    out = ops.ar_stack(zt, ct, wt, bt, masks)
    got = torch.autograd.grad(out, [zt, ct, *wt, *bt], g)
    assert ops.launch_counts()["ar_stack_bwd"] == 1
    dz, dc, dws, dbs = ops.ar_stack_bwd_ref(zt, ct, wt, bt, g)
    want = [dz, dc, *dws, *dbs]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    live = torch.zeros(3, 3, 1, 1, device=cuda)
    live[0], live[1, :2] = 1.0, 1.0
    for i, (a, b) in enumerate(zip(got, want)):
        if 2 <= i < 2 + len(ws):
            assert not (a.float() * (1 - live)).any()
            a, b = a.float() * live, b.float() * live
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (i, err)
    paper = zs == 32 and hs == 160
    route = ({torch.bfloat16: "wgmma", torch.float32: "3xtf32"}[dtype]
             if paper else "fma")
    assert k1.bwd_route(zt, wt) == ((route, route),) * len(ws)
    with torch.no_grad():
        pre = k1._fwd(zt, ct, wt, bt, save_pre=True)[1]
    first = ops.ar_stack_bwd(zt.detach(), [w.detach() for w in wt], pre, g)
    second = ops.ar_stack_bwd(zt.detach(), [w.detach() for w in wt], pre, g)
    torch.cuda.synchronize()
    for a, b in zip(first[:2] + tuple(first[2] + first[3]),
                    second[:2] + tuple(second[2] + second[3])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,hidden", [((8, 16, 16, 64), False),
                                          ((8, 16, 16, 160), True),
                                          ((2, 8, 16, 20), True)])
def test_ar_glue_kernel_matches_twin_on_card(cuda, shape, hidden):
    """K1 backward's glue kernel against its twin: G in f32 at 1e-6 of
    max, G in bf16 (NHWC and packed, zero columns past C) and bf16(ELU)
    within one bf16 rounding (ELU give or take 4e-7: the forward's fast
    exponential), the per-block db sums added in order at 1e-5 of max."""
    import importlib
    k1 = importlib.import_module("iaf_torch.ops.ar_stack")
    rs = np.random.RandomState(5)
    src = _t(rs.randn(*shape).astype(np.float32)).to(cuda)
    pre = _t((2 * rs.randn(*shape)).astype(np.float32)).to(cuda)
    if hidden:
        src = src.bfloat16()
    gb, gp, g32, x, dbp = k1.glue(src, pre if hidden else None, True)
    rb, rp, r32, rx, rdb = k1.glue_ref(src, pre if hidden else None)
    npad = ops.masked_conv.wgmma_width(shape[-1])
    assert dbp.shape == (k1.glue_blocks(src.numel() // shape[-1], npad)[1],
                         shape[-1])
    torch.testing.assert_close(g32, r32, rtol=0.0,
                               atol=1e-6 * float(r32.abs().max()))
    pairs = [(gb, rb, 0.0), (gp, rp, 0.0)] + ([(x, rx, 4e-7)] if hidden
                                              else [])
    for a, b, slack in pairs:
        d = (a.float() - b.float()).abs()
        assert bool((d <= 2 ** -7 * b.float().abs() + slack).all())
    torch.testing.assert_close(dbp.sum(0), rdb, rtol=0.0,
                               atol=1e-5 * float(rdb.abs().max()))


@pytest.mark.cuda
def test_ar_dgrad_pack_kernel_equals_twin_on_card(cuda):
    """K1 backward's weight pack, all convs in one launch, bitwise equal
    to its twin at the paper widths and at one that pads N, on contiguous
    HWIO weights and on the model's permuted OIHW views."""
    import importlib
    k1 = importlib.import_module("iaf_torch.ops.ar_stack")
    rs = np.random.RandomState(6)
    for shapes in (((32, 160), (160, 160), (160, 64)), ((16, 32), (32, 48))):
        ws = [_t(rs.randn(3, 3, ci, co).astype(np.float32)).to(
            cuda, torch.bfloat16) for ci, co in shapes]
        views = [w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
                 for w in ws]
        assert not views[0].is_contiguous()
        for group in (ws, views):
            for a, b in zip(k1.pack_dgrad(group), k1.pack_dgrad_ref(ws)):
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_bwd_kernels_match_twins_on_card(cuda):
    a = [_t(x).to(cuda) for x in _k3_inputs(shape=(64, 16, 16, 32))]
    gz, glq = (torch.randn_like(a[0]) for _ in range(2))
    z_new = ops.iaf_update_ref(*a)[0]
    got = ops.iaf_update_bwd(z_new, a[2], gz, glq)
    for g, w in zip(got, ops.iaf_update_bwd_ref(*a, gz, glq)):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    mean, ls, sample = _k4_inputs(shape=(64, 32, 32, 3))
    d = (_t(mean).to(cuda), torch.tensor([ls], device=cuda),
         _t(sample).to(cuda))
    g = torch.randn(64, device=cuda)
    dmean, dls = ops.disc_logistic_bwd(*d, g)
    rmean, rls = ops.disc_logistic_bwd_ref(*d, g)
    assert float((dmean - rmean).abs().max()) <= 1e-5 * float(
        rmean.abs().max())
    torch.testing.assert_close(dls, rls, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_adamax_kernel_bitwise_equals_twin_on_card(cuda):
    shapes = [(160, 160, 3, 3), (160,), (), (70001,)]
    gen = torch.Generator().manual_seed(0)
    leaves = [[torch.randn(s, generator=gen).to(cuda) for s in shapes]
              for _ in range(5)]
    leaves[3] = [t.abs() for t in leaves[3]]
    lr_t = torch.tensor(0.002, device=cuda)
    for scale in (None, torch.tensor(0.7, device=cuda)):
        p, g, m, u, e = ([t.clone() for t in group] for group in leaves)
        want = [ops.adamax_polyak_ref(*leaf, lr_t, beta1=0.9, beta2=0.999,
                                      eps=1e-8, polyak_decay=0.999,
                                      scale=scale)
                for leaf in zip(p, g, m, u, e)]
        ops.adamax_polyak(p, g, m, u, e, lr_t, beta1=0.9, beta2=0.999,
                          eps=1e-8, polyak_decay=0.999, scale=scale)
        for i, w in enumerate(want):
            for got, ref in zip((p[i], m[i], u[i], e[i]), w):
                assert torch.equal(got, ref)


def test_cpu_wrappers_differentiate_the_twins():
    """Under autograd a CPU tensor takes the twin, whose autograd is the
    plain backward; no kernel is counted."""
    ops.reset_launch_counts()
    a = [_t(x).requires_grad_() for x in _k3_inputs()]
    zo, lq = ops.iaf_update(*a)
    (zo.sum() + 2 * lq.sum()).backward()
    want = ops.iaf_update_bwd_ref(*[t.detach() for t in a],
                                  torch.ones_like(zo), 2 * torch.ones_like(lq))
    for t, w in zip(a, want):
        torch.testing.assert_close(t.grad, w, rtol=1e-6, atol=1e-6)
    assert not any(ops.launch_counts().values())
