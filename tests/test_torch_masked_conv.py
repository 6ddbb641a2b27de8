"""K2 (``iaf_torch.ops.masked_conv``): the plain twin and its backward
against the JAX Pallas kernel (interpret mode), its XLA twin and
``jax.vjp`` on the same numpy inputs (f32, 1e-5); the live-tap arithmetic
the CUDA kernels implement (implicit GEMM over the taps, dgrad as the
conv with mirrored taps, wgrad as shifted-input products) against the
twin, in plain torch on the CPU. The card tests at the end hold each
kernel to its twin on CUDA and skip where there is no card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from iaf_tpu.ops.masked_conv import masked_conv2d as j_masked_conv2d
from iaf_tpu.ops.masked_conv import xla_conv2d_same
from iaf_torch import ops
from iaf_torch.nn.masks import get_conv_ar_mask, nonzero_taps
from iaf_torch.ops.masked_conv import _live

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mask(k, cin, cout, zerodiagonal):
    """The AR mask of a conv, or for widths the MADE mask cannot pair
    (160 -> 64), two heads' masks side by side, as the merged heads."""
    if cin % cout == 0 or cout % cin == 0:
        return get_conv_ar_mask(k, k, cin, cout, zerodiagonal)
    return np.concatenate([get_conv_ar_mask(k, k, cin, cout // 2,
                                            zerodiagonal)] * 2, -1)


def _inputs(k, shape, cout, zerodiagonal=True, seed=0):
    rs = np.random.RandomState(seed + k)
    x = rs.randn(*shape).astype(np.float32)
    m = _mask(k, shape[-1], cout, zerodiagonal)
    w = (rs.randn(k, k, shape[-1], cout) / np.sqrt(k * shape[-1]) * m
         ).astype(np.float32)
    return x, w, m


def _close(got, want, rel, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= rel * scale, f"{name}: max err {err} > {rel} x {scale}"


# non-square maps, odd channel counts
SHAPES = [((2, 5, 7, 3), 9), ((1, 6, 4, 9), 3)]


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("shape,cout", SHAPES)
def test_masked_conv_ref_matches_pallas_and_xla(k, shape, cout):
    x, w, m = _inputs(k, shape, cout)
    want_pl = np.asarray(j_masked_conv2d(jnp.asarray(x), jnp.asarray(w)))
    want_xla = np.asarray(xla_conv2d_same(jnp.asarray(x), jnp.asarray(w)))
    got = ops.masked_conv2d_ref(_t(x), _t(w), nonzero_taps(m)).numpy()
    np.testing.assert_allclose(got, want_pl, **TOL)
    np.testing.assert_allclose(got, want_xla, **TOL)
    # the CPU wrapper is the twin
    assert np.array_equal(
        ops.masked_conv2d(_t(x), _t(w), nonzero_taps(m)).numpy(), got)


@pytest.mark.parametrize("k", [3, 5])
def test_masked_conv_ref_bf16_tracks_jax_bf16_twin(k):
    """Both twins cast x and w to bf16 and round the conv's output to
    bf16 once: they agree within one bf16 rounding (2^-7 relative; the
    f32 sums underneath differ by a few f32 ulps of their terms)."""
    x, w, m = _inputs(k, (2, 6, 6, 8), 16)
    want = np.asarray(xla_conv2d_same(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ).astype(jnp.float32))
    got = ops.masked_conv2d_ref(_t(x).bfloat16(), _t(w).bfloat16(),
                                nonzero_taps(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=2.0**-7,
                               atol=1e-5 * float(np.abs(want).max()))


def _tap_sum(x, live, taps, kh, kw):
    """out[y, x] = sum_t x[y + dy_t - ph, x + dx_t - pw] @ live[t], zeros
    outside the image: the implicit GEMM of masked_conv.cuh."""
    n, h, w_, _ = x.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    return sum(xp[:, dy:dy + h, dx:dx + w_] @ live[i]
               for i, (dy, dx) in enumerate(taps))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_live_taps_route_equals_all_taps(k):
    """Over the mask's live taps the twin gives exactly the all-taps conv,
    and so does the live-tap sum the kernels compute; weights outside the
    given taps count as zero."""
    x, w, m = _inputs(k, (2, 6, 5, 4), 8)
    taps = nonzero_taps(m)
    assert len(taps) == k * k // 2 + 1   # rows above, then up to the centre
    tx, tw = _t(x), _t(w)
    full = ops.masked_conv2d_ref(tx, tw)
    assert torch.equal(ops.masked_conv2d_ref(tx, tw, taps), full)
    torch.testing.assert_close(_tap_sum(tx, _live(tw, taps), taps, k, k),
                               full, **TOL)
    dead = torch.ones(k, k, 1, 1)
    for dy, dx in taps:
        dead[dy, dx] = 0.0
    assert torch.equal(ops.masked_conv2d_ref(tx, tw + dead, taps), full)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("shape,cout", SHAPES)
def test_masked_conv_bwd_ref_matches_jax_vjp(k, shape, cout):
    """dx at 1e-5 of its max; dW at the live taps at 1e-5 of its max and
    zero at the dead ones (JAX's VJP of the XLA twin is nonzero there; the
    fold's mask multiply zeroes it before it reaches V)."""
    x, w, m = _inputs(k, shape, cout, seed=3)
    g = np.random.RandomState(4).randn(*shape[:3], cout).astype(np.float32)
    _, vjp = jax.vjp(j_masked_conv2d, jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    dx, dw = ops.masked_conv2d_bwd_ref(_t(x), _t(w), _t(g), nonzero_taps(m))
    _close(dx.numpy(), dx_j, 1e-5, "dx")
    live = np.zeros((k, k, 1, 1), np.float32)
    for dy, dx_ in nonzero_taps(m):
        live[dy, dx_] = 1.0
    _close(dw.numpy(), dw_j * live, 1e-5, "dW")
    assert not (dw.numpy() * (1 - live)).any()


@pytest.mark.parametrize("k", [3, 5])
def test_backward_is_the_mirrored_conv_and_shifted_products(k):
    """The backward kernels' arithmetic: dx is the live-tap sum of g over
    the mirrored taps (kh-1-dy, kw-1-dx) with the weights transposed per
    tap; dW[t] = sum over pixels of the input shifted by tap t times g."""
    x, w, m = _inputs(k, (2, 6, 5, 8), 16, seed=5)
    taps = nonzero_taps(m)
    g = _t(np.random.RandomState(6).randn(2, 6, 5, 16).astype(np.float32))
    tx, tw = _t(x), _t(w)
    dx, dw = ops.masked_conv2d_bwd_ref(tx, tw, g, taps)
    mirrored = [(k - 1 - dy, k - 1 - dx_) for dy, dx_ in taps]
    got_dx = _tap_sum(g, _live(tw, taps).transpose(1, 2), mirrored, k, k)
    torch.testing.assert_close(got_dx, dx, **TOL)
    ph = (k - 1) // 2
    xp = F.pad(tx, (0, 0, ph, ph, ph, ph))
    for dy, dx_ in taps:
        shifted = xp[:, dy:dy + 6, dx_:dx_ + 5]
        want = torch.einsum("nhwc,nhwo->co", shifted, g)
        torch.testing.assert_close(dw[dy, dx_], want, **TOL)


def test_masked_conv_rejects_bad_inputs():
    x, w, m = _inputs(3, (1, 4, 4, 4), 8)
    tx, tw = _t(x), _t(w)
    with pytest.raises(ValueError, match="odd"):
        ops.masked_conv2d(tx, tw[:2])
    with pytest.raises(ValueError, match="channels"):
        ops.masked_conv2d(tx[..., :2], tw)
    with pytest.raises(TypeError, match="dtype"):
        ops.masked_conv2d(tx.bfloat16(), tw)
    with pytest.raises(ValueError, match="distinct"):
        ops.masked_conv2d(tx, tw, [(0, 0), (0, 0)])
    with pytest.raises(ValueError, match="distinct"):
        ops.masked_conv2d(tx, tw, [(3, 0)])


def test_cpu_autograd_differentiates_the_twin():
    """Under autograd a CPU tensor takes the twin, whose autograd is the
    plain backward; no kernel is counted."""
    ops.reset_launch_counts()
    x, w, m = _inputs(5, (2, 6, 6, 4), 8)
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    out = ops.masked_conv2d(tx, tw, nonzero_taps(m))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(g)
    dx, dw = ops.masked_conv2d_bwd_ref(tx.detach(), tw.detach(), g,
                                       nonzero_taps(m))
    assert torch.equal(tx.grad, dx) and torch.equal(tw.grad, dw)
    assert not any(ops.launch_counts().values())


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the three 5x5 AR convs of the paper config (tensor cores in bf16), odd
# tiny shapes (FMA path), and a 3x3 and a 7x7 kernel
CARD_CASES = [(5, (8, 16, 16, 32), 160), (5, (8, 16, 16, 160), 160),
              (5, (8, 16, 16, 160), 64), (5, (3, 6, 5, 3), 9),
              (3, (4, 16, 32, 16), 8), (7, (2, 9, 16, 16), 32)]
# the backward also at the training step's batch 32: 64 tiles of 128
# pixels for dgrad, 64 sub-tiles for wgrad
TRAIN_CASES = [(5, (32, 16, 16, 32), 160), (5, (32, 16, 16, 160), 160),
               (5, (32, 16, 16, 160), 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,shape,cout", CARD_CASES + TRAIN_CASES[2:])
def test_masked_conv_kernel_matches_twin_on_card(cuda, dtype, k, shape,
                                                 cout):
    """f32 (TF32 off) at 1e-5 of the output's max; bf16 at 2e-2 (the
    twin rounds its output to bf16, the kernel does not)."""
    x, w, m = _inputs(k, shape, cout)
    tx, tw = _t(x).to(cuda, dtype), _t(w).to(cuda, dtype)
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = ops.masked_conv2d(tx, tw, nonzero_taps(m))
        want = ops.masked_conv2d_ref(tx, tw, nonzero_taps(m))
    torch.cuda.synchronize()
    assert ops.launch_counts()["masked_conv2d"] == 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    _close(got.cpu().numpy(), want.cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,shape,cout", CARD_CASES + TRAIN_CASES)
def test_masked_conv_bwd_kernel_matches_twin_on_card(cuda, dtype, k, shape,
                                                     cout):
    """dx and dW (dead taps zero) against autograd of the twin, at 1e-4
    (f32, the twin in f64: cuDNN's own f32 weight gradient strays ~1e-3 of
    max on real gradients) / 2e-2 (bf16) of each output's max; through
    autograd, one backward launch."""
    x, w, m = _inputs(k, shape, cout, seed=1)
    taps = nonzero_taps(m)
    tx = _t(x).to(cuda, dtype).requires_grad_()
    tw = _t(w).to(cuda, dtype).requires_grad_()
    g = torch.randn(*shape[:3], cout, generator=torch.Generator()
                    .manual_seed(2)).to(cuda)
    ops.reset_launch_counts()
    got = torch.autograd.grad(ops.masked_conv2d(tx, tw, taps), [tx, tw], g)
    torch.cuda.synchronize()
    assert ops.launch_counts()["masked_conv2d_bwd"] == 1
    if dtype == torch.float32:
        want = ops.masked_conv2d_bwd_ref(tx.double(), tw.double(), g.double(),
                                         taps)
    else:
        want = ops.masked_conv2d_bwd_ref(tx, tw, g, taps)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _close(a.float().cpu().numpy(), b.float().cpu().numpy(), tol)
    live = torch.zeros(k, k, 1, 1, device=cuda)
    for dy, dx in taps:
        live[dy, dx] = 1.0
    assert not (got[1].float() * (1 - live)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 16, 32])
@pytest.mark.parametrize("k,shape,cout", TRAIN_CASES)
def test_masked_conv_fwd_plans_agree_bitwise_on_card(cuda, dtype, n, k,
                                                     shape, cout):
    """The forward on 64-pixel tiles (one warpgroup a block) gives the
    128-pixel tiles' bits, at the three 5x5 AR convs and N = 1 to the
    training step's batch 32, one launch a call; ``fwd_plan`` picks the
    64-pixel tiles there, and both are within the twin's limit."""
    from iaf_torch.ops import masked_conv as mc
    shape = (n,) + shape[1:]
    x, w, m = _inputs(k, shape, cout, seed=3)
    tx, tw = _t(x).to(cuda, dtype), _t(w).to(cuda, dtype)
    taps = mc._taps(tw, nonzero_taps(m))
    _, h, w_, cin = shape
    sms = mc._sm_count(tx.device)
    assert mc.fwd_plan(dtype, n, h, w_, cin, cout, sms).tile_pixels == 64
    outs = {}
    for tile in (mc.TILE, mc.SMALL_TILE):
        ops.reset_launch_counts()
        with torch.inference_mode():
            outs[tile] = mc._fwd(tx, tw, taps,
                                 plan=mc.tile_plan(n, h, w_, tile, sms))
        torch.cuda.synchronize()
        assert ops.launch_counts()["masked_conv2d"] == 1
    assert torch.equal(outs[mc.TILE], outs[mc.SMALL_TILE])
    with torch.inference_mode():
        assert torch.equal(ops.masked_conv2d(tx, tw, taps), outs[mc.TILE])
        want = ops.masked_conv2d_ref(tx, tw, taps)
    _close(outs[mc.SMALL_TILE].cpu().numpy(), want.cpu().numpy(),
           1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,shape,cout", TRAIN_CASES)
def test_masked_conv_fwd_grid_one_block_an_sm_on_card(cuda, dtype, k, shape,
                                                      cout):
    """At batch 32 the 64-pixel plan launches 128 blocks, one per tile,
    and no two of them share an SM (the occupancy calculator keeps one
    block an SM: each fills more than half of its shared memory)."""
    from iaf_torch.ops import masked_conv as mc
    x, w, m = _inputs(k, shape, cout)
    tx, tw = _t(x).to(cuda, dtype), _t(w).to(cuda, dtype)
    n, h, w_, cin = shape
    plan = mc.fwd_plan(dtype, n, h, w_, cin, cout, mc._sm_count(tx.device))
    assert plan == (64, 128)
    assert mc.fwd_grid(tx, tw, nonzero_taps(m), plan) == (128, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,shape,cout", TRAIN_CASES + [(3, (1, 8, 16, 48),
                                                         24)])
def test_masked_conv_pack_kernel_matches_fwd_pack_on_card(cuda, dtype, k,
                                                          shape, cout):
    """The forward's weight pack kernel gives ``fwd_pack``'s bytes (its
    twin: the live-tap gather and the packing copy), from contiguous
    weights and from a copy of other strides, padded columns included."""
    from iaf_torch.ops import masked_conv as mc
    _, w, m = _inputs(k, shape, cout)
    tw = _t(w).to(cuda, dtype)
    taps = mc._taps(tw, nonzero_taps(m))
    want = mc.fwd_pack(tw, taps, dtype == torch.float32)
    strided = tw.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    for v in (tw, strided):
        got = mc.fwd_pack_kernel(v, taps)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,shape,cout", TRAIN_CASES)
def test_masked_conv_bwd_tensor_cores_deterministic_on_card(cuda, k, shape,
                                                            cout):
    """At the training shapes in bf16 both dgrad and wgrad take the
    tensor cores, and two calls on the same inputs give the same bits
    (wgrad's partials are summed in chunk order, never by atomics)."""
    x, w, m = _inputs(k, shape, cout, seed=7)
    taps = nonzero_taps(m)
    tx = _t(x).to(cuda, torch.bfloat16)
    tw = _t(w).to(cuda, torch.bfloat16)
    g = torch.randn(*shape[:3], cout, generator=torch.Generator()
                    .manual_seed(8)).to(cuda)
    assert ops.masked_conv.bwd_route(tx, tw, taps) == ("wgmma", "wgmma")
    first = ops.masked_conv2d_bwd(tx, tw, g, taps)
    second = ops.masked_conv2d_bwd(tx, tw, g, taps)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# --- the tensor-core kernels' packing and routes ----------------------------

@pytest.mark.parametrize("taps,cin,cout,npad", [(13, 32, 160, 160),
                                                (3, 48, 20, 32)])
def test_wgmma_pack_layout(taps, cin, cout, npad):
    """``wgmma_pack``: a round trip back to [taps, cin, cout] (zeros in
    the padded columns), the element at each documented offset, and each
    (tap, 32-deep chunk) slice contiguous where the kernel streams it."""
    from iaf_torch.ops.masked_conv import wgmma_pack
    t = torch.from_numpy(np.random.RandomState(taps).randn(
        taps, cin, cout).astype(np.float32))
    p = wgmma_pack(t, npad)
    assert p.shape == (taps, cin // 16, npad // 8, 2, 8, 8)
    assert p.is_contiguous()
    back = p.permute(0, 1, 3, 5, 2, 4).reshape(taps, cin, npad)
    assert torch.equal(back[..., :cout], t)
    assert not back[..., cout:].any()
    flat = p.reshape(-1)
    rs = np.random.RandomState(0)
    for _ in range(50):
        ti, ci, co = (int(rs.randint(v)) for v in (taps, cin, cout))
        s, h, k, j, n = ci // 16, ci % 16 // 8, ci % 8, co // 8, co % 8
        off = ((((ti * (cin // 16) + s) * (npad // 8) + j) * 2 + h) * 8
               + n) * 8 + k
        assert flat[off] == t[ti, ci, co]
    # slice (tap, chunk c) = elements [(tap cin + 32 c) npad, + kd npad)
    for ti in range(taps):
        for c in range(-(-cin // 32)):
            kd = min(32, cin - 32 * c)
            start = (ti * cin + 32 * c) * npad
            got = flat[start:start + kd * npad].reshape(kd // 16, npad // 8,
                                                        2, 8, 8)
            want = back[ti, 32 * c:32 * c + kd]
            assert torch.equal(got.permute(0, 2, 4, 1, 3).reshape(kd, npad),
                               want)


def test_wgmma_route_predicate():
    """The forward's tensor-core route takes bf16 at the paper widths
    (all three 5x5 AR convs) and leaves f32 and untiled shapes to the FMA
    kernel; N is cout rounded up to an instantiated width."""
    from iaf_torch.ops.masked_conv import wgmma_path, wgmma_width
    bf16 = torch.bfloat16
    for cin, cout in ((32, 160), (160, 160), (160, 64)):
        assert wgmma_path(bf16, 16, cin, cout)
        assert not wgmma_path(torch.float32, 16, cin, cout)
    assert wgmma_path(bf16, 32, 16, 8) and wgmma_width(8) == 32
    assert not wgmma_path(bf16, 48, 16, 8)      # 3 segments: no 128-px tile
    assert not wgmma_path(bf16, 16, 24, 64)     # cin not whole k16 steps
    assert not wgmma_path(bf16, 16, 32, 264)    # wider than 256
    assert [wgmma_width(c) for c in (64, 72, 160, 168)] == [64, 128, 160, 256]


def test_bwd_route_predicates():
    """dgrad takes the forward's tensor-core predicate with cin and cout
    swapped, wgrad its own: bf16 at the paper widths at batch-32 maps
    (all three 5x5 AR convs, both ways); f32, maps that are not whole
    128-pixel sub-tiles and input channels that are not whole blocks of
    32 stay on FMA. wgrad's blocks over M are 32-channel blocks x groups
    of 4 taps."""
    from iaf_torch.ops.masked_conv import wgrad_m_blocks
    assert [wgrad_m_blocks(13, c) for c in (32, 160)] == [4, 20]
    from iaf_torch.ops.masked_conv import wgmma_path, wgrad_wgmma_path
    bf16 = torch.bfloat16
    for cin, cout in ((32, 160), (160, 160), (160, 64)):
        assert wgmma_path(bf16, 16, cout, cin)           # dgrad
        assert wgrad_wgmma_path(bf16, 16, 16, cin, cout)
        assert not wgmma_path(torch.float32, 16, cout, cin)
        assert not wgrad_wgmma_path(torch.float32, 16, 16, cin, cout)
    assert wgrad_wgmma_path(bf16, 3, 128, 64, 8)       # one row a sub-tile
    assert not wgrad_wgmma_path(bf16, 12, 16, 32, 64)  # H not 8-row tiles
    assert not wgrad_wgmma_path(bf16, 16, 48, 32, 64)  # W not a tile width
    assert not wgrad_wgmma_path(bf16, 16, 16, 48, 64)  # cin not 32-blocks
    assert not wgrad_wgmma_path(bf16, 16, 16, 32, 12)  # cout not 8-wide
    assert not wgrad_wgmma_path(bf16, 16, 16, 32, 264)


@pytest.mark.parametrize("cin,cout", [(32, 160), (24, 16)])
def test_dgrad_pack_layout(cin, cout):
    """``dgrad_pack``: the live taps' weights transposed per tap, element
    [t, s, j, h, n, k] = w[dy_t, dx_t, 8 j + n, 16 s + 8 h + k] (K is
    cout, N is cin padded to its width with zeros), in one contiguous
    copy."""
    from iaf_torch.ops.masked_conv import dgrad_pack, wgmma_width
    x, w, m = _inputs(5, (1, 4, 4, cin), cout, seed=9)
    taps = nonzero_taps(m)
    tw = _t(w)
    p = dgrad_pack(tw, taps)
    npad = wgmma_width(cin)
    assert p.shape == (len(taps), cout // 16, npad // 8, 2, 8, 8)
    assert p.is_contiguous()
    back = p.permute(0, 1, 3, 5, 2, 4).reshape(len(taps), cout, npad)
    for i, (dy, dx) in enumerate(taps):
        assert torch.equal(back[i, :, :cin], tw[dy, dx].t())
    assert not back[..., cin:].any()
    flat = p.reshape(-1)
    rs = np.random.RandomState(1)
    for _ in range(50):
        i, ci, co = (int(rs.randint(v)) for v in (len(taps), cin, cout))
        s_, h, k, j, n = co // 16, co % 16 // 8, co % 8, ci // 8, ci % 8
        off = ((((i * (cout // 16) + s_) * (npad // 8) + j) * 2 + h) * 8
               + n) * 8 + k
        assert flat[off] == tw[taps[i][0], taps[i][1], ci, co]


@pytest.mark.parametrize("shape,cout", [((2, 16, 16, 32), 160),
                                        ((1, 8, 32, 16), 8)])
def test_wgrad_pack_is_the_gemm_operand(shape, cout):
    """``wgrad_pack``: g rounded to bf16 with the NHWC pixel index as K,
    element [0, s, j, h, n, k] = g[pixel 16 s + 8 h + k, 8 j + n] (zero
    past cout), one contiguous copy; and the kernel's GEMM over it, dW[t]
    = (the input shifted by tap t)^T x g over all pixels, is the twin's
    dW at every live tap (1e-5 of max, f32 on bf16 values)."""
    from iaf_torch.ops.masked_conv import wgmma_width, wgrad_pack
    k = 5
    x, w, m = _inputs(k, shape, cout, seed=11)
    taps = nonzero_taps(m)
    n, hh, ww, cin = shape
    g = torch.from_numpy(np.random.RandomState(12).randn(
        n, hh, ww, cout).astype(np.float32))
    p = wgrad_pack(g)
    npad, pixels = wgmma_width(cout), n * hh * ww
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    assert p.shape == (1, pixels // 16, npad // 8, 2, 8, 8)
    b = p[0].permute(0, 2, 4, 1, 3).reshape(pixels, npad)
    assert torch.equal(b[:, :cout], g.reshape(pixels, cout).bfloat16())
    assert not b[:, cout:].any()
    flat = p.reshape(-1)
    rs = np.random.RandomState(2)
    for _ in range(50):
        px, co = int(rs.randint(pixels)), int(rs.randint(cout))
        s_, h, kk, j, nn = px // 16, px % 16 // 8, px % 8, co // 8, co % 8
        off = (((s_ * (npad // 8) + j) * 2 + h) * 8 + nn) * 8 + kk
        assert flat[off] == g.reshape(pixels, cout)[px, co].bfloat16()
    tx = _t(x).bfloat16().float()
    dw_ref = ops.masked_conv2d_bwd_ref(tx, _t(w), b[:, :cout].float()
                                       .reshape(g.shape), taps)[1]
    ph = (k - 1) // 2
    xp = F.pad(tx, (0, 0, ph, ph, ph, ph))
    for dy, dx in taps:
        shifted = xp[:, dy:dy + hh, dx:dx + ww].reshape(pixels, cin)
        torch.testing.assert_close(shifted.t() @ b[:, :cout].float(),
                                   dw_ref[dy, dx], **TOL)


@pytest.mark.parametrize("n_sub,m_blocks,sms", [(64, 4, 132), (64, 17, 132),
                                                (64, 200, 132), (5, 1, 132),
                                                (1000, 3, 114)])
def test_wgrad_chunks_cover_the_pixels(n_sub, m_blocks, sms):
    """The tensor-core wgrad's chunking: every sub-tile in exactly one
    chunk, no chunk empty, and no more blocks than SMs where M leaves
    room for a chunk per SM."""
    from iaf_torch.ops.masked_conv import wgrad_chunks
    per, chunks = wgrad_chunks(n_sub, m_blocks, sms)
    assert per >= 1 and per * chunks >= n_sub > per * (chunks - 1)
    if m_blocks <= sms:
        assert chunks * m_blocks <= sms
