"""K2 in f32 on the tensor cores (``iaf_torch.ops.masked_conv``, route
``"3xtf32"``): the arithmetic of its 3xTF32 kernels emulated in plain
torch at tiny 5x5 shapes against JAX's ``masked_conv2d`` and its VJP and
against the twin in f64; the routes; the f32 packs element by element.
The card tests at the end hold each f32 kernel to the f64 twin and skip
where there is no card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.ops.masked_conv import masked_conv2d as j_masked_conv2d
from iaf_torch import ops
from iaf_torch.nn.masks import nonzero_taps
from iaf_torch.ops import masked_conv as mc
from test_torch_kernels import LIMIT_F32, ONE, THREE, _split
from test_torch_masked_conv import _inputs, _t

# the three 5x5 AR convs of the paper widths: 32->160 (zero diagonal),
# 160->160, 160->64 (merged heads)
WIDTHS = ((32, 160), (160, 160), (160, 64))


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _products(fn, a, b, products):
    """sum over (a part, b part) of ``fn`` on the tf32 parts of the f32
    operands a and b, in f32, in the kernels' order (small terms first):
    each product of two tf32 values is exact in f32."""
    pa, pb = _split(a), _split(b)
    out = None
    for xa, xb in products:
        y = fn(pa[xa], pb[xb])
        out = y if out is None else out + y
    return out


def _emulated(x, w, g, taps, products):
    """The three kernels' arithmetic, each with its operands split: the
    forward (A = x, B = the weights), dgrad (A = g, B = the transposed
    weights) and wgrad (A = x, B = g)."""
    fwd = _products(lambda a, b: ops.masked_conv2d_ref(a, b, taps), x, w,
                    products)
    dx = _products(lambda a, b: ops.masked_conv2d_bwd_ref(x, b, a, taps)[0],
                   g, w, products)
    dw = _products(lambda a, b: ops.masked_conv2d_bwd_ref(a, w, b, taps)[1],
                   x, g, products)
    return {"out": fwd, "dx": dx, "dW": dw}


@pytest.mark.parametrize("shape,cout", [((2, 8, 8, 32), 64),
                                        ((1, 8, 16, 48), 16)])
def test_3xtf32_emulation_holds_jax_and_f64_where_1xtf32_does_not(shape,
                                                                   cout):
    """The forward, dx and dW (live taps) of the 3xTF32 emulation within
    1e-5 of each one's max of JAX's f32 ``masked_conv2d`` and its VJP and
    of the twin in f64; one TF32 product instead misses that limit against
    the f64 twin on each of the three (the card's check catches a kernel
    that drops the small terms)."""
    x, w, m = _inputs(5, shape, cout, seed=21)
    taps = nonzero_taps(m)
    g = np.random.RandomState(22).randn(*shape[:3], cout).astype(np.float32)
    tx, tw, tg = _t(x), _t(w), _t(g)
    three = _emulated(tx, tw, tg, taps, THREE)
    f64 = {"out": ops.masked_conv2d_ref(tx.double(), tw.double(), taps)}
    f64["dx"], f64["dW"] = ops.masked_conv2d_bwd_ref(
        tx.double(), tw.double(), tg.double(), taps)
    out_j, vjp = jax.vjp(j_masked_conv2d, jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    live = np.zeros((5, 5, 1, 1), np.float32)
    for dy, dx in taps:
        live[dy, dx] = 1.0
    jax_ = {"out": _t(np.asarray(out_j)), "dx": _t(np.asarray(dx_j)),
            "dW": _t(np.asarray(dw_j) * live)}
    one = _emulated(tx, tw, tg, taps, ONE)
    for k in ("out", "dx", "dW"):
        assert three[k].dtype == torch.float32
        assert _rel(three[k], f64[k]) <= LIMIT_F32, k
        assert _rel(three[k], jax_[k]) <= LIMIT_F32, k
        assert _rel(one[k], f64[k]) > LIMIT_F32, k
    assert not (three["dW"] * (1 - _t(live))).any()


def test_wgrad_tf32_gemm_over_64_pixel_chunks():
    """wgrad as the 3xTF32 kernel sums it: per 64-pixel sub-tile, groups
    of 4 k8 steps summed from zero and added into f32 totals, the chunks'
    partials added in chunk order; on the f32 pack of g (its pixels as K)
    it is the f64 twin's dW at every live tap within 1e-5 of max."""
    k, shape, cout = 5, (2, 16, 16, 32), 64
    x, w, m = _inputs(k, shape, cout, seed=23)
    taps = nonzero_taps(m)
    n, hh, ww, cin = shape
    pixels = n * hh * ww
    g = _t(np.random.RandomState(24).randn(n, hh, ww, cout)
           .astype(np.float32))
    p = mc.wgrad_pack(g, f32=True)
    b = p[0].permute(0, 2, 4, 1, 3).reshape(pixels, -1)[:, :cout]
    tx = _t(x)
    want = ops.masked_conv2d_bwd_ref(tx.double(), _t(w).double(),
                                     g.double(), taps)[1]
    xp = torch.nn.functional.pad(tx, (0, 0, 2, 2, 2, 2))
    per = 3                                     # sub-tiles per chunk
    for dy, dx in taps:
        a = xp[:, dy:dy + hh, dx:dx + ww].reshape(pixels, cin)
        total = torch.zeros(cin, cout)
        for c0 in range(0, pixels, 64 * per):
            part = torch.zeros(cin, cout)
            for p0 in range(c0, min(c0 + 64 * per, pixels), 32):
                part += _products(lambda u, v: u.t() @ v, a[p0:p0 + 32],
                                  b[p0:p0 + 32], THREE)
            total += part
        assert _rel(total, want[dy, dx]) <= LIMIT_F32


# --- routes -----------------------------------------------------------------

def test_tf32_route_predicates():
    """f32 at the 5x5 widths takes the 3xTF32 tensor-core kernels for the
    forward, dgrad (cin and cout swapped) and wgrad, also at batch-32
    maps; bf16 keeps its own predicates and f32 never takes them; shapes
    the 3xTF32 kernels do not tile stay on FMA."""
    f32, bf16 = torch.float32, torch.bfloat16
    for cin, cout in WIDTHS:
        assert mc.tf32_path(f32, 16, cin, cout)              # forward
        assert mc.tf32_path(f32, 16, cout, cin)              # dgrad
        assert mc.wgrad_tf32_path(f32, 16, 16, cin, cout)
        assert not mc.tf32_path(bf16, 16, cin, cout)
        assert not mc.wgrad_tf32_path(bf16, 16, 16, cin, cout)
        assert not mc.wgmma_path(f32, 16, cin, cout)
        assert not mc.wgrad_wgmma_path(f32, 16, 16, cin, cout)
    assert mc.tf32_path(f32, 128, 16, 8)
    assert not mc.tf32_path(f32, 16, 24, 64)       # cin not 16-deep slices
    assert not mc.tf32_path(f32, 16, 32, 168)      # wider than 160
    assert not mc.tf32_path(f32, 48, 32, 64)       # 3 segments: no tile
    assert mc.wgrad_tf32_path(f32, 1, 64, 32, 8)   # one row a sub-tile
    assert not mc.wgrad_tf32_path(f32, 16, 128, 32, 8)  # W over 64
    assert not mc.wgrad_tf32_path(f32, 6, 16, 32, 64)   # H not 4-row tiles
    assert not mc.wgrad_tf32_path(f32, 16, 16, 48, 64)  # cin not 32-blocks
    assert not mc.wgrad_tf32_path(f32, 16, 16, 32, 168)


_MAX_STAGES = 32


def _a_bytes(tr, w_, cin, kw, span, e):
    b = (tr + span) * (w_ + kw - 1) * (cin + 16 // e) * e
    return -(-b // 128) * 128


def _stages(w_, cin, kw, span, npad, ntaps, limit, f32):
    """masked_conv.cuh's wg_plan, its ring stages: bf16 two staged
    buffers, f32 one."""
    tr = {16: 8, 32: 4, 64: 2, 128: 1}.get(w_, 0)
    if not tr:
        return 0
    e = 4 if f32 else 2
    bars = (3 if f32 else 2) * _MAX_STAGES * 8
    slice_ = 2 * 16 * npad * 4 if f32 else 32 * npad * 2
    a = _a_bytes(tr, w_, cin, kw, span, e)

    stages = min((limit - bars - (1 if f32 else 2) * a) // slice_,
                 _MAX_STAGES)
    return stages if f32 else min(stages, ntaps * -(-cin // 32))


def _wgrad_smem(h, w_, cin, kw, span, npad, f32):
    """masked_conv_bwd.cu's two wgrad stages (0: not tiled)."""
    px = 64 if f32 else 128
    tr = px // w_ if w_ % 16 == 0 and px % w_ == 0 and w_ >= 16 else 0
    if not tr or h % tr or cin % 32:
        return 0
    cs, e = (40, 4) if f32 else (40, 2)
    x = -(-(tr + span) * (w_ + kw - 1) * cs * e // 128) * 128
    return 2 * (x + (2 if f32 else 1) * px * npad * e)


class _FakeLib:
    """The byte counts of the built libraries, in Python, for the routes
    on a machine without nvcc (held to the built ones by
    ``test_fake_byte_counts_match_the_built_libraries``)."""

    @staticmethod
    def masked_conv_wgmma_stages(*args):
        return _stages(*args)

    @staticmethod
    def masked_conv_wgrad_wgmma_smem(*args):
        return _wgrad_smem(*args, False)

    @staticmethod
    def masked_conv_wgrad_tf32_smem(*args):
        return _wgrad_smem(*args, True)


@pytest.fixture
def fake_libs(monkeypatch):
    import importlib
    k1 = importlib.import_module("iaf_torch.ops.ar_stack")
    caches = (mc._route, mc._wgrad_route, k1._bwd_route)
    for c in caches:
        c.cache_clear()
    monkeypatch.setattr(mc, "_lib", lambda: _FakeLib)
    monkeypatch.setattr(mc, "_bwd_lib", lambda: _FakeLib)
    yield k1
    for c in caches:
        c.cache_clear()


@pytest.mark.parametrize("n", [1024, 32])
def test_f32_routes_take_3xtf32_at_the_5x5_widths(fake_libs, n):
    """With the kernels' byte counts: every 5x5 AR conv in f32 routes its
    forward to ``"3xtf32"`` and its backward to ("3xtf32", "3xtf32"),
    in bf16 to the bf16 tensor cores as before; an f32 conv whose staged
    rows do not fit (W = 128, cin = 160) stays on FMA; K1's f32 backward
    runs on K2's f32 kernels (3xTF32) as its bf16 backward runs on K2's
    bf16 ones."""
    k1 = fake_libs
    for cin, cout in WIDTHS:
        _, w, m = _inputs(5, (1, 1, 1, cin), cout)
        taps = nonzero_taps(m)
        for dtype, route in ((torch.float32, "3xtf32"),
                             (torch.bfloat16, "wgmma")):
            x = torch.empty(n, 16, 16, cin, dtype=dtype)
            tw = _t(w).to(dtype)
            assert mc.fwd_route(x, tw, taps) == route
            assert mc.bwd_route(x, tw, taps) == (route, route)
    x = torch.empty(2, 16, 128, 160)
    w = torch.empty(5, 5, 160, 160)
    assert mc.fwd_route(x, w, taps) == "fma"
    z = torch.empty(32, 16, 16, 32)
    ws = [torch.empty(3, 3, 32, 160), torch.empty(3, 3, 160, 160),
          torch.empty(3, 3, 160, 64)]
    assert k1.bwd_route(z, ws) == (("3xtf32", "3xtf32"),) * 3
    assert k1.bwd_route(z.bfloat16(), [w.bfloat16() for w in ws]) == (
        ("wgmma", "wgmma"),) * 3


# --- the f32 packs ----------------------------------------------------------

@pytest.mark.parametrize("cin,cout", [(32, 160), (160, 64), (48, 24)])
def test_fwd_pack_f32_layout(cin, cout):
    """``fwd_pack(w, taps, f32=True)``: [taps, cin/8, npad/8, 2, 8, 4],
    element [t, s, j, h, n, k] = w[dy_t, dx_t, 8 s + 4 h + k, 8 j + n]
    exactly (zero past cout), and each 16-deep slice (tap t, chunk c) the
    kernel streams is the contiguous [(t cin + 16 c) npad, + 16 npad) of
    the buffer."""
    _, w, m = _inputs(5, (1, 4, 4, cin), cout, seed=25)
    taps = nonzero_taps(m)
    tw = _t(w)
    p = mc.fwd_pack(tw, taps, f32=True)
    npad = mc.wgmma_width(cout)
    assert p.dtype == torch.float32 and p.is_contiguous()
    assert p.shape == (len(taps), cin // 8, npad // 8, 2, 8, 4)
    back = p.permute(0, 1, 3, 5, 2, 4).reshape(len(taps), cin, npad)
    for i, (dy, dx) in enumerate(taps):
        assert torch.equal(back[i, :, :cout], tw[dy, dx])
    assert not back[..., cout:].any()
    flat = p.reshape(-1)
    rs = np.random.RandomState(3)
    for _ in range(50):
        i, ci, co = (int(rs.randint(v)) for v in (len(taps), cin, cout))
        s_, h, k, j, n = ci // 8, ci % 8 // 4, ci % 4, co // 8, co % 8
        off = ((((i * (cin // 8) + s_) * (npad // 8) + j) * 2 + h) * 8
               + n) * 4 + k
        assert flat[off] == tw[taps[i][0], taps[i][1], ci, co]
    for i in range(len(taps)):
        for c in range(cin // 16):
            start = (i * cin + 16 * c) * npad
            got = flat[start:start + 16 * npad].reshape(2, npad // 8, 2, 8, 4)
            assert torch.equal(got.permute(0, 2, 4, 1, 3).reshape(16, npad),
                               back[i, 16 * c:16 * c + 16])


@pytest.mark.parametrize("cin,cout", WIDTHS)
def test_dgrad_pack_f32_layout(cin, cout):
    """``dgrad_pack(w, taps, f32=True)``: the live taps transposed per
    tap, element [t, s, j, h, n, k] = w[dy_t, dx_t, 8 j + n, 8 s + 4 h +
    k] (K is cout, N is cin padded to its width with zeros), exact f32,
    one contiguous copy."""
    _, w, m = _inputs(5, (1, 4, 4, cin), cout, seed=26)
    taps = nonzero_taps(m)
    tw = _t(w)
    p = mc.dgrad_pack(tw, taps, f32=True)
    npad = mc.wgmma_width(cin)
    assert p.dtype == torch.float32 and p.is_contiguous()
    assert p.shape == (len(taps), cout // 8, npad // 8, 2, 8, 4)
    back = p.permute(0, 1, 3, 5, 2, 4).reshape(len(taps), cout, npad)
    for i, (dy, dx) in enumerate(taps):
        assert torch.equal(back[i, :, :cin], tw[dy, dx].t())
    assert not back[..., cin:].any()
    flat = p.reshape(-1)
    rs = np.random.RandomState(4)
    for _ in range(50):
        i, ci, co = (int(rs.randint(v)) for v in (len(taps), cin, cout))
        s_, h, k, j, n = co // 8, co % 8 // 4, co % 4, ci // 8, ci % 8
        off = ((((i * (cout // 8) + s_) * (npad // 8) + j) * 2 + h) * 8
               + n) * 4 + k
        assert flat[off] == tw[taps[i][0], taps[i][1], ci, co]


@pytest.mark.parametrize("shape,cout", [((2, 16, 16, 32), 160),
                                        ((1, 4, 64, 16), 8)])
def test_wgrad_pack_f32_layout(shape, cout):
    """``wgrad_pack(g, f32=True)``: g exactly (not rounded) with the NHWC
    pixel index as K, [1, pixels/8, npad/8, 2, 8, 4], element [0, s, j, h,
    n, k] = g[pixel 8 s + 4 h + k, 8 j + n] (zero past cout); the 64
    pixels of sub-tile u are the contiguous [64 u npad, + 64 npad)."""
    n, hh, ww, _ = shape
    pixels = n * hh * ww
    g = _t(np.random.RandomState(27).randn(n, hh, ww, cout)
           .astype(np.float32))
    p = mc.wgrad_pack(g, f32=True)
    npad = mc.wgmma_width(cout)
    assert p.dtype == torch.float32 and p.is_contiguous()
    assert p.shape == (1, pixels // 8, npad // 8, 2, 8, 4)
    b = p[0].permute(0, 2, 4, 1, 3).reshape(pixels, npad)
    gf = g.reshape(pixels, cout)
    assert torch.equal(b[:, :cout], gf)
    assert not b[:, cout:].any()
    flat = p.reshape(-1)
    rs = np.random.RandomState(5)
    for _ in range(50):
        px, co = int(rs.randint(pixels)), int(rs.randint(cout))
        s_, h, k, j, nn = px // 8, px % 8 // 4, px % 4, co // 8, co % 8
        off = (((s_ * (npad // 8) + j) * 2 + h) * 8 + nn) * 4 + k
        assert flat[off] == gf[px, co]
    for u in range(pixels // 64):
        got = flat[64 * u * npad:64 * (u + 1) * npad]
        got = got.reshape(8, npad // 8, 2, 8, 4).permute(0, 2, 4, 1, 3)
        assert torch.equal(got.reshape(64, npad), b[64 * u:64 * (u + 1)])


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the 5x5 AR convs at the eval chunk's 64 images and the training batch
CARD_F32 = [(n, cin, cout) for n in (64, 32) for cin, cout in WIDTHS]


@pytest.mark.cuda
@pytest.mark.parametrize("n,cin,cout", CARD_F32)
def test_tf32_kernels_match_f64_twin_on_card(cuda, n, cin, cout):
    """Each f32 kernel on the 3xTF32 route against the twin in f64: the
    forward within 1e-5 of the output's max, dx and dW (live taps; dead
    ones zero) within 1e-5 of each one's max (the emulation reaches
    ~1e-6); one launch each in the count."""
    x, w, m = _inputs(5, (n, 16, 16, cin), cout, seed=31)
    taps = nonzero_taps(m)
    tx, tw = _t(x).to(cuda), _t(w).to(cuda)
    g = torch.randn(n, 16, 16, cout, generator=torch.Generator()
                    .manual_seed(32)).to(cuda)
    assert mc.fwd_route(tx, tw, taps) == "3xtf32"
    assert mc.bwd_route(tx, tw, taps) == ("3xtf32", "3xtf32")
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = ops.masked_conv2d(tx, tw, taps)
        dx, dw = ops.masked_conv2d_bwd(tx, tw, g, taps)
    torch.cuda.synchronize()
    assert ops.launch_counts()["masked_conv2d"] == 1
    assert ops.launch_counts()["masked_conv2d_bwd"] == 1
    want = ops.masked_conv2d_ref(tx.double(), tw.double(), taps)
    rdx, rdw = ops.masked_conv2d_bwd_ref(tx.double(), tw.double(),
                                         g.double(), taps)
    for got, ref in ((out, want), (dx, rdx), (dw, rdw)):
        assert got.dtype == torch.float32
        assert _rel(got, ref) <= LIMIT_F32
    live = torch.zeros(5, 5, 1, 1, device=cuda)
    for dy, dx_ in taps:
        live[dy, dx_] = 1.0
    assert not (dw * (1 - live)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", WIDTHS)
def test_tf32_backward_bitwise_repeatable_on_card(cuda, cin, cout):
    """At batch 32 two f32 backward calls give the same bits (wgrad's
    partials are summed in chunk order, never by atomics); so do two
    forward calls."""
    x, w, m = _inputs(5, (32, 16, 16, cin), cout, seed=33)
    taps = nonzero_taps(m)
    tx, tw = _t(x).to(cuda), _t(w).to(cuda)
    g = torch.randn(32, 16, 16, cout, generator=torch.Generator()
                    .manual_seed(34)).to(cuda)
    first = ops.masked_conv2d_bwd(tx, tw, g, taps)
    second = ops.masked_conv2d_bwd(tx, tw, g, taps)
    with torch.inference_mode():
        assert torch.equal(ops.masked_conv2d(tx, tw, taps),
                           ops.masked_conv2d(tx, tw, taps))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_fake_byte_counts_match_the_built_libraries(cuda):
    """``_FakeLib``, the routes' byte counts on a machine without nvcc,
    against the built libraries' own (``wg_plan``, the wgrad stages) at
    the 5x5 convs' forward and dgrad shapes, bf16 and f32, at W = 16, 32,
    64 and 128: the same stages where the conv fits (2 or more; below 2
    the C division truncates where Python's floors), the same wgrad
    bytes."""
    from iaf_torch.ops.ar_stack import _SMEM_LIMIT
    fwd, bwd = mc._lib(), mc._bwd_lib()
    for w_ in (16, 32, 64, 128):
        for cin, cout in WIDTHS + tuple((b, a) for a, b in WIDTHS):
            npad = mc.wgmma_width(cout)
            for f32 in (True, False):
                args = (w_, cin, 5, 2, npad, 13, _SMEM_LIMIT, int(f32))
                got = fwd.masked_conv_wgmma_stages(*args)
                want = _FakeLib.masked_conv_wgmma_stages(*args)
                assert (got >= 2) == (want >= 2), (args, got, want)
                if got >= 2:
                    assert got == want, (args, got, want)
            args = (16, w_, cin, 5, 2, npad)
            assert (bwd.masked_conv_wgrad_wgmma_smem(*args)
                    == _FakeLib.masked_conv_wgrad_wgmma_smem(*args)), args
            assert (bwd.masked_conv_wgrad_tf32_smem(*args)
                    == _FakeLib.masked_conv_wgrad_tf32_smem(*args)), args
