"""Port parity: ``iaf_torch.nn.layers`` against ``iaf_tpu.nn.layers`` with
the same V/g/b and inputs (f32, tolerance 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.nn import layers as jl
from iaf_tpu.nn.masks import get_conv_ar_mask
from iaf_torch.bridge import to_torch_layout
from iaf_torch.nn import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _wn_params(rs, shape, n_out):
    return {"V": (0.3 * rs.randn(*shape)).astype(np.float32),
            "g": (1.0 + 0.2 * rs.randn(n_out)).astype(np.float32),
            "b": (0.1 * rs.randn(n_out)).astype(np.float32)}


def _load(module, p, path=("conv", "V")):
    with torch.no_grad():
        module.V.copy_(torch.from_numpy(np.ascontiguousarray(
            to_torch_layout(path, p["V"]))))
        module.g.copy_(torch.from_numpy(p["g"]))
        module.b.copy_(torch.from_numpy(p["b"]))
    return module


def _jax_conv(p, x, **kw):
    ctx = jl.Ctx(params={"c": p})
    return np.asarray(jl.conv2d(ctx, "c", jnp.asarray(x), p["g"].shape[0],
                                **kw))


@pytest.mark.parametrize("shape,cout,k,stride", [
    ((2, 8, 8, 6), 10, 3, 1),      # trunk conv
    ((2, 32, 32, 3), 16, 5, 2),    # stem: stride-2 SAME pads (1, 2)
    ((1, 7, 5, 4), 6, 5, 2),       # odd sizes
])
def test_wn_conv_matches_jax(shape, cout, k, stride):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    p = _wn_params(rs, (k, k, shape[-1], cout), cout)
    want = _jax_conv(p, x, filter_size=(k, k), stride=(stride, stride))
    mod = _load(tl.WNConv2d(shape[-1], cout, (k, k), (stride, stride)), p)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_wn_dense_matches_jax(masked):
    from iaf_tpu.nn.masks import get_linear_ar_mask
    rs = np.random.RandomState(6)
    x = rs.randn(3, 5, 8).astype(np.float32)
    mask = get_linear_ar_mask(8, 16, True) if masked else None
    p = _wn_params(rs, (8, 16), 16)
    ctx = jl.Ctx(params={"d": p})
    want = np.asarray(jl.dense(ctx, "d", jnp.asarray(x), 16, mask=mask))
    mod = _load(tl.WNDense(8, 16, mask=mask), p)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_deconv_flip_and_crop_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 16, 16, 12).astype(np.float32)
    p = _wn_params(rs, (5, 5, 12, 3), 3)
    ctx = jl.Ctx(params={"x_dec": p})
    want = np.asarray(jl.deconv2d(ctx, "x_dec", jnp.asarray(x), 3,
                                  filter_size=(5, 5), stride=(2, 2)))
    mod = _load(tl.WNDeconv2d(12, 3, (5, 5), (2, 2)), p, ("x_dec", "V"))
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("zd", [True, False])
def test_ar_row_trim_conv_matches_jax(zd):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 6, 6, 4).astype(np.float32)
    mask = get_conv_ar_mask(3, 3, 4, 8, zd)
    p = _wn_params(rs, (3, 3, 4, 8), 8)
    want = _jax_conv(p, x, mask=mask, trim_rows=True)
    untrimmed = _jax_conv(p, x, mask=mask, trim_rows=False)
    mod = _load(tl.WNConv2d(4, 8, mask=mask, trim_rows=True), p)
    assert mod.trim_row == 1
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, untrimmed, **TOL)


def _ar_params(rs, zs, hs, depth_ar, merge, k=3):
    p, prev = {}, zs
    for i in range(depth_ar):
        p[f"layer_{i}"] = _wn_params(rs, (k, k, prev, hs), hs)
        prev = hs
    if merge:
        p["layer_out"] = _wn_params(rs, (k, k, hs, 2 * zs), 2 * zs)
    else:
        for i in range(2):
            p[f"layer_out_{i}"] = _wn_params(rs, (k, k, hs, zs), zs)
    return p


def _load_ar(mod, p):
    for name, sub in p.items():
        _load(getattr(mod, name), sub)
    return mod


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("merge", [True, False])
def test_ar_multiconv2d_heads_match_jax(merge, k):
    """3x3: K1's chain (its twin here) and the conv-by-conv route against
    JAX's default path; 5x5: the conv-by-conv route through K2 (its twin
    here) against JAX's ``pallas_conv`` route (K2 in interpret mode)."""
    rs = np.random.RandomState(3)
    zs, hs = 4, 8
    z = rs.randn(2, 6, 6, zs).astype(np.float32)
    c = rs.randn(2, 6, 6, hs).astype(np.float32)
    p = _ar_params(rs, zs, hs, 2, merge, k)
    ctx = jl.Ctx(params={"ar1": p})
    want = jl.ar_multiconv2d(ctx, "ar1", jnp.asarray(z), jnp.asarray(c),
                             [hs, hs], [zs, zs], filter_size=(k, k),
                             trim_rows=True, merge_heads=merge,
                             pallas_conv=(k != 3))
    mod = _load_ar(tl.ARMultiConv2d(zs, [hs, hs], [zs, zs], (k, k),
                                    merge_heads=merge), p)
    assert mod.fusable == (k == 3)
    with torch.no_grad():
        fused = mod(torch.from_numpy(z), torch.from_numpy(c))
        unfused = mod.forward_unfused(torch.from_numpy(z), torch.from_numpy(c))
    for a, b, w in zip(fused, unfused, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_data_dependent_init_matches_jax():
    """g/b of the init from the same V and batch, for a masked AR conv, the
    stride-2 stem and the deconv."""
    rs = np.random.RandomState(4)
    x = rs.randn(4, 8, 8, 4).astype(np.float32)
    mask = get_conv_ar_mask(3, 3, 4, 8, True)
    V = (0.05 * rs.randn(3, 3, 4, 8)).astype(np.float32)
    Vs = (0.05 * rs.randn(5, 5, 4, 6)).astype(np.float32)
    Vd = (0.05 * rs.randn(5, 5, 4, 3)).astype(np.float32)
    ctx = jl.Ctx(params={"a": {"V": V}, "s": {"V": Vs}, "d": {"V": Vd}},
                 rng=jax.random.PRNGKey(0), init=True)
    xj = jnp.asarray(x)
    outs = [jl.conv2d(ctx, "a", xj, 8, mask=mask, trim_rows=True,
                      init_scale=0.1),
            jl.conv2d(ctx, "s", xj, 6, filter_size=(5, 5), stride=(2, 2)),
            jl.deconv2d(ctx, "d", xj, 3, filter_size=(5, 5), stride=(2, 2))]
    mods = [tl.WNConv2d(4, 8, mask=mask, trim_rows=True, init_scale=0.1),
            tl.WNConv2d(4, 6, (5, 5), (2, 2)), tl.WNDeconv2d(4, 3, (5, 5))]
    for mod, name, Vn, want in zip(mods, "asd", (V, Vs, Vd), outs):
        path = ("x_dec", "V") if name == "d" else ("c", "V")
        with torch.no_grad():
            mod.V.copy_(torch.from_numpy(np.ascontiguousarray(
                to_torch_layout(path, Vn))))
            got = mod.init_forward(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(mod.g.detach().numpy(),
                                   np.asarray(ctx.root[name]["g"]), **TOL)
        np.testing.assert_allclose(mod.b.detach().numpy(),
                                   np.asarray(ctx.root[name]["b"]), **TOL)


@pytest.mark.parametrize("k", [3, 5])
def test_torch_ar_multiconv2d_is_autoregressive(k):
    """The AR-Jacobian check of tests/test_masks.py on the port's chain
    (K1's at 3x3, K2's conv by conv at 5x5): head element i depends only
    on z elements strictly before it in raster-then-channel order."""
    rs = np.random.RandomState(5)
    zs, hs, H = 2, 4, 3
    p = _ar_params(rs, zs, hs, 2, True, k)
    mod = _load_ar(tl.ARMultiConv2d(zs, [hs, hs], [zs, zs], (k, k)), p)
    c = torch.from_numpy(rs.randn(1, H, H, hs).astype(np.float32))

    def f(zflat):
        m, s = mod(zflat.reshape(1, H, H, zs), c)
        return torch.cat([m.reshape(-1), s.reshape(-1)])

    z0 = torch.from_numpy(rs.randn(H * H * zs).astype(np.float32))
    J = torch.autograd.functional.jacobian(f, z0).numpy()
    n = H * H * zs
    for head in range(2):
        Jh = J[head * n:(head + 1) * n]
        for i in range(n):
            assert np.allclose(Jh[i, i:], 0.0, atol=1e-7), (head, i)
        assert np.abs(Jh).sum() > 0


def test_deep_3x3_chain_through_k2_matches_k1_and_jax():
    """A 3x3 chain deeper than K1's shared memory holds at paper widths
    (depth_ar=10, tiny widths here): conv by conv through K2's twin
    (``forward_unfused``, the route the card takes) equals K1's twin
    (``forward``, the CPU route) and JAX's ``ar_multiconv2d``."""
    rs = np.random.RandomState(6)
    zs, hs, depth_ar = 4, 8, 10
    z = rs.randn(2, 6, 6, zs).astype(np.float32)
    c = rs.randn(2, 6, 6, hs).astype(np.float32)
    p = _ar_params(rs, zs, hs, depth_ar, True)
    ctx = jl.Ctx(params={"ar1": p})
    want = jl.ar_multiconv2d(ctx, "ar1", jnp.asarray(z), jnp.asarray(c),
                             [hs] * depth_ar, [zs, zs], trim_rows=True,
                             merge_heads=True)
    mod = _load_ar(tl.ARMultiConv2d(zs, [hs] * depth_ar, [zs, zs]), p)
    assert mod.fusable
    with torch.no_grad():
        fused = mod(torch.from_numpy(z), torch.from_numpy(c))
        unfused = mod.forward_unfused(torch.from_numpy(z), torch.from_numpy(c))
    for a, b, w in zip(fused, unfused, want):
        np.testing.assert_allclose(b.numpy(), np.asarray(w), **TOL)
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


@pytest.mark.parametrize("fits", [True, False])
def test_deep_chain_route(monkeypatch, fits):
    """``ARMultiConv2d.forward`` sends a fusable chain to K1 where
    ``k1_fits`` holds and conv by conv to K2 where it does not, deciding
    before any launch."""
    from iaf_torch import ops
    rs = np.random.RandomState(7)
    mod = _load_ar(tl.ARMultiConv2d(2, [4] * 3, [2, 2]),
                   _ar_params(rs, 2, 4, 3, True))
    calls = {"ar_stack": 0, "masked_conv2d": 0}
    for name in calls:
        original = getattr(ops, name)

        def spy(*args, _name=name, _orig=original):
            calls[_name] += 1
            return _orig(*args)
        monkeypatch.setattr(ops, name, spy)
    monkeypatch.setattr(tl.ARMultiConv2d, "k1_fits",
                        staticmethod(lambda z, ws: fits))
    with torch.no_grad():
        mod(torch.from_numpy(rs.randn(1, 3, 3, 2).astype(np.float32)),
            torch.from_numpy(rs.randn(1, 3, 3, 4).astype(np.float32)))
    assert calls == ({"ar_stack": 1, "masked_conv2d": 0} if fits
                     else {"ar_stack": 0, "masked_conv2d": 4})


@pytest.mark.parametrize("n_convs,fits", [(10, True), (11, False)])
def test_ar_stack_fits_reads_the_byte_count(n_convs, fits):
    """The route predicate compares K1's byte count for (convs, W, cz, ch,
    cout, dtype, route) with one Hopper block's shared memory: a fake count
    that passes the limit past 10 convs picks K2 for 11 and K1 for 10, and
    is asked with the tensor-core kernel's flag for bf16 and for f32
    (3xTF32) at paper widths, and with the FMA kernel's for f32 at a
    hidden width the tensor cores do not take in f32."""
    from iaf_torch.ops.ar_stack import _SMEM_LIMIT, ar_stack_fits
    seen = []

    def fake_bytes(n, w, cz, ch, cout, bf16, wgmma):
        seen.append((n, w, cz, ch, cout, bf16, wgmma))
        return _SMEM_LIMIT if n <= 10 else _SMEM_LIMIT + 1
    assert ar_stack_fits(n_convs, 16, 32, 160, 64, torch.bfloat16,
                         fake_bytes) is fits
    assert ar_stack_fits(n_convs, 16, 32, 160, 64, torch.float32,
                         fake_bytes) is fits
    assert ar_stack_fits(n_convs, 16, 32, 256, 64, torch.float32,
                         fake_bytes) is fits
    assert seen == [(n_convs, 16, 32, 160, 64, 1, 1),
                    (n_convs, 16, 32, 160, 64, 0, 1),
                    (n_convs, 16, 32, 256, 64, 0, 0)]
