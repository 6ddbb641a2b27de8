"""K1/K3/K4: each plain twin against the JAX Pallas kernel (interpret mode)
and its XLA twin on the same numpy inputs (f32, 1e-5); the CPU wrappers
route to the twins; a non-CPU tensor never does. The card tests at the end
hold each kernel to its twin on CUDA and skip where there is no card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.ops.ar_stack import ar_stack_fused, ar_stack_xla
from iaf_tpu.ops.fused import (disc_logistic_logp as j_dl_pallas,
                               disc_logistic_xla, iaf_update as j_iaf_pallas,
                               iaf_update_xla)
from iaf_torch import ops
from iaf_torch.core.device import resolve_device
from iaf_torch.nn.masks import get_conv_ar_mask

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
    (4, 8, 3, 6, 2), (4, 8, 2, 5, 3), (32, 160, 1, 16, 2)])
def test_ar_stack_ref_matches_pallas_and_xla(zs, hs, n, hw, depth_ar):
    z, c, ws, bs, masks = _k1_inputs(zs, hs, n, hw, depth_ar)
    want_pl = np.asarray(ar_stack_fused(jnp.asarray(z), jnp.asarray(c),
                                        [jnp.asarray(w) for w in ws],
                                        [jnp.asarray(b) for b in bs], masks,
                                        batch_block=1))
    wb = [jnp.asarray(t) for pair in zip(ws, bs) for t in pair]
    want_xla = np.asarray(ar_stack_xla(jnp.asarray(z), jnp.asarray(c), *wb))
    got = ops.ar_stack_ref(_t(z), _t(c), [_t(w) for w in ws],
                           [_t(b) for b in bs]).numpy()
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
    assert ops.launch_counts() == {"ar_stack": 0, "iaf_update": 0,
                                   "disc_logistic_logp": 0}


def test_non_cpu_tensors_never_reach_twins():
    """A tensor off the CPU launches its kernel or raises; there is no
    fallback (meta tensors stand in for a device without a kernel)."""
    z, c, ws, bs, masks = _k1_inputs(4, 8, 2, 6)
    meta = lambda a: torch.empty(a.shape, device="meta")  # noqa: E731
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.ar_stack(meta(z), meta(c), [meta(w) for w in ws],
                     [meta(b) for b in bs], masks)
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.iaf_update(*[meta(x) for x in _k3_inputs()])
    mean, _, sample = _k4_inputs()
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.disc_logistic_logp(meta(mean), torch.empty((), device="meta"),
                               meta(sample))


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


def test_fragment_packing_matches_mma_layout():
    """The tensor-core path's weight packing puts, for lane g*4+tig, the B
    elements (k = 2*tig + {0,1} and 8 + 2*tig + {0,1}, n = g) of each
    m16n8k16 fragment next to each other."""
    from iaf_torch.ops.ar_stack import LIVE_TAPS, pack_fragments
    cin, cout = 32, 24
    w = torch.arange(9 * cin * cout, dtype=torch.float32).reshape(
        3, 3, cin, cout)
    pk = pack_fragments(w).reshape(5, cout // 8, cin // 16, 32, 2, 2)
    for t, (dy, dx) in enumerate(LIVE_TAPS):
        for nt in range(cout // 8):
            for ks in range(cin // 16):
                for lane in range(32):
                    g, tig = divmod(lane, 4)
                    for half in range(2):
                        for e in range(2):
                            k = ks * 16 + half * 8 + 2 * tig + e
                            assert pk[t, nt, ks, lane, half, e] == \
                                w[dy, dx, k, nt * 8 + g]


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
@pytest.mark.parametrize("zs,hs,n,hw", [(32, 160, 8, 16), (4, 8, 3, 6)])
def test_ar_stack_kernel_matches_twin_on_card(cuda, dtype, zs, hs, n, hw):
    z, c, ws, bs, masks = _k1_inputs(zs, hs, n, hw)
    args = (_t(z).to(cuda, dtype), _t(c).to(cuda),
            [_t(w).to(cuda, dtype) for w in ws], [_t(b).to(cuda) for b in bs])
    with torch.inference_mode():
        got = ops.ar_stack(*args, masks)
        want = ops.ar_stack_ref(*args)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


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
