"""Backward parity with ``iaf_tpu`` on the CPU, f32.

Each kernel's plain backward (autograd of its twin) against the JAX
``custom_vjp`` backward of the Pallas kernel (interpret mode) on the same
numpy inputs and cotangents; then the model's parameter gradients against
``jax.value_and_grad`` of the train-mode loss with JAX's posterior draws
injected. Tolerances are relative to each output's (each leaf's) largest
magnitude: 1e-5 for the kernels; for the whole model 2e-4 at the tiny
config (measured 1.1e-4: the loss sums ~1400 nats through two stacks, and
XLA fuses the reductions in another order) and 1e-4 at paper width
(measured 2.6e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.core.config import Config as JConfig
from iaf_tpu.core.rng import fold_name
from iaf_tpu.models import cvae as jcvae
from iaf_tpu.ops.ar_stack import ar_stack_fused
from iaf_tpu.ops.fused import disc_logistic_logp as j_dl, iaf_update as j_iaf
from iaf_torch import ops
from iaf_torch.bridge import from_jax_params, to_jax_params
from iaf_torch.core.config import Config
from iaf_torch.models import cvae
from iaf_torch.nn.masks import get_conv_ar_mask

TINY = ("image_size=8,z_size=4,h_size=8,depth=1,num_blocks=2,depth_ar=2,"
        "kl_min=0.25,compute_dtype=float32")
PAPER_WIDTH = ("image_size=32,z_size=32,h_size=160,depth=1,num_blocks=2,"
               "depth_ar=2,kl_min=0.25,compute_dtype=float32")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max err {err} > {rel} x {scale}"


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


@pytest.mark.parametrize("zs,hs,n,hw,depth_ar", [
    (4, 8, 3, 6, 2), (4, 8, 2, 5, 3), (32, 160, 1, 16, 2)])
def test_ar_stack_bwd_ref_matches_jax_vjp(zs, hs, n, hw, depth_ar):
    rs = np.random.RandomState(depth_ar + hw)
    z = rs.randn(n, hw, hw, zs).astype(np.float32)
    c = rs.randn(n, hw, hw, hs).astype(np.float32)
    ws, bs, masks = _chain(rs, zs, hs, depth_ar)
    g = rs.randn(n, hw, hw, 2 * zs).astype(np.float32)
    nconv = len(ws)

    def f(z_, c_, *wb):
        return ar_stack_fused(z_, c_, list(wb[:nconv]), list(wb[nconv:]),
                              masks, batch_block=1)

    _, vjp = jax.vjp(f, jnp.asarray(z), jnp.asarray(c),
                     *map(jnp.asarray, ws), *map(jnp.asarray, bs))
    want = vjp(jnp.asarray(g))
    dz, dc, dws, dbs = ops.ar_stack_bwd_ref(_t(z), _t(c), [_t(w) for w in ws],
                                            [_t(b) for b in bs], _t(g))
    got = [dz, dc, *dws, *dbs]
    names = ["dz", "dcontext"] + [f"dW{i}" for i in range(nconv)] + \
        [f"db{i}" for i in range(nconv)]
    for name, a, b in zip(names, got, want):
        _close(a.numpy(), b, 1e-5, name)
    # the row-trimmed twin gives kernel row 2 no gradient (the tap right of
    # the centre gets one, which the mask multiply upstream zeroes)
    for dw in dws:
        assert not dw[2].any()


def test_iaf_update_bwd_ref_matches_jax_vjp():
    rs = np.random.RandomState(1)
    args = [rs.randn(3, 4, 4, 8).astype(np.float32) for _ in range(4)]
    gz, glq = (rs.randn(3, 4, 4, 8).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(j_iaf, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(gz), jnp.asarray(glq)))
    got = ops.iaf_update_bwd_ref(*map(_t, args), _t(gz), _t(glq))
    for name, a, b in zip(("dz", "dm", "ds", "dlogqs"), got, want):
        _close(a.numpy(), b, 1e-6, name)


def test_disc_logistic_bwd_ref_matches_jax_vjp():
    rs = np.random.RandomState(2)
    shape = (3, 8, 8, 3)
    sample = (rs.randint(0, 256, shape) / 256.0 - 0.5).astype(np.float32)
    mean = (sample + 0.05 * rs.randn(*shape)).astype(np.float32)
    g = rs.randn(3).astype(np.float32)
    ls = np.float32(-3.0)
    _, vjp = jax.vjp(lambda m_, l_: j_dl(m_, l_, jnp.asarray(sample)),
                     jnp.asarray(mean), jnp.asarray(ls))
    dmean_j, dls_j = vjp(jnp.asarray(g))
    dmean, dls = ops.disc_logistic_bwd_ref(_t(mean), torch.tensor(ls),
                                           _t(sample), _t(g))
    _close(dmean.numpy(), dmean_j, 1e-5, "dmean")
    _close(dls.numpy(), dls_j, 1e-5, "dlogscale")


def _model_grads(hp, n, rel, seed=0):
    jcfg, tcfg = JConfig().parse(hp), Config().parse(hp)
    x = np.random.RandomState(seed).randint(
        0, 256, (n, tcfg.image_size, tcfg.image_size, 3)).astype(np.uint8)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k, xx: jcvae.init_params(jcfg, k, xx))(
            jax.random.PRNGKey(seed), jnp.asarray(x)))
    key = jax.random.PRNGKey(7)
    loss_j, g_j = jax.jit(jax.value_and_grad(
        lambda p: jcvae.apply_fn(jcfg, p, key, jnp.asarray(x),
                                 mode="train").loss))(params)

    model = cvae.CVAE(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    hw = tcfg.image_size // 2
    noise = {f"{nm}/z_post": _t(np.array(jax.random.normal(
        fold_name(fold_name(key, nm), "z_post"), (n, hw, hw, tcfg.z_size))))
        for nm in cvae.layer_names(tcfg)}
    out = cvae.apply_fn(tcfg, model, 0, x, mode="train", noise=noise)
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(loss_j),
                               rtol=1e-6)
    # the top layer's up_conv3 feeds nothing: no gradient in PyTorch,
    # zeros in JAX; the optimizer counts None as zeros
    top = len(model.blocks) - 1
    nones = sorted(k for k, p in model.named_parameters() if p.grad is None)
    assert nones == [f"blocks.{top}.up_conv3.{v}" for v in ("V", "b", "g")]
    got = to_jax_params({k: torch.zeros_like(p) if p.grad is None else p.grad
                         for k, p in model.named_parameters()})
    want = dict(jax.tree_util.tree_leaves_with_path(g_j))
    leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(leaves) == len(want)
    for path, leaf in leaves:
        _close(leaf, want[path], rel, jax.tree_util.keystr(path))
    assert not np.asarray(want[(jax.tree_util.DictKey("blocks"),
                                jax.tree_util.DictKey("up_conv3"),
                                jax.tree_util.DictKey("V"))])[top].any()


# kernel_size=5: every AR conv through K2's twin (autograd of the SAME
# conv); JAX differentiates its K2 route (kernels=pallas: the Pallas
# forward in interpret mode, the VJP of the SAME conv)
K5 = ",kernel_size=5,kernels=pallas"


@pytest.mark.parametrize("extra", ["", K5])
def test_model_grads_match_jax_tiny(extra):
    _model_grads(TINY + extra, 2, rel=2e-4)


@pytest.mark.parametrize("extra", ["", K5])
def test_model_grads_match_jax_paper_width(extra):
    _model_grads(PAPER_WIDTH + extra, 2, rel=1e-4)
