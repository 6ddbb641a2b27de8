"""The port's flow probe and AR inversion against ``iaf_tpu`` on the CPU:
``posterior_flow_probe`` (z0, context and the top layer's ``ar_fn``) with
JAX's posterior draw injected, at 3x3 with depth_ar=2 (K1's twin) and at
5x5 (K2's twin); the three inverses of ``models/inversion.py`` on the
same z' and bridged params in both flow forms (within 1e-5 of max of
JAX's, the round trip within 1e-4, the fixed point in as many sweeps as
JAX's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.core.config import Config as JConfig
from iaf_tpu.core.rng import fold_name
from iaf_tpu.models import cvae as jcvae
from iaf_tpu.models import inversion as jinv
from iaf_tpu.nn.layers import Ctx
from iaf_torch.bridge import to_jax_params
from iaf_torch.core.config import Config
from iaf_torch.models import cvae, inversion

# depth_ar=2: a transposed position index inverts wrongly only past one
# hidden conv
TINY = ("image_size=8,z_size=4,h_size=8,depth=1,num_blocks=2,depth_ar=2,"
        "compute_dtype=float32")
K5 = ",kernel_size=5"


def _close(got, want, rel, name=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max err {err} > {rel} x {scale}"


def _probes(hp, n=2, seed=0):
    """JAX's and the port's probe on the same params, images and draw."""
    jcfg, tcfg = JConfig().parse(hp), Config().parse(hp)
    x = np.random.RandomState(seed).randint(
        0, 256, (n, tcfg.image_size, tcfg.image_size, 3)).astype(np.uint8)
    # the port's init (held to JAX's in test_torch_cvae), bridged
    model = cvae.init_params(tcfg, x, rng=seed, device="cpu")
    params = to_jax_params(model.state_dict())
    key = jax.random.PRNGKey(seed + 31337)
    want = jcvae.posterior_flow_probe(jcfg, params, key, jnp.asarray(x))
    top = cvae.layer_names(tcfg)[-1]
    hw = tcfg.image_size // 2
    noise = {f"{top}/z_post": torch.from_numpy(np.array(jax.random.normal(
        fold_name(fold_name(key, top), "z_post"), (n, hw, hw,
                                                   tcfg.z_size))))}
    with torch.inference_mode():
        got = cvae.posterior_flow_probe(tcfg, model, 0, x, noise=noise)
    return jcfg, tcfg, params, model, want, got


@pytest.mark.parametrize("extra", ["", K5])
def test_posterior_flow_probe_matches_jax(extra):
    _, _, _, _, (jz, jctx, jar), (z, ctx, ar_fn) = _probes(TINY + extra)
    _close(z, jz, 1e-5, "z0")
    _close(ctx, jctx, 1e-5, "context")
    jm, js = jar(jz)
    with torch.inference_mode():
        m, s = ar_fn(z)
    _close(m, jm, 1e-5, "m")
    _close(s, js, 1e-5, "s")


@pytest.mark.parametrize("extra", ["", K5, ",ar_kind=dense"])
def test_probe_ar_fn_equals_the_layers_forward_bitwise(extra):
    """The probe folds the top layer's AR weights once (``frozen``); its
    ``ar_fn`` gives the bits of ``top.ar1(z, context)``, the call it made
    on every sweep before (K1's twin at 3x3, K2's at 5x5, the dense MADE),
    at z0 and at another z."""
    tcfg = Config().parse(TINY + extra)
    x = np.random.RandomState(1).randint(
        0, 256, (2, tcfg.image_size, tcfg.image_size, 3)).astype(np.uint8)
    model = cvae.init_params(tcfg, x, rng=1, device="cpu")
    top = model.blocks[-1]
    with torch.inference_mode():
        z, ctx, ar_fn = cvae.posterior_flow_probe(tcfg, model, 0, x)
        for zq in (z, 0.5 * z + 0.25):
            m, s = ar_fn(zq)
            wm, ws = top.ar1(zq, ctx)
            assert torch.equal(m, wm * 0.1) and torch.equal(s, ws * 0.1)


def test_position_index_is_raster_then_channel():
    pos = inversion._ar_position_index((1, 3, 4, 2), "cpu")
    want = np.asarray(jinv._ar_position_index((1, 3, 4, 2)))
    np.testing.assert_array_equal(pos.numpy(), want)


@pytest.mark.parametrize("form", ["division", "gate"])
def test_inverses_match_jax(form):
    """z' from JAX's flow on the top layer; each inverse of the port (its
    ``ar_fn`` through K1's twin) against JAX's on that z'."""
    hp = TINY + f",flow_update={form}"
    jcfg, tcfg, params, _, (jz, jctx, jar), (z, _, ar_fn) = _probes(hp)
    jz_prime, _ = jcvae.iaf_flow(
        jcfg, Ctx(params=jcvae.top_layer_params(params)), jz, jctx,
        jnp.zeros_like(jz))
    z_prime = torch.from_numpy(np.array(jz_prime))
    D = int(np.prod(z_prime.shape[1:]))
    kw = dict(form=form, gate_bias=tcfg.gate_forget_bias)
    with torch.inference_mode():
        got = {"exact": inversion.invert_ar_exact(ar_fn, z_prime, **kw),
               "jacobi": inversion.invert_ar_jacobi(ar_fn, z_prime, D, **kw)}
        got["fixed_point"], iters = inversion.invert_ar_fixed_point(
            ar_fn, z_prime, tol=1e-6, **kw)
    want = {"exact": jinv.invert_ar_exact(jar, jz_prime, **kw),
            "jacobi": jinv.invert_ar_jacobi(jar, jz_prime, D, **kw)}
    want["fixed_point"], jiters = jinv.invert_ar_fixed_point(
        jar, jz_prime, tol=1e-6, **kw)
    for name in got:
        _close(got[name], want[name], 1e-5, name)
        assert float(torch.max(torch.abs(got[name] - z))) < 1e-4, name
    # at tol 1e-6 the deciding change is a few ulps of z (|z| ~ 3), so two
    # correct sums of the AR net may stop a sweep apart, as JAX's eager
    # and jitted loops do (tests/test_flow.py:107); at a tol halfway (in
    # log) between the port's changes either side of 1e-6 the counts are
    # equal
    assert abs(iters - int(jiters)) <= 1 and iters < D, (iters, int(jiters))
    with torch.inference_mode():
        deltas = inversion.sweep_changes(ar_fn, z_prime, 1e-6, **kw)
    tol = float(np.sqrt(deltas[-2] * deltas[-1]))
    with torch.inference_mode():
        _, iters = inversion.invert_ar_fixed_point(ar_fn, z_prime, tol=tol,
                                                   **kw)
    _, jiters = jinv.invert_ar_fixed_point(jar, jz_prime, tol=tol, **kw)
    assert iters == int(jiters) == len(deltas), (iters, int(jiters), deltas)


def test_fixed_point_count_and_cap_match_jax():
    """On z = z' + 0.25 roll(z) from zeros the changes are 4^-(i-1),
    exact in binary, so the early exit at tol 1e-6 comes at sweep 11 in
    both packages; ``max_iters`` caps the sweeps. In bf16 the port stops
    once two iterates are equal (sweep 5: the change is measured in f32
    on the bf16 iterates); JAX's jitted loop on the CPU does not stop
    there before D, so that case holds the port alone."""
    z_prime = np.ones((1, 4, 4, 2), np.float32)
    tz, jz = torch.from_numpy(z_prime), jnp.asarray(z_prime)

    def ar_fn(z):
        return 0.25 * torch.roll(z, 1, dims=-1), torch.zeros_like(z)

    def jar(z):
        return 0.25 * jnp.roll(z, 1, axis=-1), jnp.zeros_like(z)

    z, n = inversion.invert_ar_fixed_point(ar_fn, tz)
    jz_out, jn = jinv.invert_ar_fixed_point(jar, jz)
    assert n == int(jn) == 11, (n, int(jn))
    assert inversion.sweep_changes(ar_fn, tz, 1e-6) == [
        4.0 ** -i for i in range(11)]
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz_out))
    _, n = inversion.invert_ar_fixed_point(ar_fn, tz, max_iters=3)
    assert n == int(jinv.invert_ar_fixed_point(jar, jz, max_iters=3)[1]) == 3
    z16, n = inversion.invert_ar_fixed_point(ar_fn, tz.bfloat16())
    assert n == 5 and z16.dtype == torch.bfloat16
    assert torch.equal(z16, torch.ones_like(z16) + ar_fn(z16)[0])
