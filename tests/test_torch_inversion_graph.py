"""The inversion's loops on the device (``models/inversion.py``): the
predicated blocks of sweeps, run eagerly on the CPU as on the card they
run as replayed CUDA graphs, against the host loops (``*_host``) for all
three inverses and both flow forms at blocks of 1, 3 and 64 sweeps (64
longer than every loop here), bitwise; the fixed point's count against
JAX's ``invert_ar_fixed_point``; and a tolerance reached in mid-block,
after which the block's idle sweeps leave z, the change and the count as
they were."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.models import inversion as jinv
from iaf_torch.core.config import Config
from iaf_torch.models import cvae, inversion

# z_size=2: D = 4 * 4 * 2 = 32 sweeps, under the 64-sweep block
TINY = ("image_size=8,z_size=2,h_size=8,depth=1,num_blocks=2,depth_ar=2,"
        "compute_dtype=float32")
BLOCKS = (1, 3, 64)


def _probe(form: str):
    """The top layer's ``ar_fn`` (K1's twin) and the z' its flow gives on
    two images, from the port's init."""
    cfg = Config().parse(TINY + f",flow_update={form}")
    x = np.random.RandomState(3).randint(0, 256, (2, 8, 8, 3)).astype(
        np.uint8)
    model = cvae.init_params(cfg, x, rng=3, device="cpu")
    with torch.inference_mode():
        z0, ctx, ar_fn = cvae.posterior_flow_probe(cfg, model, 0, x)
        z_prime, _ = cvae.iaf_flow(cfg, model.blocks[-1], z0, ctx,
                                   torch.zeros_like(z0))
    return cfg, ar_fn, z_prime


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("form", ["division", "gate"])
@pytest.mark.parametrize("inverse", ["exact", "jacobi", "fixed_point"])
def test_blocks_are_bitwise_the_host_loops(inverse, form, block):
    cfg, ar_fn, z_prime = _probe(form)
    kw = dict(form=form, gate_bias=cfg.gate_forget_bias)
    D = int(np.prod(z_prime.shape[1:]))
    assert D < 64
    with torch.inference_mode():
        if inverse == "exact":
            got = inversion.invert_ar_exact(ar_fn, z_prime, block=block,
                                            **kw)
            want = inversion.invert_ar_exact_host(ar_fn, z_prime, **kw)
        elif inverse == "jacobi":
            # D sweeps, and fewer than a block's worth at 3 and 64
            got = inversion.invert_ar_jacobi(ar_fn, z_prime, D - 1,
                                             block=block, **kw)
            want = inversion.invert_ar_jacobi_host(ar_fn, z_prime, D - 1,
                                                   **kw)
        else:
            got, n = inversion.invert_ar_fixed_point(ar_fn, z_prime,
                                                     block=block, **kw)
            want, n_host = inversion.invert_ar_fixed_point_host(
                ar_fn, z_prime, **kw)
            assert n == n_host and 1 < n < D, (n, n_host)
    assert torch.equal(got, want)
    assert float(torch.max(torch.abs(got - z_prime))) > 0


def _roll_case():
    """z = z' + 0.25 roll(z) from zeros: the changes are 4^-(i-1), exact
    in binary, so the fixed point stops at sweep 11 at tol 1e-6 in both
    packages (``test_torch_inversion``)."""
    z_prime = np.ones((1, 4, 4, 2), np.float32)

    def ar_fn(z):
        return 0.25 * torch.roll(z, 1, dims=-1), torch.zeros_like(z)

    def jar(z):
        return 0.25 * jnp.roll(z, 1, axis=-1), jnp.zeros_like(z)
    return torch.from_numpy(z_prime), jnp.asarray(z_prime), ar_fn, jar


@pytest.mark.parametrize("block", BLOCKS)
def test_fixed_point_count_equals_jax(block):
    tz, jz, ar_fn, jar = _roll_case()
    for max_iters in (None, 3):
        z, n = inversion.invert_ar_fixed_point(ar_fn, tz, max_iters=max_iters,
                                               block=block)
        jz_out, jn = jinv.invert_ar_fixed_point(jar, jz, max_iters=max_iters)
        assert n == int(jn) == (11 if max_iters is None else 3)
        np.testing.assert_allclose(z.numpy(), np.asarray(jz_out), rtol=1e-6)


def test_idle_sweeps_after_a_mid_block_exit_change_nothing():
    """Block 8: the exit at sweep 11 falls in the second block, whose
    sweeps 12-16 are idle; the state after it is the host loop's at sweep
    11 (z and the change), and one more block moves nothing."""
    tz, _, ar_fn, _ = _roll_case()
    loop = inversion._FixedPoint(ar_fn, tz, 1e-6, 32, "division", 0.0, 8)
    blocks = 0
    while bool(loop.live):
        loop.sweeps()
        blocks += 1
    assert blocks == 2 and int(loop.i) == 11
    sweeps = inversion.fixed_point_sweeps(ar_fn, tz)
    for _ in range(11):
        z_host, change = next(sweeps)
    assert torch.equal(loop.z, z_host) and float(loop.delta) == change
    assert change <= 1e-6 < 4.0 * change
    state = (loop.z.clone(), loop.delta.clone(), loop.i.clone())
    loop.sweeps()
    assert torch.equal(loop.z, state[0]) and torch.equal(loop.delta,
                                                         state[1])
    assert int(loop.i) == 11 and not bool(loop.live)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", ["exact", "jacobi", "fixed_point"])
def test_replayed_blocks_are_bitwise_the_host_loops_on_card(inverse):
    """On the card (K1 in f32 through its kernel): blocks of 3 sweeps,
    the first eager, the second captured and replayed, the rest replays;
    bitwise the host loop, the fixed point's count equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    cfg = Config().parse(TINY)
    x = np.random.RandomState(3).randint(0, 256, (2, 8, 8, 3)).astype(
        np.uint8)
    model = cvae.init_params(cfg, x, rng=3, device="cuda")
    with torch.inference_mode():
        z0, ctx, ar_fn = cvae.posterior_flow_probe(cfg, model, 0, x)
        zp, _ = cvae.iaf_flow(cfg, model.blocks[-1], z0, ctx,
                              torch.zeros_like(z0))
        D = int(np.prod(zp.shape[1:]))
        if inverse == "exact":
            got = inversion.invert_ar_exact(ar_fn, zp, block=3)
            want = inversion.invert_ar_exact_host(ar_fn, zp)
        elif inverse == "jacobi":
            got = inversion.invert_ar_jacobi(ar_fn, zp, D, block=3)
            want = inversion.invert_ar_jacobi_host(ar_fn, zp, D)
        else:
            got, n = inversion.invert_ar_fixed_point(ar_fn, zp, block=3)
            want, n_host = inversion.invert_ar_fixed_point_host(ar_fn, zp)
            assert n == n_host
    assert torch.equal(got, want)
