"""Port parity for the CIFAR model and its eval path: the param bridge, the
data-dependent init, the whole eval forward (every ``ModelOut`` field) and
the streamed IW eval step against ``iaf_tpu`` with JAX's posterior draws
injected, and ``evaluate``'s tail padding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.core.config import Config as JConfig
from iaf_tpu.core.rng import fold_name
from iaf_tpu.models import cvae as jcvae
from iaf_tpu.parallel import eval_step as jev
from iaf_tpu.parallel.mesh import make_mesh
from iaf_torch import train_lib
from iaf_torch.bridge import (from_jax_params, load_jax_checkpoint,
                              to_jax_params)
from iaf_torch.core.config import Config
from iaf_torch.data import datasets
from iaf_torch.models import cvae
from iaf_torch.parallel.eval_step import make_eval_step

TINY = ("image_size=8,z_size=4,h_size=8,depth=1,num_blocks=2,depth_ar=2,"
        "compute_dtype=float32")
PAPER_WIDTH = ("image_size=32,z_size=32,h_size=160,depth=1,num_blocks=2,"
               "depth_ar=2,compute_dtype=float32")
# 5x5 convs: the AR nets go conv by conv through K2 (JAX: kernels=pallas
# runs K2 in interpret mode); depth_ar=4: five convs in K1's chain
K5 = ",kernel_size=5,kernels=pallas"
DEPTH4 = ",depth_ar=4"


def _setup(hp, n, seed=0):
    jcfg, tcfg = JConfig().parse(hp), Config().parse(hp)
    x = np.random.RandomState(seed).randint(
        0, 256, (n, tcfg.image_size, tcfg.image_size, 3)).astype(np.uint8)
    params = jax.tree.map(np.asarray, jcvae.init_params(
        jcfg, jax.random.PRNGKey(seed), jnp.asarray(x)))
    model = cvae.CVAE(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    return jcfg, tcfg, x, params, model


def _jax_noise(cfg, key, rows):
    hw = cfg.image_size // 2
    return {f"{n}/z_post": torch.from_numpy(np.array(jax.random.normal(
        fold_name(fold_name(key, n), "z_post"), (rows, hw, hw, cfg.z_size))))
        for n in cvae.layer_names(cfg)}


@pytest.mark.parametrize("extra", ["", K5])
def test_bridge_round_trip_exact(tmp_path, extra):
    _, tcfg, _, params, model = _setup(TINY + extra, 2)
    back = to_jax_params(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    # checkpoint keys: "//"-joined, EMA under opt//ema
    from iaf_tpu.core.checkpoint import flatten_pytree
    ema = jax.tree.map(lambda a: a + 1.0, params)
    flat = flatten_pytree({"params": params, "opt": {"ema": ema}})
    np.savez(tmp_path / "ckpt-000000001.npz", **flat)
    sd = load_jax_checkpoint(str(tmp_path / "ckpt-000000001.npz"))
    for name, t in model.state_dict().items():
        torch.testing.assert_close(sd[name], t + 1.0, rtol=0, atol=1e-6)
    raw = load_jax_checkpoint(str(tmp_path / "ckpt-000000001.npz"),
                              use_ema=False)
    for name, t in model.state_dict().items():
        assert torch.equal(raw[name], t)


def test_init_params_matches_jax():
    """Same V, h_top, batch and posterior draws -> the same g/b in every
    layer (JAX scans the init; reduction order differs slightly)."""
    jcfg, tcfg, x, params, model = _setup(TINY, 4, seed=3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".g") or name.endswith(".b"):
                p.fill_(0.0)
    noise = _jax_noise(tcfg, jax.random.PRNGKey(3), 4)
    cvae.init_params(tcfg, x, model=model, noise=noise)
    want = from_jax_params(params)
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def _compare_forward(hp, n, k, rtol, atol):
    jcfg, tcfg, x, params, model = _setup(hp, n, seed=1)
    key = jax.random.PRNGKey(7)
    want = jcvae.apply_fn(jcfg, params, key, jnp.asarray(x), mode="eval",
                          k=k)
    with torch.inference_mode():
        got = cvae.apply_fn(tcfg, model, 0, x, mode="eval", k=k,
                            noise=_jax_noise(tcfg, key, n * k))
    for field in want._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=rtol, atol=atol, err_msg=field)


@pytest.mark.parametrize("extra", ["", DEPTH4, K5])
def test_eval_forward_matches_jax_tiny(extra):
    _compare_forward(TINY + extra, 2, 2, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("extra", ["", ",kernel_size=5"])
def test_eval_forward_matches_jax_paper_width(extra):
    _compare_forward(PAPER_WIDTH + extra, 1, 2, rtol=1e-4, atol=1e-4)


def test_eval_step_matches_jax_one_device_mesh():
    """k=8 streamed in chunks of 4 with the per-chunk keys of a one-shard
    mesh: fold(rng, shard 0), then fold(chunk)."""
    hp = TINY + ",eval_k_chunk=4"
    jcfg, tcfg, x, params, model = _setup(hp, 2, seed=2)
    key = jax.random.PRNGKey(11)
    mesh = make_mesh(jcfg, jax.devices()[:1])
    want = np.asarray(jev.make_eval_step(jcfg, mesh, k=8)(
        params, key, jnp.asarray(x)))
    noise = [_jax_noise(tcfg, jax.random.fold_in(jax.random.fold_in(key, 0),
                                                 i), 2 * 4)
             for i in range(2)]
    got = make_eval_step(tcfg, "cpu", k=8)(model, 0, x, noise=noise)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_streamed_chunks_equal_one_chunk_bound():
    """The online logsumexp over chunks equals compute_lowerbound on the
    concatenated log-weights of the same draws."""
    hp = TINY + ",eval_k_chunk=2"
    _, tcfg, x, _, model = _setup(hp, 2, seed=4)
    key = jax.random.PRNGKey(5)
    noises = [_jax_noise(tcfg, jax.random.fold_in(key, i), 4)
              for i in range(3)]
    got = make_eval_step(tcfg, "cpu", k=6)(model, 0, x, noise=noises)
    with torch.inference_mode():
        log_w = torch.cat([cvae.apply_fn(tcfg, model, 0, x, mode="eval", k=2,
                                         noise=nz).log_w.reshape(2, 2)
                           for nz in noises], dim=1)
    from iaf_torch.distributions import logsumexp
    want = -(logsumexp(log_w) - np.log(6.0))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-4)


def test_evaluate_pads_the_tail(monkeypatch, capsys):
    """5 images at eval_batch_size=2: two full batches and a tail of one,
    padded to 2, of which only the real row counts."""
    hp = TINY + ",dataset=synthetic,eval_batch_size=2,eval_k_chunk=2"
    _, tcfg, _, _, model = _setup(hp, 2, seed=6)
    imgs = datasets.synthetic_dataset(8, 3, n_train=4, n_test=5, seed=9)
    monkeypatch.setattr(train_lib, "load_dataset",
                        lambda *a, **kw: (imgs, False))
    bpd = train_lib.evaluate(tcfg, "eval_test", params=model, k=4,
                             device="cpu")
    assert "k=4 n=5 " in capsys.readouterr().out
    step = make_eval_step(tcfg, "cpu", k=4)
    from iaf_torch.core.rng import fold
    key = tcfg.seed + 999
    parts = [step(model, fold(key, 0), imgs.test_x[0:2]),
             step(model, fold(key, 1), imgs.test_x[2:4]),
             step(model, fold(key, 2), imgs.test_x[[4, 4]])[:1]]
    nats = torch.cat(parts)
    assert nats.shape == (5,)
    want = float(nats.mean()) / (np.log(2.0) * tcfg.num_pixels)
    assert bpd == pytest.approx(want, rel=1e-6)
    # capped at the full batches: the tail is skipped
    train_lib.evaluate(tcfg, "eval_test", params=model, k=4, device="cpu",
                       max_batches=1)
    assert "k=4 n=2 " in capsys.readouterr().out


def test_synthetic_dataset_matches_jax():
    from iaf_tpu.data.datasets import synthetic_dataset as jsyn
    a = datasets.synthetic_dataset(32, 3, n_train=8, n_test=4, seed=3)
    b = jsyn(32, 3, n_train=8, n_test=4, seed=3)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
