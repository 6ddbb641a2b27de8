"""The CIFAR model with ``ar_kind=dense`` against ``iaf_tpu`` on the CPU,
f32: each IAF step's AR net is a MADE over the channel vector at every
latent position (``ARMultiDense``, JAX's ``ar_multidense``). With bridged
params and JAX's posterior draws injected: every ``ModelOut`` field at
rtol 1e-5, atol 1e-4 nats (k = 1 and 4, both flow updates), every
gradient leaf at 1e-4 of its max, a 3-step trajectory of the port's
``train_step`` against JAX's ``make_train_step`` at 1e-4 of each leaf's
max, the bridge's round trip exact, and an unknown ``ar_kind`` refused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.core.config import Config as JConfig
from iaf_tpu.core.rng import fold_name
from iaf_tpu.models import cvae as jcvae
from iaf_tpu.parallel import train_step as jts
from iaf_tpu.parallel.mesh import make_mesh
from iaf_torch import optim
from iaf_torch.bridge import from_jax_params, to_jax_params
from iaf_torch.core.config import Config
from iaf_torch.data import feed
from iaf_torch.data.datasets import synthetic_dataset
from iaf_torch.models import cvae
from iaf_torch.nn.layers import ARMultiDense
from iaf_torch.parallel import train_step as ts

DENSE = ("image_size=8,z_size=4,h_size=8,depth=1,num_blocks=2,depth_ar=2,"
         "ar_kind=dense,kl_min=0.25,compute_dtype=float32")


_SETUPS: dict = {}


def _setup(update: str):
    """(JAX config, port config, 2 images, JAX params, the port's model on
    them) for one flow update, made once for the file."""
    if update not in _SETUPS:
        hp = DENSE + f",flow_update={update}"
        jcfg, tcfg = JConfig().parse(hp), Config().parse(hp)
        x = np.random.RandomState(1).randint(
            0, 256, (2, 8, 8, 3)).astype(np.uint8)
        params = jax.tree.map(np.asarray, jax.jit(
            lambda k, b: jcvae.init_params(jcfg, k, b))(
                jax.random.PRNGKey(1), jnp.asarray(x)))
        _SETUPS[update] = jcfg, tcfg, x, params
    jcfg, tcfg, x, params = _SETUPS[update]
    model = cvae.CVAE(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    return jcfg, tcfg, x, params, model


def _jax_noise(cfg, key, rows):
    hw = cfg.image_size // 2
    return {f"{n}/z_post": torch.from_numpy(np.array(jax.random.normal(
        fold_name(fold_name(key, n), "z_post"), (rows, hw, hw, cfg.z_size))))
        for n in cvae.layer_names(cfg)}


def _close(got, want, rel, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max err {err} > {rel} x {scale}"


def _close_trees(got, want, rel):
    want = dict(jax.tree_util.tree_leaves_with_path(want))
    leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(leaves) == len(want)
    for path, leaf in leaves:
        _close(leaf, want[path], rel, jax.tree_util.keystr(path))


def test_dense_layers_and_bridge_round_trip():
    """Each layer's ``ar1`` is the MADE, and the stacked ``ar1/layer_{i}``
    and ``ar1/layer_out_{i}`` leaves go both ways exactly."""
    _, tcfg, _, params, model = _setup("division")
    assert all(isinstance(b.ar1, ARMultiDense) for b in model.blocks)
    assert set(params["blocks"]["ar1"]) == {"layer_0", "layer_1",
                                            "layer_out_0", "layer_out_1"}
    assert params["blocks"]["ar1"]["layer_1"]["V"].shape == (2, 8, 8)
    back = to_jax_params(model.state_dict())
    _close_trees(back, params, 0.0)
    assert (jax.tree.structure(back) == jax.tree.structure(params))


def test_unknown_ar_kind_raises():
    with pytest.raises(ValueError, match="unknown ar_kind 'made'"):
        cvae.CVAE(Config().parse(DENSE.replace("dense", "made")),
                  device="cpu")


@pytest.mark.parametrize("k,update", [(1, "division"), (4, "division"),
                                      (1, "gate"), (4, "gate")])
def test_dense_eval_forward_matches_jax(k, update):
    jcfg, tcfg, x, params, model = _setup(update)
    key = jax.random.PRNGKey(7)
    want = jcvae.apply_fn(jcfg, params, key, jnp.asarray(x), mode="eval",
                          k=k)
    with torch.inference_mode():
        got = cvae.apply_fn(tcfg, model, 0, x, mode="eval", k=k,
                            noise=_jax_noise(tcfg, key, 2 * k))
    for field in want._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-5, atol=1e-4, err_msg=field)


@pytest.mark.parametrize("update", ["division", "gate"])
def test_dense_model_grads_match_jax(update):
    jcfg, tcfg, x, params, model = _setup(update)
    key = jax.random.PRNGKey(3)
    loss_j, g_j = jax.jit(jax.value_and_grad(
        lambda p: jcvae.apply_fn(jcfg, p, key, jnp.asarray(x),
                                 mode="train").loss))(params)
    out = cvae.apply_fn(tcfg, model, 0, x, mode="train",
                        noise=_jax_noise(tcfg, key, 2))
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(loss_j),
                               rtol=1e-6)
    got = to_jax_params({k: torch.zeros_like(p) if p.grad is None else p.grad
                         for k, p in model.named_parameters()})
    _close_trees(got, g_j, 1e-4)


def test_dense_three_step_trajectory_matches_jax():
    """3 steps of the port's ``train_step`` against JAX's
    ``make_train_step`` on a one-device mesh from the same bridged state,
    same batches, JAX's draws for ``fold_in(base_key, step)`` injected."""
    hp = DENSE + ",dataset=synthetic,batch_size=4,seed=6"
    jcfg, tcfg = JConfig().parse(hp), Config().parse(hp)
    ds = synthetic_dataset(8, 3, n_train=32, n_test=4, seed=1)
    it = feed.batch_iterator(ds.train_x, tcfg.batch_size, tcfg.seed)
    batches = [next(it) for _ in range(3)]
    base_key = jax.random.PRNGKey(tcfg.seed)
    mesh = make_mesh(jcfg, jax.devices()[:1])
    jstate = jts.init_train_state(jcfg, jax.random.fold_in(base_key, 1),
                                  batches[0])
    model = cvae.CVAE(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, jstate.params)))
    tstate = ts.TrainState(model, optim.init_state(
        dict(model.named_parameters())))
    step_fn = jts.make_train_step(jcfg, mesh)
    jstate = jts.place_state(jstate, mesh, jcfg)
    for i, batch in enumerate(batches):
        key = jax.random.fold_in(base_key, i)
        jstate, jm = step_fn(jstate, key, jnp.asarray(batch))
        tstate, tm = ts.train_step(tcfg, tstate, i, batch,
                                   noise=_jax_noise(tcfg, key, len(batch)))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-4 * abs(float(jm["loss"]))
    _close_trees(to_jax_params(tstate.params.state_dict()), jstate.params,
                 1e-4)
    _close_trees(to_jax_params(tstate.opt.ema), jstate.opt.ema, 1e-4)
