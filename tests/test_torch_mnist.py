"""Port parity for the MNIST family (``iaf_torch.models.mnist_vae``)
against ``iaf_tpu.models.mnist_vae`` on the CPU, in f32, with the same
params (bridged) and JAX's draws injected as ``noise``: the forward (every
``MnistOut`` field at rtol 1e-5) and every gradient leaf (1e-4 of its
max) over both flow updates, flow depths 0-2, k in {1, 4} and kl_min in
{0, 0.25}; ``ARMultiDense`` alone; ``sample``; the data-dependent init's
g and b from the same V; the bridge round trip of an MNIST tree and
checkpoint (``dec1``/``dec2`` transposed as deconvs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.core.checkpoint import flatten_pytree
from iaf_tpu.core.rng import fold_name
from iaf_tpu.models import mnist_vae as jmv
from iaf_tpu.nn import layers as jl
from iaf_torch.bridge import from_jax_params, load_jax_checkpoint, \
    to_jax_params, to_torch_layout
from iaf_torch.models import get_model
from iaf_torch.models import mnist_vae as mv
from iaf_torch.nn.layers import ARMultiDense

TINY = dict(image_size=8, z_size=4, h_size=8, ar_hidden_size=16,
            depth_ar=2, compute_dtype="float32")
RTOL = 1e-5


def _cfgs(**kw):
    kw = {**TINY, **kw}
    return jmv.mnist_config(**kw), mv.mnist_config(**kw)


def _binary(n, size, seed):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, size, size, 1) > 0.6).astype(np.uint8) * 255


def _setup(seed=0, n=6, **kw):
    jcfg, tcfg = _cfgs(**kw)
    x = _binary(n, tcfg.image_size, seed)
    params = jax.tree.map(np.asarray, jmv.init_params(
        jcfg, jax.random.PRNGKey(seed), jnp.asarray(x)))
    model = mv.MnistVAE(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    return jcfg, tcfg, x, params, model


def _jax_draw(key, site, shape):
    return torch.from_numpy(np.array(jax.random.normal(
        fold_name(key, site), shape)))


def _close(got, want, name, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()),
                                               1e-30), err_msg=name)


def test_config_and_family_dispatch():
    """``mnist_config`` is the JAX package's field for field, 45 leaves
    and 6,716,290 parameters at full width; ``get_model`` sends Bernoulli
    configs to it."""
    from iaf_torch.core.config import Config
    cfg = mv.mnist_config()
    want = jmv.mnist_config()
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__}
    assert get_model(cfg) is mv
    assert get_model(Config()).__name__ == "iaf_torch.models.cvae"
    model = mv.MnistVAE(cfg, device="cpu")
    params = list(model.parameters())
    assert len(params) == 45
    assert sum(p.numel() for p in params) == 6_716_290


@pytest.mark.parametrize("kl_min", [0.0, 0.25])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("flow_depth", [0, 1, 2])
@pytest.mark.parametrize("update", ["division", "gate"])
def test_forward_and_grads_match_jax(update, flow_depth, k, kl_min):
    jcfg, tcfg, x, params, model = _setup(
        seed=flow_depth, flow_update=update, flow_depth=flow_depth,
        kl_min=kl_min)
    key = jax.random.PRNGKey(11)
    noise = {"z": _jax_draw(key, "z", (len(x) * k, tcfg.z_size))}

    def jloss(p):
        out = jmv.apply_fn(jcfg, p, key, jnp.asarray(x), k=k)
        return out.loss, out

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    got = mv.apply_fn(tcfg, model, 0, x, k=k, noise=noise)
    got.loss.backward()
    for field in ("loss", "elbo_nats", "nll_nats", "kl_obj", "kl_cost",
                  "log_pxz", "log_w", "logits"):
        _close(getattr(got, field).detach().numpy(), getattr(want, field),
               field)
    jg = from_jax_params(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        # a leaf the loss does not reach (enc_context with no flow): None
        # here, zeros in JAX
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(float(jg[name].abs().max()), 1e-30)
        err = float((grad - jg[name]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_ar_multidense_matches_jax():
    """The MADE net alone: masked hidden layers (the first zero-diagonal,
    the context after it), two heads."""
    rs = np.random.RandomState(4)
    z = rs.randn(5, 4).astype(np.float32)
    ctx = rs.randn(5, 16).astype(np.float32)
    widths = [(4, 16), (16, 16), (16, 4), (16, 4)]
    names = ["layer_0", "layer_1", "layer_out_0", "layer_out_1"]
    tree = {n: {"V": (0.3 * rs.randn(*w)).astype(np.float32),
                "g": (1 + 0.2 * rs.randn(w[1])).astype(np.float32),
                "b": (0.1 * rs.randn(w[1])).astype(np.float32)}
            for n, w in zip(names, widths)}
    want = jl.ar_multidense(jl.Ctx(params={"made": tree}), "made",
                            jnp.asarray(z), jnp.asarray(ctx), [16, 16],
                            [4, 4])
    made = ARMultiDense(4, [16, 16], [4, 4], device="cpu")
    with torch.no_grad():
        for n in names:
            layer = getattr(made, n)
            layer.V.copy_(torch.from_numpy(np.ascontiguousarray(
                to_torch_layout((n, "V"), tree[n]["V"]))))
            layer.g.copy_(torch.from_numpy(tree[n]["g"]))
            layer.b.copy_(torch.from_numpy(tree[n]["b"]))
        got = made(torch.from_numpy(z), torch.from_numpy(ctx))
    assert np.all(made.layer_0.mask.numpy().diagonal() == 0)
    for g, w in zip(got, want):
        _close(g.numpy(), w, "head")


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_sample_matches_jax(temperature):
    jcfg, tcfg, _, params, model = _setup(seed=2)
    key = jax.random.PRNGKey(5)
    want = jmv.sample(jcfg, params, key, 3, temperature)
    noise = {"z_prior": _jax_draw(key, "z_prior", (3, tcfg.z_size))}
    with torch.inference_mode():
        got = mv.sample(tcfg, model, 0, 3, temperature, noise=noise)
    assert got.shape == (3, 8, 8, 1)
    _close(got.numpy(), want, "sample", rtol=1e-5)


def test_init_params_matches_jax():
    """Same V, batch and posterior draw -> the same g and b in every
    layer."""
    jcfg, tcfg, x, params, model = _setup(seed=3, n=16, flow_depth=2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith(".V"):
                p.fill_(0.0)
    noise = {"z": _jax_draw(jax.random.PRNGKey(3), "z", (16, tcfg.z_size))}
    mv.init_params(tcfg, x, model=model, noise=noise)
    want = from_jax_params(params)
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_bridge_round_trip_and_checkpoint(tmp_path):
    """An MNIST tree goes across and back exactly (``dec1``/``dec2`` as
    deconvs, dense ``V`` transposed, no ``blocks``), and a JAX checkpoint's
    EMA and raw weights load into the port's model."""
    _, tcfg, _, params, model = _setup(seed=1)
    assert tuple(model.dec1.V.shape) == (16, 8, 5, 5)
    np.testing.assert_array_equal(
        model.dec1.V.detach().numpy(),
        params["dec1"]["V"].transpose(2, 3, 0, 1))
    back = to_jax_params(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    ema = jax.tree.map(lambda a: a + 1.0, params)
    np.savez(tmp_path / "ckpt-000000001.npz",
             **flatten_pytree({"params": params, "opt": {"ema": ema}}))
    path = str(tmp_path / "ckpt-000000001.npz")
    fresh = mv.MnistVAE(tcfg, device="cpu")
    fresh.load_state_dict(load_jax_checkpoint(path))
    for name, t in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[name], t + 1.0,
                                   rtol=0, atol=1e-6)
    fresh.load_state_dict(load_jax_checkpoint(path, use_ema=False))
    for name, t in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], t)

