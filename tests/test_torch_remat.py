"""``remat`` in the port (``scan_blocks=true,remat=true``: each IAF layer's
up and down pass checkpointed and recomputed in the backward) on the CPU,
f32, at a tiny CIFAR config:
- the port's loss and gradients against ``iaf_tpu``'s at the same flags
  (``jax.checkpoint`` of the scanned layer body), JAX's draws injected:
  the loss at rtol 1e-5, each gradient leaf at 1e-4 of its max;
- the remat gradients against the port's plain ones on the same params
  and noise, bitwise;
- the recompute: fewer bytes saved for the backward, counted through
  ``torch.autograd.graph.saved_tensors_hooks``; ``remat`` without
  ``scan_blocks``, ``scan_blocks`` alone, an eval forward and the MNIST
  family save what the plain step saves;
- ``TrainStep``'s body under remat against the eager ``train_step``,
  bitwise: a case of ``test_torch_dispatch.py ::
  test_static_step_equals_eager_train_step``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.core.config import Config as JConfig
from iaf_tpu.models import cvae as jcvae
from iaf_torch.bridge import from_jax_params, to_jax_params
from iaf_torch.core.config import Config
from iaf_torch.models import cvae, get_model
from test_torch_train import TINY, _close, _jax_noise

REMAT = ",scan_blocks=true,remat=true"
MNIST = ("dataset=synthetic,likelihood=bernoulli,binarize=false,"
         "ar_kind=dense,image_size=8,channels=1,z_size=4,h_size=8,"
         "ar_hidden_size=16,depth_ar=1,flow_depth=2,kl_min=0.25,"
         "batch_size=4,seed=5,compute_dtype=float32")


def _batch(cfg, n=4, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (n, cfg.image_size, cfg.image_size, cfg.channels)
    ).astype(np.uint8)


def _grads(cfg, model, x, noise):
    """The train-mode loss and every parameter's gradient (None as
    zeros)."""
    for p in model.parameters():
        p.grad = None
    out = cvae.apply_fn(cfg, model, 0, x, mode="train", noise=noise)
    out.loss.backward()
    return out.loss.detach(), {
        k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
        for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's loss and gradients at scan_blocks=true,remat=true on the
    port's data-dependent init, bridged."""
    jcfg, tcfg = JConfig().parse(TINY + REMAT), Config().parse(TINY + REMAT)
    x = _batch(jcfg)
    params = to_jax_params(cvae.init_params(tcfg, x, rng=3,
                                            device="cpu").state_dict())
    key = jax.random.PRNGKey(7)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jcvae.apply_fn(jcfg, p, key, jnp.asarray(x),
                                 mode="train").loss))(params)
    return dict(x=x, params=params, key=key, loss=float(loss), grads=grads)


def _port(hp, ref):
    cfg = Config().parse(hp)
    model = cvae.CVAE(cfg, device="cpu")
    model.load_state_dict(from_jax_params(ref["params"]))
    noise = _jax_noise(cfg, ref["key"], ref["x"].shape[0])
    return cfg, model, noise


def test_remat_matches_jax(jax_ref):
    cfg, model, noise = _port(TINY + REMAT, jax_ref)
    loss, grads = _grads(cfg, model, jax_ref["x"], noise)
    np.testing.assert_allclose(float(loss), jax_ref["loss"], rtol=1e-5)
    want = dict(jax.tree_util.tree_leaves_with_path(jax_ref["grads"]))
    got = jax.tree_util.tree_leaves_with_path(to_jax_params(grads))
    assert len(got) == len(want)
    for path, leaf in got:
        _close(leaf, want[path], 1e-4, jax.tree_util.keystr(path))


def test_remat_equals_the_plain_step(jax_ref):
    """On the CPU the recompute gives the forward's bits again, so the
    gradients are bitwise the plain step's."""
    cfg, model, noise = _port(TINY + REMAT, jax_ref)
    loss_r, g_r = _grads(cfg, model, jax_ref["x"], noise)
    loss_p, g_p = _grads(Config().parse(TINY), model, jax_ref["x"], noise)
    assert torch.equal(loss_r, loss_p)
    for k in g_p:
        assert torch.equal(g_r[k], g_p[k]), k


def _saved_bytes(hp, mode="train"):
    """Bytes the backward keeps (packed through ``saved_tensors_hooks``
    outside any checkpoint) for one forward of ``hp``'s family."""
    cfg = Config().parse(hp)
    family = get_model(cfg)
    model = family.Model(cfg, device="cpu")
    x = _batch(cfg)
    noise = {site: torch.from_numpy(np.random.RandomState(1).standard_normal(
        shape).astype(np.float32))
        for site, shape in family.noise_shapes(cfg, x.shape[0]).items()}
    seen = []

    def pack(t):
        seen.append(t.numel() * t.element_size())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = family.apply_fn(cfg, model, 0, x, mode=mode, noise=noise)
    out.loss.backward()
    return sum(seen)


def test_remat_saves_fewer_bytes():
    plain, remat = _saved_bytes(TINY), _saved_bytes(TINY + REMAT)
    assert remat < plain / 2, (remat, plain)


@pytest.mark.parametrize("hp,mode", [
    (TINY + ",remat=true", "train"),          # remat without scan_blocks
    (TINY + ",scan_blocks=true", "train"),    # scan_blocks alone
    (TINY + REMAT, "eval"),                   # an eval forward
    (MNIST + REMAT, "train")])                # the MNIST family
def test_no_recompute_saves_what_plain_saves(hp, mode):
    plain = TINY if hp.startswith(TINY) else MNIST
    assert _saved_bytes(hp, mode) == _saved_bytes(plain, mode)

