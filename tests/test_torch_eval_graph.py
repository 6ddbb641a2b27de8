"""The graphed IW eval step (``eval_step.make_graphed_eval_step``) on the
CPU, where its body runs eagerly: bitwise the eager ``make_eval_step`` for
both model families (1 and 3 chunks, drawn and injected noise), within
the existing tolerance of JAX's ``make_eval_step`` on injected noise,
weights copied in place (or another model) seen by the next call, a batch
of another shape refused, and ``make_eval_setup``'s choice of step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.core.config import Config as JConfig
from iaf_tpu.core.rng import fold_name
from iaf_tpu.models import mnist_vae as jmv
from iaf_tpu.parallel import eval_step as jev
from iaf_tpu.parallel.mesh import make_mesh
from iaf_torch import train_lib
from iaf_torch.bridge import to_jax_params
from iaf_torch.core.config import Config
from iaf_torch.data import datasets
from iaf_torch.models import cvae
from iaf_torch.models import mnist_vae as mv
from iaf_torch.parallel import eval_step, mesh

CIFAR = ("image_size=8,z_size=4,h_size=8,depth=1,num_blocks=2,depth_ar=2,"
         "compute_dtype=float32")
MNIST = dict(image_size=8, z_size=4, h_size=8, ar_hidden_size=16,
             depth_ar=2, compute_dtype="float32")
N = 2
# (k, eval_k_chunk): one chunk, three chunks
CHUNKS = {1: (4, 4), 3: (6, 2)}


def _setup(family: str, chunk: int, seed: int = 0):
    """(JAX config, port config, uint8 images, port model) of ``family``
    at the chunking ``CHUNKS[chunk]``, from the port's init (held to
    JAX's in test_torch_cvae and test_torch_mnist)."""
    k_chunk = CHUNKS[chunk][1]
    rs = np.random.RandomState(seed)
    if family == "cifar":
        hp = CIFAR + f",eval_k_chunk={k_chunk}"
        jcfg, tcfg = JConfig().parse(hp), Config().parse(hp)
        x = rs.randint(0, 256, (N, 8, 8, 3)).astype(np.uint8)
        model = cvae.init_params(tcfg, x, rng=seed, device="cpu")
    else:
        kw = dict(MNIST, eval_k_chunk=k_chunk)
        jcfg, tcfg = jmv.mnist_config(**kw), mv.mnist_config(**kw)
        # the dense layers' data-dependent init wants more than N rows
        x = (rs.rand(4 * N, 8, 8, 1) > 0.6).astype(np.uint8) * 255
        model = mv.init_params(tcfg, x, rng=seed, device="cpu")
        x = x[:N]
    return jcfg, tcfg, x, model


def _jax_noise(family, cfg, key, rows):
    """One chunk's noise dict: JAX's draws at the chunk key ``key``."""
    if family == "mnist":
        return {"z": torch.from_numpy(np.array(jax.random.normal(
            fold_name(key, "z"), (rows, cfg.z_size))))}
    hw = cfg.image_size // 2
    return {f"{n}/z_post": torch.from_numpy(np.array(jax.random.normal(
        fold_name(fold_name(key, n), "z_post"), (rows, hw, hw, cfg.z_size))))
        for n in cvae.layer_names(cfg)}


def _chunk_noise(family, cfg, key, k):
    """Every chunk's noise for JAX key ``key`` on a one-shard mesh:
    fold(key, shard 0), then fold(chunk)."""
    k_chunk, n_chunks = eval_step.k_chunking(k, cfg.eval_k_chunk)
    return [_jax_noise(family, cfg, jax.random.fold_in(
        jax.random.fold_in(key, 0), i), N * k_chunk)
        for i in range(n_chunks)]


@pytest.mark.parametrize("injected", [False, True], ids=["drawn", "injected"])
@pytest.mark.parametrize("chunk", sorted(CHUNKS))
@pytest.mark.parametrize("family", ["cifar", "mnist"])
def test_graphed_body_is_bitwise_the_eager_step(family, chunk, injected):
    """Two calls (other keys, other noise) through one graphed step: each
    bitwise the eager step's."""
    _, tcfg, x, model = _setup(family, chunk)
    k = CHUNKS[chunk][0]
    eager = eval_step.make_eval_step(tcfg, "cpu", k=k)
    graphed = eval_step.make_graphed_eval_step(tcfg, "cpu", k=k)
    assert graphed.n_chunks == chunk
    for rng in (3, 4):
        noise = (_chunk_noise(family, tcfg, jax.random.PRNGKey(rng), k)
                 if injected else None)
        want = eager(model, rng, x, noise=noise)
        got = graphed(model, rng, x, noise=noise)
        assert bool(torch.isfinite(want).all())
        assert torch.equal(got, want), (got, want)
    graphed.close()


@pytest.mark.parametrize("family", ["cifar", "mnist"])
def test_graphed_step_matches_jax(family):
    jcfg, tcfg, x, model = _setup(family, 3, seed=2)
    params = to_jax_params(model.state_dict())
    k = CHUNKS[3][0]
    key = jax.random.PRNGKey(11)
    mesh_ = make_mesh(jcfg, jax.devices()[:1])
    want = np.asarray(jev.make_eval_step(jcfg, mesh_, k=k)(
        params, key, jnp.asarray(x)))
    got = eval_step.make_graphed_eval_step(tcfg, "cpu", k=k)(
        model, 0, x, noise=_chunk_noise(family, tcfg, key, k))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("how", ["copied_in_place", "another_model"])
@pytest.mark.parametrize("family", ["cifar", "mnist"])
def test_new_weights_are_read_by_the_next_call(family, how):
    """After a call, the weights of another init copied into the model
    in place (``load_state_dict``, as ``eval_loop`` loads a checkpoint),
    or another model passed: the next call equals a fresh eager step on
    the new weights, bitwise, and differs from the old weights' result."""
    _, tcfg, x, model = _setup(family, 3)
    _, _, _, other = _setup(family, 3, seed=5)
    k = CHUNKS[3][0]
    graphed = eval_step.make_graphed_eval_step(tcfg, "cpu", k=k)
    before = graphed(model, 7, x)
    if how == "copied_in_place":
        ptrs = [p.data_ptr() for p in model.parameters()]
        model.load_state_dict(other.state_dict())
        assert ptrs == [p.data_ptr() for p in model.parameters()]
        target = model
    else:
        target = other
    got = graphed(target, 7, x)
    fresh = eval_step.make_eval_step(tcfg, "cpu", k=k)(other, 7, x)
    assert torch.equal(got, fresh)
    assert not torch.equal(got, before)


def test_a_batch_of_another_shape_raises():
    _, tcfg, x, model = _setup("cifar", 1)
    graphed = eval_step.make_graphed_eval_step(tcfg, "cpu", k=4)
    graphed(model, 0, x)
    with pytest.raises(ValueError, match="buffers hold"):
        graphed(model, 0, x[:1])
    with pytest.raises(ValueError, match="injected noise"):
        graphed(model, 0, x, noise=[{site: t[:1] for site, t in
                                     _chunk_noise("cifar", tcfg,
                                                  jax.random.PRNGKey(0),
                                                  4)[0].items()}])


def test_eval_setup_hands_out_the_graphed_step_for_the_k_sharded_path(
        monkeypatch):
    """A k the world size divides takes the graphed step; at a world size
    of 2 (faked: no collective runs here) k = 1 takes the batch-sharded
    path, which stays eager."""
    cfg = Config().parse(CIFAR + ",dataset=synthetic,eval_batch_size=2")
    imgs = datasets.synthetic_dataset(8, 3, n_train=4, n_test=4, seed=9)
    monkeypatch.setattr(train_lib, "load_dataset",
                        lambda *a, **kw: (imgs, False))
    _, fn = train_lib.make_eval_setup(cfg, "eval_test", 4, "cpu")
    assert isinstance(fn, eval_step.EvalStep) and fn.k == 4
    monkeypatch.setattr(mesh, "world", lambda: 2)
    _, fn = train_lib.make_eval_setup(cfg, "eval_test", 2, "cpu")
    assert isinstance(fn, eval_step.EvalStep) and fn.k_chunk == 1
    _, fn = train_lib.make_eval_setup(cfg, "eval_test", 1, "cpu")
    assert not isinstance(fn, eval_step.EvalStep)
    assert fn.__qualname__.startswith("make_batch_sharded_elbo")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["cifar", "mnist"])
def test_graphed_step_is_bitwise_the_eager_step_on_card(family):
    """On the card, bf16: the first batch warms up, captures and replays;
    a second batch replays only; a weight copy in place is read by the
    next replay. Every result bitwise the eager step's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    _, tcfg, x, model = _setup(family, 3)
    tcfg = tcfg.replace(compute_dtype="bfloat16")
    _, _, _, other = _setup(family, 3, seed=5)
    model, other = model.cuda(), other.cuda()
    k = CHUNKS[3][0]
    eager = eval_step.make_eval_step(tcfg, "cuda", k=k)
    graphed = eval_step.make_graphed_eval_step(tcfg, "cuda", k=k)
    for rng in (3, 4):
        assert torch.equal(graphed(model, rng, x), eager(model, rng, x))
    model.load_state_dict(other.state_dict())
    assert torch.equal(graphed(model, 5, x), eager(other, 5, x))
    graphed.close()
