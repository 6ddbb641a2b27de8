"""The MNIST family's training and serving path in the port on the CPU:
a 5-step trajectory against JAX's ``make_train_step`` (f32, same bridged
state and batches, JAX's draws injected; 1e-4 of each leaf's max), the
JAX package's 300-step MNIST golden under the port's own RNG (eval NLL
45.5849 nats within 1 %), ``train`` then ``evaluate`` and the serving
modes on a tiny Bernoulli logdir, steps_per_dispatch 1 and 4 giving the
same trajectory, and checkpoints across the two packages."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu import train_lib as jtl
from iaf_tpu.core import checkpoint as jckpt
from iaf_tpu.core.rng import fold_name
from iaf_tpu.models import mnist_vae as jmv
from iaf_tpu.parallel import train_step as jts
from iaf_tpu.parallel.mesh import make_mesh
from iaf_torch import optim, train_lib
from iaf_torch.bridge import from_jax_params, to_jax_params
from iaf_torch.core import checkpoint as ckpt
from iaf_torch.data import feed
from iaf_torch.data.datasets import synthetic_dataset
from iaf_torch.models import mnist_vae as mv
from iaf_torch.parallel import train_step as ts

TINY = dict(dataset="synthetic", image_size=8, channels=1, z_size=4,
            h_size=8, ar_hidden_size=16, depth_ar=1, flow_depth=2,
            batch_size=8, seed=5, compute_dtype="float32", log_every=1,
            eval_batch_size=4, eval_k=4, eval_k_chunk=2)


def _cfg(tmp_path, name="run", **kw):
    return mv.mnist_config(**{**TINY, **kw}).replace(
        logdir=str(tmp_path / name))


def _close(got, want, rel, name=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max err {err} > {rel} x {scale}"


def _close_trees(got, want, rel):
    want = dict(jax.tree_util.tree_leaves_with_path(want))
    leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(leaves) == len(want)
    for path, leaf in leaves:
        _close(leaf, want[path], rel, jax.tree_util.keystr(path))


def test_trajectory_matches_jax(tmp_path):
    """5 binarized steps (kl_min 0.25, the gate update) of the port's
    ``train_step`` and JAX's compiled step from the same state."""
    kw = dict(TINY, kl_min=0.25, flow_update="gate")
    jcfg, tcfg = jmv.mnist_config(**kw), mv.mnist_config(**kw)
    ds = synthetic_dataset(8, 1, n_train=64, n_test=8, seed=1)
    it = feed.binarized_iterator(
        feed.batch_iterator(ds.train_x, tcfg.batch_size, tcfg.seed),
        tcfg.seed)
    batches = [next(it) for _ in range(5)]
    base_key = jax.random.PRNGKey(tcfg.seed)
    mesh = make_mesh(jcfg, jax.devices()[:1])
    jstate = jts.init_train_state(jcfg, jax.random.fold_in(base_key, 1),
                                  batches[0])
    model = mv.MnistVAE(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                       jstate.params)))
    tstate = ts.TrainState(model, optim.init_state(
        dict(model.named_parameters())))
    step_fn = jts.make_train_step(jcfg, mesh)
    jstate = jts.place_state(jstate, mesh, jcfg)
    for i, batch in enumerate(batches):
        key = jax.random.fold_in(base_key, i)
        jstate, jm = step_fn(jstate, key, jnp.asarray(batch))
        noise = {"z": torch.from_numpy(np.array(jax.random.normal(
            fold_name(key, "z"), (len(batch), tcfg.z_size))))}
        tstate, tm = ts.train_step(tcfg, tstate, i, batch, noise=noise)
        for name in ("loss", "nll_nats", "kl_obj", "log_pxz"):
            _close(float(tm[name]), float(jm[name]), 1e-4, name)
        assert "bits_per_dim" not in tm and "kl_per_layer" not in tm
    assert int(tstate.opt.step) == int(jstate.opt.step) == 5
    _close_trees(to_jax_params(tstate.params.state_dict()), jstate.params,
                 1e-4)
    _close_trees(to_jax_params(tstate.opt.ema), jstate.opt.ema, 1e-4)


def test_mnist_golden_under_the_ports_rng(tmp_path):
    """``tests/test_golden.py``'s 300-step MNIST golden (frozen under JAX:
    eval NLL 45.5849 nats), here with the port's own init and noise
    streams, at steps_per_dispatch=25: the same 1 % holds."""
    cfg = mv.mnist_config(
        image_size=8, z_size=4, h_size=8, ar_hidden_size=16, depth_ar=1,
        flow_depth=1, kl_min=0.0, learning_rate=0.005, batch_size=8,
        total_steps=300, ckpt_every=100000, log_every=100000,
        dataset="synthetic", channels=1, binarize=True, seed=7,
        compute_dtype="float32", steps_per_dispatch=25,
        logdir=str(tmp_path))
    ds = synthetic_dataset(cfg.image_size, cfg.channels, n_train=64,
                           n_test=32, seed=3)

    def fixed_batch():
        while True:
            yield ds.train_x[:cfg.batch_size]

    it = feed.binarized_iterator(fixed_batch(), cfg.seed)
    state = train_lib.train(cfg, max_steps=300, data_iter=it, device="cpu")
    xe = feed.dynamic_binarize(ds.test_x[:cfg.batch_size],
                               feed.binarize_rng(cfg.seed, -1))
    with torch.no_grad():
        out = mv.apply_fn(cfg, state.params, 99, xe, mode="eval", k=1)
    nll = float(out.loss)
    assert np.isfinite(nll)
    assert abs(nll - 45.5849) / 45.5849 < 0.01, nll


def test_train_then_evaluate_and_serve(tmp_path, capsys):
    """A tiny Bernoulli run with the heartbeat eval: one ``nll_nats`` row
    a step and ``eval_nll_nats`` at the heartbeat; ``evaluate`` returns a
    finite NLL in nats and ``eval_loop`` logs it; ``sample`` and
    ``reconstruct`` give uint8 Bernoulli means; ``invert_check`` raises
    (the CIFAR family's only)."""
    cfg = _cfg(tmp_path, total_steps=4, ckpt_every=4, eval_every=2)
    train_lib.train(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "step 4 loss" in out and " nats " in out
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    steps = [r["step"] for r in rows if "nll_nats" in r]
    assert steps == [1, 2, 3, 4]
    assert all("bits_per_dim" not in r for r in rows)
    beats = [r for r in rows if "eval_nll_nats" in r]
    assert [r["step"] for r in beats] == [2, 4]
    assert all(np.isfinite(r["eval_nll_nats"]) for r in beats)

    nll = train_lib.evaluate(cfg, max_batches=2, device="cpu")
    assert np.isfinite(nll) and nll > 0
    assert f"NLL {nll:.2f} nats" in capsys.readouterr().out
    train_lib.eval_loop(cfg, max_evals=1, max_batches=1, device="cpu")
    with open(tmp_path / "run" / "eval_test_metrics.jsonl") as f:
        row = json.loads(f.readline())
    assert row["step"] == 4 and np.isfinite(row["nll_nats"])

    imgs = train_lib.sample(cfg, num=3, temperature=[1.0, 0.5],
                            device="cpu")
    recon = train_lib.reconstruct(cfg, num=3, device="cpu")
    for a in (imgs, recon):
        assert a.dtype == np.uint8 and a.shape == (3, 8, 8, 1)
    with pytest.raises(NotImplementedError, match="CIFAR family"):
        train_lib.invert_check(cfg, device="cpu")


def test_steps_per_dispatch_4_equals_1(tmp_path):
    """S = 4 over 6 steps (4 + a tail of 2) gives the S = 1 run's final
    params, m, u, EMA and step, bit for bit, with its data binarized by
    (seed, step) inside ``train``."""
    states = [train_lib.train(_cfg(tmp_path, f"s{s}", steps_per_dispatch=s),
                              max_steps=6, device="cpu") for s in (1, 4)]
    a, b = states
    for (k, x), y in zip(a.params.state_dict().items(),
                         b.params.state_dict().values()):
        assert torch.equal(x, y), k
    for part in ("m", "u", "ema"):
        for k, x in getattr(a.opt, part).items():
            assert torch.equal(x, getattr(b.opt, part)[k]), (part, k)
    assert int(a.opt.step) == int(b.opt.step) == 6


def test_checkpoints_cross_the_two_packages(tmp_path, capsys):
    """A JAX MNIST run's checkpoint resumes in the port (restored at its
    step, exact leaves), and the port's next checkpoint restores in JAX
    with the same leaves."""
    kw = dict(TINY, ckpt_every=2, total_steps=2)
    jcfg = jmv.mnist_config(**kw).replace(logdir=str(tmp_path))
    jstate = jtl.train(jcfg)
    tcfg = mv.mnist_config(**kw).replace(logdir=str(tmp_path))
    step, state, key = train_lib.tree_to_state(
        ckpt.restore(ckpt.latest_checkpoint(str(tmp_path))), tcfg, "cpu")
    assert step == 2 and key == tcfg.seed
    _close_trees(to_jax_params(state.params.state_dict()),
                 jax.tree.map(np.asarray, jstate.params), 0.0)
    capsys.readouterr()
    out = train_lib.train(tcfg.replace(total_steps=4, ckpt_every=4),
                          device="cpu")
    assert "at step 2" in capsys.readouterr().out
    assert int(out.opt.step) == 4
    step, back, _ = jtl.tree_to_state(jckpt.restore(
        ckpt.latest_checkpoint(str(tmp_path))))
    assert step == 4 and int(back.opt.step) == 4
    _close_trees(back.params, to_jax_params(out.params.state_dict()), 0.0)
    _close_trees(back.opt.ema, to_jax_params(out.opt.ema), 0.0)
