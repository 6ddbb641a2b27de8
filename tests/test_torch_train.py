"""The port's training path against ``iaf_tpu`` on the CPU: the data
order, a 10-step trajectory (the port's ``train_step`` against JAX's
``make_train_step`` on a one-device mesh, from the same bridged initial
state, on the same batches, with JAX's draws for ``fold_in(base_key,
step)`` injected; f32, 1e-4 relative to each leaf's largest magnitude on
loss, params and EMA), checkpoints in both directions, and
``fail_after_step`` then resume."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu import train_lib as jtl
from iaf_tpu.core import checkpoint as jckpt
from iaf_tpu.core.config import Config as JConfig
from iaf_tpu.core.rng import fold_name
from iaf_tpu.data import feed as jfeed
from iaf_tpu.parallel import train_step as jts
from iaf_tpu.parallel.mesh import make_mesh
from iaf_torch import optim, train_lib
from iaf_torch.bridge import from_jax_params, to_jax_params
from iaf_torch.core import checkpoint as ckpt
from iaf_torch.core.config import Config
from iaf_torch.data import feed
from iaf_torch.data.datasets import synthetic_dataset
from iaf_torch.models import cvae
from iaf_torch.parallel import train_step as ts

TINY = ("dataset=synthetic,image_size=8,z_size=4,h_size=8,depth=1,"
        "num_blocks=2,depth_ar=2,kl_min=0.25,batch_size=4,seed=5,"
        "compute_dtype=float32")
STEPS = 10


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


@pytest.mark.parametrize("start_step,procs", [(0, 1), (7, 1), (3, 2)])
def test_batch_iterator_equals_jax(start_step, procs):
    images = np.arange(22 * 2 * 2 * 3, dtype=np.uint8).reshape(22, 2, 2, 3)
    for pidx in range(procs):
        a = feed.batch_iterator(images, 4, 9, pidx, procs,
                                start_step=start_step)
        b = jfeed.batch_iterator(images, 4, 9, pidx, procs,
                                 start_step=start_step)
        for _ in range(12):
            np.testing.assert_array_equal(next(a), next(b))


def _jax_noise(cfg, key, rows):
    hw = cfg.image_size // 2
    return {f"{n}/z_post": torch.from_numpy(np.array(jax.random.normal(
        fold_name(fold_name(key, n), "z_post"), (rows, hw, hw, cfg.z_size))))
        for n in cvae.layer_names(cfg)}


def _run_trajectory(hp, steps):
    """``steps`` steps of the port's ``train_step`` and JAX's
    ``make_train_step`` side by side from the same bridged state."""
    jcfg, tcfg = JConfig().parse(hp), Config().parse(hp)
    ds = synthetic_dataset(8, 3, n_train=64, n_test=8, seed=1)
    batches = feed.batch_iterator(ds.train_x, tcfg.batch_size, tcfg.seed)
    batches = [next(batches) for _ in range(steps)]
    base_key = jax.random.PRNGKey(tcfg.seed)
    mesh = make_mesh(jcfg, jax.devices()[:1])
    jstate = jts.init_train_state(jcfg, jax.random.fold_in(base_key, 1),
                                  batches[0])
    params0 = jax.tree.map(np.asarray, jstate.params)
    model = cvae.CVAE(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params0))
    tstate = ts.TrainState(model, optim.init_state(
        dict(model.named_parameters())))
    step_fn = jts.make_train_step(jcfg, mesh)
    jstate = jts.place_state(jstate, mesh, jcfg)
    losses = []
    for i, batch in enumerate(batches):
        key = jax.random.fold_in(base_key, i)
        jstate, jm = step_fn(jstate, key, jnp.asarray(batch))
        tstate, tm = ts.train_step(tcfg, tstate, i, batch,
                                   noise=_jax_noise(tcfg, key, len(batch)))
        losses.append((float(tm["loss"]), float(jm["loss"])))
    return dict(jcfg=jcfg, tcfg=tcfg, jstate=jstate, tstate=tstate,
                losses=losses, base_key=base_key, batches=batches,
                step_fn=step_fn, mesh=mesh)


@pytest.fixture(scope="module")
def trajectory():
    return _run_trajectory(TINY, STEPS)


def _check_trajectory(run, steps):
    for i, (got, want) in enumerate(run["losses"]):
        assert abs(got - want) <= 1e-4 * abs(want), (i, got, want)
    jstate, tstate = run["jstate"], run["tstate"]
    assert int(tstate.opt.step) == int(jstate.opt.step) == steps
    _close_trees(to_jax_params(tstate.params.state_dict()), jstate.params,
                 1e-4)
    _close_trees(to_jax_params(tstate.opt.ema), jstate.opt.ema, 1e-4)


def test_ten_step_trajectory_matches_jax(trajectory):
    _check_trajectory(trajectory, STEPS)


def test_5x5_trajectory_matches_jax():
    """kernel_size=5 for 3 steps: the port's AR nets through K2's twin,
    JAX's through its K2 route (kernels=pallas, interpret mode)."""
    _check_trajectory(_run_trajectory(TINY + ",kernel_size=5,kernels=pallas",
                                      3), 3)


def test_port_checkpoint_loads_and_trains_in_jax(trajectory, tmp_path):
    tstate = trajectory["tstate"]
    path = ckpt.save(str(tmp_path), STEPS,
                     train_lib.state_to_tree(STEPS, tstate, 5))
    step, jstate, rng = jtl.tree_to_state(jckpt.restore(path))
    assert step == STEPS and int(jstate.opt.step) == STEPS
    np.testing.assert_array_equal(np.asarray(rng),
                                  np.asarray(jax.random.PRNGKey(5)))
    ref = trajectory["jstate"]
    assert (jax.tree.structure(jstate.params)
            == jax.tree.structure(ref.params))
    for got, want in ((jstate.params, tstate.params.state_dict()),
                      (jstate.opt.m, tstate.opt.m),
                      (jstate.opt.u, tstate.opt.u),
                      (jstate.opt.ema, tstate.opt.ema)):
        _close_trees(got, to_jax_params(want), 0.0)
    # and JAX trains on from it
    mesh = trajectory["mesh"]
    jstate = jts.place_state(jstate, mesh, trajectory["jcfg"])
    jstate, jm = trajectory["step_fn"](
        jstate, jax.random.fold_in(rng, STEPS),
        jnp.asarray(trajectory["batches"][0]))
    assert np.isfinite(float(jm["loss"])) and int(jstate.opt.step) == 11


def test_jax_checkpoint_resumes_in_port(trajectory, tmp_path, capsys):
    jstate, tcfg = trajectory["jstate"], trajectory["tcfg"]
    jckpt.save(str(tmp_path), STEPS,
               jtl.state_to_tree(STEPS, jstate, trajectory["base_key"]))
    tree = ckpt.restore(ckpt.latest_checkpoint(str(tmp_path)))
    step, state, key = train_lib.tree_to_state(tree, tcfg, "cpu")
    assert step == STEPS and key == tcfg.seed
    _close_trees(to_jax_params(state.params.state_dict()), jstate.params,
                 0.0)
    _close_trees(to_jax_params(state.opt.u), jstate.opt.u, 0.0)
    cfg = tcfg.replace(logdir=str(tmp_path), log_every=1, ckpt_every=100)
    out = train_lib.train(cfg, max_steps=STEPS + 2, device="cpu")
    assert f"at step {STEPS}" in capsys.readouterr().out
    assert int(out.opt.step) == STEPS + 2
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith(
        f"ckpt-{STEPS + 2:09d}.npz")


def test_checkpoint_keep_and_loader(tmp_path):
    """keep=2 retains the newest two; the loader hands each new checkpoint
    over once, with the tree JAX's restore reads from the same file."""
    loader = ckpt.CheckpointLoader(str(tmp_path))
    assert loader.maybe_load() is None
    for step in (1, 2, 3):
        ckpt.save(str(tmp_path), step, {"step": np.asarray(step),
                                        "w": [np.full(2, step, np.float32)]},
                  keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt-000000002.npz", "ckpt-000000003.npz"]
    path, tree = loader.maybe_load()
    assert path.endswith("ckpt-000000003.npz") and int(tree["step"]) == 3
    np.testing.assert_array_equal(tree["w"][0], jckpt.restore(path)["w"][0])
    assert loader.maybe_load() is None
    ckpt.save(str(tmp_path), 4, {"step": np.asarray(4)}, keep=2)
    assert int(loader.maybe_load()[1]["step"]) == 4


def test_fail_after_step_then_resume_is_exact(tmp_path, capsys):
    base = Config().parse(TINY + ",log_every=100,ckpt_every=2")
    whole = train_lib.train(base.replace(logdir=str(tmp_path / "a")),
                            max_steps=5, device="cpu")
    crash = base.replace(logdir=str(tmp_path / "b"), fail_after_step=3)
    with pytest.raises(RuntimeError, match="crash at step 3"):
        train_lib.train(crash, max_steps=5, device="cpu")
    assert ckpt.latest_checkpoint(str(tmp_path / "b")).endswith(
        "ckpt-000000002.npz")
    resumed = train_lib.train(crash.replace(fail_after_step=0), max_steps=5,
                              device="cpu")
    assert "at step 2" in capsys.readouterr().out
    for (k, a), b in zip(whole.params.state_dict().items(),
                         resumed.params.state_dict().values()):
        assert torch.equal(a, b), k
    for k in whole.opt.ema:
        assert torch.equal(whole.opt.ema[k], resumed.opt.ema[k]), k


def test_eval_heartbeat_scores_the_ema_like_jax(tmp_path):
    """eval_every=1: each step logs eval_bits_per_dim, which is the port's
    eval step on the EMA weights with the key fold(base, 2**31 + step);
    on the same EMA weights and JAX's draws for that key, JAX's heartbeat
    eval (k = min(eval_k, 64) on one device) gives the same bound."""
    import json

    from iaf_tpu.parallel import eval_step as jev
    from iaf_torch.core.rng import fold
    from iaf_torch.data.datasets import load_dataset
    from iaf_torch.parallel.eval_step import make_eval_step
    hp = TINY + ",eval_every=1,eval_batch_size=2,eval_k=4,log_every=1"
    cfg = Config().parse(hp).replace(logdir=str(tmp_path))
    state = train_lib.train(cfg, max_steps=2, device="cpu")
    with open(tmp_path / "metrics.jsonl") as f:
        beats = [r for r in map(json.loads, f) if "eval_bits_per_dim" in r]
    assert [r["step"] for r in beats] == [1, 2]

    ema = cvae.CVAE(cfg, device="cpu")
    ema.load_state_dict(state.opt.ema)
    images = load_dataset(cfg.dataset, cfg.data_dir, cfg.image_size,
                          cfg.channels)[0].test_x[:2]
    per_pixel = np.log(2.0) * cfg.num_pixels
    step_fn = make_eval_step(cfg, "cpu", k=4)
    own = step_fn(ema, fold(cfg.seed, 2**31 + 2), images)
    assert beats[1]["eval_bits_per_dim"] == pytest.approx(
        float(own.mean()) / per_pixel, rel=1e-6)
    raw = step_fn(state.params, fold(cfg.seed, 2**31 + 2), images)
    assert abs(float(raw.mean()) - float(own.mean())) > 1e-3  # EMA != params

    jcfg = JConfig().parse(hp)
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 2**31 + 2)
    want = jev.make_eval_step(jcfg, make_mesh(jcfg, jax.devices()[:1]), k=4)(
        to_jax_params(state.opt.ema), key, jnp.asarray(images))
    noise = [_jax_noise(cfg, jax.random.fold_in(jax.random.fold_in(key, 0),
                                                0), 2 * 4)]
    got = step_fn(ema, 0, images, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def _golden_run(tmp_path, steps, **kw):
    cfg = Config(dataset="synthetic", image_size=8, channels=3, h_size=8,
                 depth=1, learning_rate=0.005, batch_size=8,
                 total_steps=steps, ckpt_every=100000, log_every=100000,
                 seed=7, compute_dtype="float32", logdir=str(tmp_path), **kw)
    ds = synthetic_dataset(8, 3, n_train=64, n_test=32, seed=0)

    def fixed_batch():
        while True:
            yield ds.train_x[:cfg.batch_size]

    state = train_lib.train(cfg, max_steps=steps, data_iter=fixed_batch(),
                            device="cpu")
    with torch.no_grad():
        out = cvae.apply_fn(cfg, state.params, 99,
                            ds.train_x[:cfg.batch_size], mode="eval")
    return float(out.loss), float(out.bits_per_dim)


C1 = dict(z_size=2, num_blocks=2, depth_ar=0, flow="diag", kl_min=0.0)
C2 = dict(z_size=2, num_blocks=1, depth_ar=1, ar_hidden_size=8, kl_min=0.25)


@pytest.mark.parametrize("name,kw,steps,loss,bpd,rel", [
    ("c1", C1, 30, 1316.12, 9.8894, 0.03),
    ("c2", C2, 30, 1314.75, 9.8791, 0.03),
    ("c2_long", C2, 300, 1062.5403, 7.98154, 0.01)])
def test_goldens_under_the_ports_rng(tmp_path, name, kw, steps, loss, bpd,
                                     rel):
    """The JAX package's frozen goldens (``tests/test_golden.py``), here
    with the port's own init and noise streams, which differ from
    threefry's: the same tolerances hold."""
    got_loss, got_bpd = _golden_run(tmp_path, steps, **kw)
    assert np.isfinite(got_loss)
    assert abs(got_loss - loss) / loss < rel, (name, got_loss)
    assert abs(got_bpd - bpd) / bpd < rel, (name, got_bpd)


def test_cli_trains_on_cpu_and_jax_loads_the_checkpoint(tmp_path, capsys):
    from iaf_torch import cli
    hp = TINY + ",total_steps=3,ckpt_every=3,log_every=1"
    cli.main(["--logdir", str(tmp_path), "--hpconfig", hp, "--mode", "train",
              "--device", "cpu"])
    assert "step 3 loss" in capsys.readouterr().out
    path = ckpt.latest_checkpoint(str(tmp_path))
    assert path.endswith("ckpt-000000003.npz")
    step, jstate, _ = jtl.tree_to_state(jckpt.restore(path))
    assert step == 3 and int(jstate.opt.step) == 3
    saved = Config().parse(hp)
    assert (tmp_path / "hps.json").is_file()
    from iaf_torch.core.config import load_hparams
    assert load_hparams(str(tmp_path)).h_size == saved.h_size


def test_grad_accum_step_matches_jax():
    """grad_accum=2: the exact mean over two equal micro-batches, micro
    batch a drawing from fold_in(key, a), against JAX's scan."""
    hp = TINY + ",grad_accum=2"
    jcfg, tcfg = JConfig().parse(hp), Config().parse(hp)
    ds = synthetic_dataset(8, 3, n_train=16, n_test=4, seed=2)
    batch = ds.train_x[:tcfg.batch_size]
    key = jax.random.PRNGKey(3)
    mesh = make_mesh(jcfg, jax.devices()[:1])
    jstate = jts.init_train_state(jcfg, key, batch)
    model = cvae.CVAE(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                       jstate.params)))
    tstate = ts.TrainState(model, optim.init_state(
        dict(model.named_parameters())))
    jstate, jm = jts.make_train_step(jcfg, mesh)(
        jts.place_state(jstate, mesh, jcfg), key, jnp.asarray(batch))
    micro = tcfg.batch_size // 2
    noise = [_jax_noise(tcfg, jax.random.fold_in(key, a), micro)
             for a in range(2)]
    tstate, tm = ts.train_step(tcfg, tstate, 0, batch, noise=noise)
    for k in ("loss", "kl_cost", "log_pxz", "bits_per_dim"):
        _close(tm[k].numpy(), np.asarray(jm[k]), 1e-5, k)
    _close_trees(to_jax_params(tstate.params.state_dict()), jstate.params,
                 1e-4)
    _close_trees(to_jax_params(tstate.opt.m), jstate.opt.m, 1e-4)
