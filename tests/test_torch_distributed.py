"""The port's data parallelism on the CPU: two real processes form a gloo
group with torchrun's environment and run ``tests/torch_dist_worker.py``
(no JAX there); the JAX side runs here on a 2-device mesh while they
work. Held, all in f32:
- a 3-step trajectory of the port's graphed-step body over 2 ranks with
  JAX's global draws injected, against JAX's ``make_train_step`` on a
  2-device mesh, every leaf within 1e-4 of its max, free bits
  (``kl_min=0.25``) clamping some channels and not others, both ranks'
  parameters bitwise equal, and the eager step's bitwise the graphed
  body's; the same at grad_accum=2 against JAX's step at grad_accum=2
  (each micro-batch's global draw injected), with a guard that free bits
  clamps other channels under JAX's micro-batch grouping than under
  each rank splitting its own rows;
- ``train`` over 2 ranks (no injected noise: each rank its rows of the
  global draws) against one process on the whole batch: the checkpoint
  of step 1 within 1e-5 and of step 3 within 1e-4 of each leaf's max,
  in both model families, at grad_accum 1 and 2;
- the k-sharded IW eval (k = 8) and the batch-sharded k = 1 ELBO against
  JAX's ``make_eval_step`` and ``make_batch_sharded_elbo`` (rtol 1e-5,
  atol 1e-4 nats);
- train, resume and evaluate as ``tests/distributed_worker.py`` does: a
  killed and resumed eval equal to a straight one, both ranks' bits/dim
  equal, rank 0 alone writing checkpoints, metrics, progress files and
  samples; ``sample`` bitwise the one-process draw of the padded batch,
  sliced; the heartbeat's k rounded up to the world size; and what must
  raise."""

import os
import pickle
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.core.config import Config as JConfig
from iaf_tpu.core.rng import fold_name
from iaf_tpu.parallel import eval_step as jev
from iaf_tpu.parallel import train_step as jts
from iaf_tpu.parallel.mesh import make_mesh
from iaf_torch import train_lib
from iaf_torch.bridge import from_jax_params, to_jax_params
from iaf_torch.core import checkpoint as ckpt
from iaf_torch.core.config import Config
from iaf_torch.data import feed
from iaf_torch.data.datasets import load_dataset
from iaf_torch.models import cvae
from iaf_torch.parallel import mesh

WORLD = 2
ACCUM = 2            # grad_accum of the accumulation cases
TINY = ("dataset=synthetic,image_size=4,z_size=4,h_size=8,depth=1,"
        "num_blocks=2,depth_ar=2,kl_min=0.25,batch_size=4,seed=5,"
        "compute_dtype=float32")
INV = {"cifar": TINY + ",total_steps=3,ckpt_every=1,log_every=1",
       "mnist": ("dataset=synthetic,likelihood=bernoulli,binarize=false,"
                 "ar_kind=dense,image_size=8,channels=1,z_size=4,h_size=8,"
                 "ar_hidden_size=16,depth_ar=1,flow_depth=2,kl_min=0.25,"
                 "batch_size=4,seed=5,compute_dtype=float32,total_steps=3,"
                 "ckpt_every=1,log_every=1")}
# grad_accum=2 over 2 ranks: two rows a rank a micro-batch. PyTorch's
# CPU convs at batch 1 round otherwise than at batch 2: one process's
# gradient of a 2-row batch taken as two 1-row backward passes differs
# from the 2-row one by ~5e-5 of a leaf's max, above step 1's 1e-5
INV.update({f"{fam}_a2": hp + f",grad_accum={ACCUM},batch_size=8"
            for fam, hp in list(INV.items())})
RUN = ("dataset=synthetic,image_size=8,z_size=2,h_size=8,depth=1,"
       "num_blocks=1,depth_ar=1,ar_hidden_size=8,kl_min=0.0,batch_size=8,"
       "total_steps=6,ckpt_every=3,log_every=3,eval_every=3,"
       "eval_batch_size=4,eval_k=3,eval_k_chunk=4,steps_per_dispatch=2,"
       "compute_dtype=float32")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_noise(cfg, key, rows):
    hw = cfg.image_size // 2
    return {f"{n}/z_post": np.array(jax.random.normal(
        fold_name(fold_name(key, n), "z_post"), (rows, hw, hw, cfg.z_size)))
        for n in cvae.layer_names(cfg)}


def _global_batches(cfg, steps):
    """The global batch of each step: the ranks' rows, in rank order."""
    ds, _ = load_dataset(cfg.dataset, cfg.data_dir, cfg.image_size,
                         cfg.channels)
    its = [feed.batch_iterator(ds.train_x, cfg.batch_size, cfg.seed, r,
                               WORLD) for r in range(WORLD)]
    return [np.concatenate([next(it) for it in its]) for _ in range(steps)]


def _close(got, want, rel, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: max err {err} > {rel} x {scale}"


def _close_flat(got: dict, want: dict, rel: float):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], rel, k)


def _ckpt_flat(logdir, step, part):
    with np.load(os.path.join(logdir, f"ckpt-{step:09d}.npz")) as f:
        return {k: f[k] for k in f.files if k.startswith(part)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_dist"))
    jcfg, tcfg = JConfig().parse(TINY), Config().parse(TINY)
    batches = _global_batches(tcfg, 3)
    base_key = jax.random.PRNGKey(tcfg.seed)
    jstate = jts.init_train_state(jcfg, jax.random.fold_in(base_key, 1),
                                  batches[0])
    jhost = jax.tree.map(np.array, jstate)   # the first step donates it
    params0 = jhost.params
    sd0 = {k: v.numpy() for k, v in from_jax_params(params0).items()}
    keys = [jax.random.fold_in(base_key, i) for i in range(3)]
    # grad_accum=2: each micro-batch's global draw, fold_in(key, a)
    micro = tcfg.batch_size // ACCUM
    noise_a = [[_jax_noise(tcfg, jax.random.fold_in(k, a), micro)
                for a in range(ACCUM)] for k in keys]
    eval_x = batches[0][:2]
    eval_key = jax.random.PRNGKey(11)
    inputs = {
        "hp": TINY, "params0": sd0, "batches": batches,
        "noise": [_jax_noise(tcfg, k, tcfg.batch_size) for k in keys],
        "noise_accum": noise_a,
        "eval_x": eval_x,
        "eval_noise": [[_jax_noise(tcfg, jax.random.fold_in(
            jax.random.fold_in(eval_key, r), i), 2 * 2) for i in range(2)]
            for r in range(WORLD)],
        "k1_noise": _jax_noise(tcfg, eval_key, 2),
        **{f"inv_hp_{fam}": hp for fam, hp in INV.items()},
        "run_hp": RUN}
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)

    worker = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
    port = _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, worker, d], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(worker))))
    try:
        # the JAX side and the one-process references while they run
        mesh2 = make_mesh(jcfg, jax.devices()[:WORLD])
        step_fn = jts.make_train_step(jcfg, mesh2)
        js = jts.place_state(jstate, mesh2, jcfg)
        jlosses = []
        for k, b in zip(keys, batches):
            js, jm = step_fn(js, k, jnp.asarray(b))
            jlosses.append(float(jm["loss"]))
        acfg = jcfg.replace(grad_accum=ACCUM)
        step_a = jts.make_train_step(acfg, make_mesh(acfg,
                                                     jax.devices()[:WORLD]))
        ja = jts.place_state(jhost, mesh2, acfg)
        jlosses_a = []
        for k, b in zip(keys, batches):
            ja, jm = step_a(ja, k, jnp.asarray(b))
            jlosses_a.append(float(jm["loss"]))
        ecfg = jcfg.replace(eval_k_chunk=2)
        want_k8 = np.asarray(jev.make_eval_step(ecfg, mesh2, k=8)(
            params0, eval_key, jnp.asarray(eval_x)))
        want_k1 = np.asarray(jev.make_batch_sharded_elbo(ecfg, mesh2, k=1)(
            params0, eval_key, jnp.asarray(eval_x)))
        kl_aves = _kl_means(tcfg, sd0, batches[0], inputs["noise"][0])
        kl_groups = {g: [_kl_means(tcfg, sd0, batches[0][rows],
                                   noise_a[0][a])
                         for a, rows in enumerate(_micro_rows(tcfg, g))]
                     for g in ("jax", "rank_local")}
        for fam, hp in INV.items():
            cfg = Config().parse(hp).replace(logdir=os.path.join(d,
                                                                 f"ref_{fam}"))
            train_lib.train(cfg, device="cpu",
                            data_iter=iter(_global_batches(cfg, 3)))
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"TORCH_DIST_OK rank={r}" in o, \
            o[-4000:]
    res = []
    for r in range(WORLD):
        with open(os.path.join(d, f"out_{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return dict(d=d, res=res, outs=outs, jstate=js, jlosses=jlosses,
                jstate_a=ja, jlosses_a=jlosses_a, want_k8=want_k8,
                want_k1=want_k1, kl_aves=kl_aves, kl_groups=kl_groups)


def _micro_rows(cfg, grouping):
    """The global batch's rows in each of ``ACCUM`` micro-batches: JAX's
    (micro-batch a is rows [a·m, (a+1)·m), resharded over the ranks), or
    the grouping of ranks that each split their own rows (micro-batch a
    is every rank's local rows [a·m/D, (a+1)·m/D))."""
    B = cfg.batch_size
    m, per = B // ACCUM, B // WORLD
    if grouping == "jax":
        return [np.arange(a * m, (a + 1) * m) for a in range(ACCUM)]
    return [np.concatenate([np.arange(r * per + a * (m // WORLD),
                                      r * per + (a + 1) * (m // WORLD))
                            for r in range(WORLD)]) for a in range(ACCUM)]


def _kl_means(tcfg, sd, batch, noise):
    """Every layer's per-channel KL means on the global batch, as free
    bits clamps them (one process, JAX's draws injected)."""
    model = cvae.CVAE(tcfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    seen = []
    real = cvae.free_bits

    def spy(cfg, kl_aves, batch_, global_batch):
        seen.extend(a.detach().numpy().ravel() for a in kl_aves)
        return real(cfg, kl_aves, batch_, global_batch)
    cvae.free_bits = spy
    try:
        with torch.no_grad():
            cvae.apply_fn(tcfg, model, 0, batch, mode="train",
                          noise={k: torch.from_numpy(v)
                                 for k, v in noise.items()})
    finally:
        cvae.free_bits = real
    return np.concatenate(seen)


def test_two_ranks_match_jax_two_device_trajectory(run):
    """3 steps over 2 gloo ranks against JAX's step on a 2-device mesh,
    with free bits clamping some channels of the global batch's KL means
    and not others; both ranks bitwise equal."""
    kl = run["kl_aves"]
    assert (kl < 0.25).any() and (kl > 0.25).any(), kl
    a, b = (r["traj"] for r in run["res"])
    for part in ("params", "ema"):
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=k)
            # the eager step over the ranks computes the same
            for r in run["res"]:
                np.testing.assert_array_equal(r["traj_eager"][part][k],
                                              a[part][k], err_msg=k)
    for got, want in zip(run["res"][0]["traj_losses"], run["jlosses"]):
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    js = run["jstate"]
    for part, jtree in (("params", js.params), ("ema", js.opt.ema)):
        got = to_jax_params({k: torch.from_numpy(v)
                             for k, v in a[part].items()})
        want = dict(jax.tree_util.tree_leaves_with_path(jtree))
        for path, leaf in jax.tree_util.tree_leaves_with_path(got):
            _close(leaf, want[path], 1e-4, jax.tree_util.keystr(path))


def test_grad_accum_over_ranks_matches_jax_two_device_trajectory(run):
    """grad_accum=2 over 2 gloo ranks, 3 steps of the graphed-step body
    with JAX's per-micro-batch global draws injected, against JAX's
    ``make_train_step`` at grad_accum=2 on a 2-device mesh (micro-batch
    a: global rows [a·B/2, (a+1)·B/2), resharded); both ranks bitwise,
    the eager step bitwise the graphed body."""
    a, b = (r["traj_accum"] for r in run["res"])
    for part in ("params", "ema"):
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=k)
            for r in run["res"]:
                np.testing.assert_array_equal(r["traj_accum_eager"][part][k],
                                              a[part][k], err_msg=k)
    for got, want in zip(run["res"][0]["traj_accum_losses"],
                         run["jlosses_a"]):
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    js = run["jstate_a"]
    for part, jtree in (("params", js.params), ("ema", js.opt.ema)):
        got = to_jax_params({k: torch.from_numpy(v)
                             for k, v in a[part].items()})
        want = dict(jax.tree_util.tree_leaves_with_path(jtree))
        for path, leaf in jax.tree_util.tree_leaves_with_path(got):
            _close(leaf, want[path], 1e-4, jax.tree_util.keystr(path))


def test_grad_accum_grouping_shows_in_free_bits(run):
    """The guard of the test above: on its data, free bits clamps other
    channels under JAX's micro-batch grouping than under the grouping of
    ranks that each split their own rows, so a port that skipped the
    row exchange would fail it."""
    jax_g, local = (run["kl_groups"][g] for g in ("jax", "rank_local"))
    clamps = [[kl < 0.25 for kl in grouping] for grouping in (jax_g, local)]
    assert any(c.any() and (~c).any() for c in clamps[0]), jax_g
    assert any((x != y).any() for x, y in zip(*clamps)), (jax_g, local)


@pytest.mark.parametrize("fam", ["cifar", "mnist", "cifar_a2", "mnist_a2"])
def test_world_size_does_not_change_the_step(run, fam):
    """``train`` over 2 ranks equals one process on the whole batch (also
    at grad_accum=2, ``_a2``): step 1 within 1e-5, step 3 within 1e-4 of
    each leaf's max (params, m, u, EMA); both ranks' final states bitwise
    equal."""
    d = run["d"]
    for step, rel in ((1, 1e-5), (3, 1e-4)):
        for part in ("params", "opt"):
            _close_flat(_ckpt_flat(os.path.join(d, f"inv_{fam}"), step, part),
                        _ckpt_flat(os.path.join(d, f"ref_{fam}"), step, part),
                        rel)
    a, b = (r[f"inv_{fam}"] for r in run["res"])
    for part in ("params", "ema"):
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=k)


@pytest.mark.parametrize("key", ["eval_k8", "eval_k1"])
def test_sharded_eval_matches_jax(run, key):
    """The k-sharded IW eval (k = 8, 2 chunks of 2 a rank) and the
    batch-sharded k = 1 ELBO: every rank returns JAX's bound."""
    want = run["want_k8" if key == "eval_k8" else "want_k1"]
    for r in run["res"]:
        np.testing.assert_allclose(r[key], want, rtol=1e-5, atol=1e-4)


def test_resumed_eval_and_ranks_agree(run):
    a, b = run["res"]
    assert a["resumed"] == a["full"] and b["resumed"] == b["full"]
    for key in ("bpd", "full", "bpd_k1"):
        assert a[key] == b[key] and np.isfinite(a[key]), key
    printed = [re.search(r"bits_per_dim=(\S+)", o).group(1)
               for o in run["outs"]]
    assert printed[0] == printed[1]


def test_rank_zero_alone_writes(run):
    a, b = run["res"]
    assert b["writes"] == [], b["writes"]
    names = {os.path.basename(p) for p in a["writes"]}
    assert {"hps.json", "ckpt-000000003.npz", "ckpt-000000006.npz",
            "ckpt-000000008.npz", "eval_prog_test.json",
            "samples.npy"} <= names, names
    assert any(n.startswith("samples_") for n in names)   # image summaries
    run_dir = os.path.join(run["d"], "run")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [line for line in f if '"loss"' in line]
    steps = [int(re.search(r'"step": (\d+)', r).group(1)) for r in rows]
    assert steps == list(range(1, 9)), steps      # one row a step, once
    with open(os.path.join(run_dir, "eval_test_metrics.jsonl")) as f:
        assert len(f.readlines()) == 1


def test_sample_equals_one_process_padded_draw(run):
    """``sample(num=5)`` over 2 ranks (3 rows each of the padded draw of
    6) equals one process's ``sample(num=6)[:5]``, bitwise."""
    cfg = Config().parse(RUN).replace(logdir=os.path.join(run["d"], "run"))
    sd = ckpt.restore(ckpt.latest_checkpoint(cfg.logdir))["opt"]["ema"]
    model = cvae.CVAE(cfg, device="cpu")
    model.load_state_dict(from_jax_params(sd))
    with torch.inference_mode():
        want = cvae.cvae_sample(cfg, model, cfg.seed + 4242, 6, 0.7)
    want = want.numpy().astype(np.uint8)[:5]
    for r in run["res"]:
        assert r["samples"].shape == (5, 8, 8, 3)
        np.testing.assert_array_equal(r["samples"], want)


def test_heartbeat_k_rounds_up_to_the_world_size(run):
    cfg = Config().parse(RUN)
    assert [r["heartbeat_k"] for r in run["res"]] == [4, 4]
    assert train_lib.heartbeat_k(cfg) == 3             # one process
    assert train_lib.heartbeat_k(cfg.replace(eval_k=4096)) == 64


def test_what_must_raise(run):
    for r in run["res"]:
        assert r["raised"] == {"mesh_model": "NotImplementedError",
                               "mesh_data": "ValueError",
                               "grad_accum": "ValueError"}
        # a global batch of 6 splits into grad_accum=2 but not into 2 x 2
        assert "batch 6" in r["accum_error"], r["accum_error"]
        assert "grad_accum=2 x 2 rank" in r["accum_error"], r["accum_error"]
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 4"):
        mesh.check_config(Config(mesh_model=2))
    mesh.check_config(Config(mesh_data=1))             # one process


def test_no_group_without_world_size(monkeypatch):
    """No ``WORLD_SIZE``: no group forms and nothing is collective."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh.init_distributed(torch.device("cpu"))
    assert not mesh.active() and mesh.rank() == 0 and mesh.world() == 1
    t = torch.arange(3.0)
    assert mesh.all_gather(t) is t and mesh.all_reduce_(t) is t
