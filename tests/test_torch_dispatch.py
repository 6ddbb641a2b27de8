"""``steps_per_dispatch`` and the prefetch thread in the port, on the CPU:
the chunked loop against the unchunked one (bitwise), one metrics row per
trained step, ``ChunkPrefetcher``'s contract, the port's chunk against
JAX's ``make_train_chunk`` with JAX's draws injected (1e-4 of each leaf's
max, as the 10-step trajectory), the static-buffer step against the eager
``train_step`` (bitwise), noise drawn into a buffer, the optimizer's step
count advanced in place, a crash inside a chunk then a resume, and the
launch counts a captured graph's replays add. They mirror
``tests/test_train_lib.py`` and ``tests/test_feed_resume.py``; the graph
itself runs only on the card (``chip_smoke.py``, phase 15)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.core.config import Config as JConfig
from iaf_tpu.parallel import train_step as jts
from iaf_tpu.parallel.mesh import make_mesh
from iaf_torch import ops, optim, train_lib
from iaf_torch.bridge import from_jax_params, to_jax_params
from iaf_torch.core import checkpoint as ckpt
from iaf_torch.core.config import Config
from iaf_torch.core.rng import fold, fold_name, normal_into, site_normal
from iaf_torch.data import feed
from iaf_torch.data.datasets import synthetic_dataset
from iaf_torch.models import cvae
from iaf_torch.parallel import train_step as ts
from test_torch_kernels import cuda  # noqa: F401  (the card fixture)
from test_torch_train import TINY, _close, _close_trees, _jax_noise


def _train(tmp_path, name, steps, **kw):
    cfg = Config().parse(TINY + ",log_every=100,ckpt_every=100")
    cfg = cfg.replace(logdir=str(tmp_path / name), **kw)
    return train_lib.train(cfg, max_steps=steps, device="cpu")


def _assert_same_state(a, b):
    for (k, x), y in zip(a.params.state_dict().items(),
                         b.params.state_dict().values()):
        assert torch.equal(x, y), k
    for part in ("m", "u", "ema"):
        for k, x in getattr(a.opt, part).items():
            assert torch.equal(x, getattr(b.opt, part)[k]), (part, k)
    assert int(a.opt.step) == int(b.opt.step)


def test_chunked_train_equals_unchunked(tmp_path):
    """S = 3 over 7 steps (3 + 3 + a tail of 1) gives the S = 1 run's
    final params, m, u, EMA and step, bit for bit (each step keyed
    fold(base, step), as ``tests/test_train_lib.py:196`` asks of JAX)."""
    one = _train(tmp_path, "one", 7)
    three = _train(tmp_path, "three", 7, steps_per_dispatch=3)
    assert int(three.opt.step) == 7
    _assert_same_state(one, three)


def test_chunked_dispatch_logs_every_step(tmp_path):
    """At S > 1 the log flush writes one model-metrics row per trained
    step, and the throughput rows still land at the log cadence."""
    cfg = Config().parse(TINY + ",log_every=4,ckpt_every=100,"
                         "steps_per_dispatch=3")
    cfg = cfg.replace(logdir=str(tmp_path))
    train_lib.train(cfg, max_steps=10, device="cpu")
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "loss" in r] == list(range(1, 11))
    assert [r["step"] for r in rows if "steps_per_sec" in r] == [6, 9, 10]
    assert all(len(r["kl_per_layer"]) == 2 for r in rows if "loss" in r)


def _images(n=64, hw=4):
    return np.arange(n * hw * hw, dtype=np.uint8).reshape(n, hw, hw, 1)


def test_chunk_prefetcher_matches_sync_assembly():
    imgs = _images()
    it = feed.batch_iterator(imgs, 8, seed=1)
    first = next(it)
    got = list(feed.ChunkPrefetcher(it, 3, 7, first_local=first))
    assert [n for n, _ in got] == [3, 3, 1]
    ref_it = feed.batch_iterator(imgs, 8, seed=1)
    ref = np.stack([next(ref_it) for _ in range(7)])
    np.testing.assert_array_equal(np.concatenate([c for _, c in got]), ref)
    resumed = list(feed.ChunkPrefetcher(
        feed.batch_iterator(imgs, 8, seed=1, start_step=4), 3, 7,
        start_step=4))
    assert [c.shape[0] for _, c in resumed] == [3]
    np.testing.assert_array_equal(resumed[0][1], ref[4:])


def test_chunk_prefetcher_propagates_errors():
    def boom():
        yield _images(8)
        raise RuntimeError("data source died")

    pre = feed.ChunkPrefetcher(boom(), 1, 5)
    n, chunk = next(pre)
    assert n == 1 and chunk.shape == (1, 8, 4, 4, 1)
    with pytest.raises(RuntimeError, match="data source died"):
        next(pre)
    with pytest.raises(StopIteration):
        next(pre)


def test_chunk_prefetcher_close_releases_an_aborting_consumer():
    """A consumer that stops after one chunk (a crash in the train loop)
    closes the prefetcher: the worker, blocked on the full queue of an
    endless iterator, ends, and the prefetcher stays finished."""
    imgs = _images()
    pre = feed.ChunkPrefetcher(feed.batch_iterator(imgs, 8, seed=2), 2,
                               10**9, depth=1)
    next(pre)
    pre.close()
    assert not pre._t.is_alive()
    with pytest.raises(StopIteration):
        next(pre)
    pre.close()


def test_chunk_matches_jax_make_train_chunk():
    """Two chunks of S = 3 steps: the port's chunk with JAX's draws for
    fold_in(base, start + i) injected, against JAX's
    ``make_train_chunk(cfg, mesh, 3)`` from the same bridged state, on the
    same batches: each step's loss and the final params and EMA within
    1e-4 of each leaf's max, m too."""
    jcfg, tcfg = JConfig().parse(TINY), Config().parse(TINY)
    ds = synthetic_dataset(8, 3, n_train=64, n_test=8, seed=1)
    it = feed.batch_iterator(ds.train_x, tcfg.batch_size, tcfg.seed)
    batches = np.stack([next(it) for _ in range(6)])
    base_key = jax.random.PRNGKey(tcfg.seed)
    mesh = make_mesh(jcfg, jax.devices()[:1])
    jstate = jts.init_train_state(jcfg, jax.random.fold_in(base_key, 1),
                                  batches[0])
    model = cvae.CVAE(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                       jstate.params)))
    tstate = ts.TrainState(model, optim.init_state(
        dict(model.named_parameters())))
    jchunk = jts.make_train_chunk(jcfg, mesh, 3)
    jstate = jts.place_state(jstate, mesh, jcfg)
    tchunk = ts.make_train_chunk(tcfg, tstate)
    for start in (0, 3):
        jstate, jm = jchunk(jstate, base_key, np.int32(start),
                            jnp.asarray(batches[start:start + 3]))
        noise = [_jax_noise(tcfg, jax.random.fold_in(base_key, start + i),
                            tcfg.batch_size) for i in range(3)]
        tstate, tm = tchunk(tstate, tcfg.seed, start,
                            batches[start:start + 3], noise=noise)
        assert tm["loss"].shape == (3,)
        for k in ("loss", "kl_cost", "log_pxz", "bits_per_dim",
                  "kl_per_layer"):
            _close(tm[k].numpy(), np.asarray(jm[k]), 1e-4, k)
    tchunk.close()
    assert int(tstate.opt.step) == int(jstate.opt.step) == 6
    _close_trees(to_jax_params(tstate.params.state_dict()), jstate.params,
                 1e-4)
    _close_trees(to_jax_params(tstate.opt.ema), jstate.opt.ema, 1e-4)
    _close_trees(to_jax_params(tstate.opt.m), jstate.opt.m, 1e-4)


@pytest.mark.parametrize("extra", ["", ",grad_accum=2",
                                   ",bias_correction=True,grad_clip=1.0",
                                   ",scan_blocks=true,remat=true"])
def test_static_step_equals_eager_train_step(extra):
    """``make_train_step``'s body (static batch and noise buffers, flat
    gradients zeroed in place) against the eager ``train_step`` on a copy
    of the same state, three steps on the same batches and keys: every
    metric, gradient, param, m, u and EMA leaf and the step, bitwise."""
    cfg = Config().parse(TINY + extra)
    x = synthetic_dataset(8, 3, n_train=16, n_test=2, seed=3).train_x
    a = ts.init_train_state(cfg, 11, x[:4], "cpu")
    b = ts.init_train_state(cfg, 11, x[:4], "cpu")
    step = ts.make_train_step(cfg, b)
    for i in range(3):
        batch = x[4 * i:4 * i + 4]
        a, ma = ts.train_step(cfg, a, fold(7, i), batch)
        b, mb = step(b, fold(7, i), batch)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), (i, k)
        for (k, pa), pb in zip(a.params.named_parameters(),
                               b.params.parameters()):
            ga = torch.zeros_like(pa) if pa.grad is None else pa.grad
            assert torch.equal(ga, pb.grad), (i, k)
    step.close()
    _assert_same_state(a, b)
    assert int(b.opt.step) == 3


def test_noise_drawn_into_a_buffer_has_site_normals_bits():
    key = fold_name(fold_name(fold(5, 3), "block_0/layer_1"), "z_post")
    want = site_normal(key, "block_0/layer_1/z_post", (4, 2, 2, 3), "cpu")
    buf = torch.full((4, 2, 2, 3), float("nan"))
    assert normal_into(key, buf) is buf
    assert torch.equal(buf, want)
    cfg = Config().parse(TINY)
    out = {f"{n}/z_post": torch.empty(4, 4, 4, cfg.z_size)
           for n in cvae.layer_names(cfg)}
    cvae.draw_noise(cfg, 9, out)
    for i, n in enumerate(cvae.layer_names(cfg)):
        assert torch.equal(out[f"{n}/z_post"],
                           cvae._eps(cfg, 9, i, (4, 4, 4, cfg.z_size),
                                     "cpu", None)), n


def test_apply_updates_advances_the_step_in_place():
    params = {"w": torch.ones(3)}
    state = optim.init_state(params)
    counter = state.step
    for want in (1, 2, 3):
        _, state = optim.apply_updates(params, {"w": torch.ones(3)}, state,
                                       lr=0.01)
        assert state.step is counter and int(counter) == want


def test_crash_inside_a_chunk_then_resume_is_exact(tmp_path, capsys):
    """S = 3, a checkpoint every 2 steps, a crash after step 4: it fires
    at the end of the chunk that crosses it (step 6), before that chunk's
    checkpoint, so the run resumes from step 3 and ends where an
    uninterrupted run does."""
    whole = _train(tmp_path, "whole", 8, steps_per_dispatch=3)
    crash = dict(steps_per_dispatch=3, ckpt_every=2)
    with pytest.raises(RuntimeError, match="crash at step 6"):
        _train(tmp_path, "b", 8, fail_after_step=4, **crash)
    assert ckpt.latest_checkpoint(str(tmp_path / "b")).endswith(
        "ckpt-000000003.npz")
    resumed = _train(tmp_path, "b", 8, **crash)
    assert "at step 3" in capsys.readouterr().out
    _assert_same_state(whole, resumed)


def test_replays_add_the_captured_launch_counts():
    """What a capture launches is kept out of the counters and handed
    back; ``add_launch_counts`` adds it once per replay."""
    ops.reset_launch_counts()
    ops.add_launch_counts({"iaf_update": 2})
    with ops.launches_apart() as seen:
        ops.add_launch_counts({"iaf_update": 20, "adamax_polyak": 1})
        assert ops.launch_counts()["iaf_update"] == 22
    assert seen == {"iaf_update": 20, "adamax_polyak": 1}
    for _ in range(3):
        ops.add_launch_counts(seen)
    counts = ops.launch_counts()
    assert counts["iaf_update"] == 62 and counts["adamax_polyak"] == 3
    assert sum(counts.values()) == 65
    ops.reset_launch_counts()



@pytest.mark.cuda
@pytest.mark.parametrize("extra", ["", ",kernel_size=5", ",grad_accum=2"])
def test_graphed_step_equals_eager_step_on_card(cuda, extra):
    """On the card: ``make_train_step`` (an eager warm-up, the capture,
    then replays) against the eager ``train_step`` on a copy of the same
    state, bf16 at batch 32 and a 16x16 latent: three steps' metrics,
    gradients, params, m, u, EMA and step bitwise, and each replay adding
    the capture's launches to the counters."""
    hp = ("dataset=synthetic,z_size=32,h_size=32,depth=1,num_blocks=2,"
          "kl_min=0.25,batch_size=32" + extra)
    cfg = Config().parse(hp)
    x = synthetic_dataset(32, 3, n_train=96, n_test=2, seed=3).train_x
    a = ts.init_train_state(cfg, 11, x[:32], cuda)
    b = ts.TrainState(cvae.CVAE(cfg, device=cuda), optim.AdamaxState(
        a.opt.step.clone(), *({k: v.clone() for k, v in part.items()}
                              for part in (a.opt.m, a.opt.u, a.opt.ema))))
    b.params.load_state_dict(a.params.state_dict())
    step = ts.make_train_step(cfg, b)
    for i in range(3):
        batch = x[32 * i:32 * i + 32]
        a, ma = ts.train_step(cfg, a, fold(7, i), batch)
        ops.reset_launch_counts()
        b, mb = step(b, fold(7, i), batch)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if i == 0:
            per_step = counts
        assert counts == per_step and counts["adamax_polyak"] == 1, counts
        for k in ma:
            assert torch.equal(ma[k], mb[k]), (i, k)
        for (k, pa), pb in zip(a.params.named_parameters(),
                               b.params.parameters()):
            ga = torch.zeros_like(pa) if pa.grad is None else pa.grad
            assert torch.equal(ga, pb.grad), (i, k)
    step.close()
    _assert_same_state(a, b)


def test_step_buffers_refuse_another_batch_shape():
    cfg = Config().parse(TINY)
    x = synthetic_dataset(8, 3, n_train=8, n_test=2, seed=3).train_x
    state = ts.init_train_state(cfg, 11, x[:4], "cpu")
    step = ts.make_train_step(cfg, state)
    step(state, 1, x[:4])
    with pytest.raises(ValueError, match="buffers hold"):
        step(state, 2, x[:3])
