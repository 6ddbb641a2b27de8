"""The port's serving modes on the CPU: ``cvae_sample`` against
``iaf_tpu``'s with JAX's prior draws injected; ``evaluate``'s progress
file (the cases of tests/test_train_lib.py:82-126, and the JAX package's
file seen as stale both ways); ``eval_loop``; ``sample``,
``reconstruct`` and ``invert_check`` on a logdir the port trained and on
one whose checkpoint the JAX package wrote; the train loop's image
summaries; the image tiles of ``utils/metrics``."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from iaf_tpu import train_lib as jtl
from iaf_tpu.core import checkpoint as jckpt
from iaf_tpu.core.config import Config as JConfig
from iaf_tpu.core.rng import fold_name
from iaf_tpu.models import cvae as jcvae
from iaf_tpu.parallel.mesh import make_mesh
from iaf_tpu.utils import metrics as jmetrics
from iaf_torch import train_lib
from iaf_torch.bridge import from_jax_params, to_jax_params
from iaf_torch.core import checkpoint as ckpt
from iaf_torch.core.config import Config
from iaf_torch.core.rng import fold
from iaf_torch.models import cvae
from iaf_torch.utils import metrics

TINY = ("image_size=8,z_size=4,h_size=8,depth=1,num_blocks=2,depth_ar=2,"
        "compute_dtype=float32")
PAPER_WIDTH = ("image_size=32,z_size=32,h_size=160,depth=1,num_blocks=2,"
               "depth_ar=2,compute_dtype=float32")
# a logdir: 3 steps, one checkpoint; eval batches of 4 at k=8
RUN = ("dataset=synthetic,image_size=8,z_size=4,h_size=8,depth=1,"
       "num_blocks=2,depth_ar=2,batch_size=4,total_steps=3,ckpt_every=3,"
       "log_every=3,eval_batch_size=4,eval_k=8,eval_k_chunk=4,"
       "compute_dtype=float32")


def _model_and_params(hp, seed=0):
    """The port's init (held to JAX's in test_torch_cvae) and its JAX
    tree."""
    cfg = Config().parse(hp)
    x = np.random.RandomState(seed).randint(
        0, 256, (2, cfg.image_size, cfg.image_size, 3)).astype(np.uint8)
    model = cvae.init_params(cfg, x, rng=seed, device="cpu")
    return cfg, model, to_jax_params(model.state_dict())


@pytest.mark.parametrize("hp", [TINY, TINY.replace("float32", "bfloat16"),
                                PAPER_WIDTH])
def test_cvae_sample_matches_jax(hp):
    """Both temperatures on one base key, JAX's ``z_prior`` draws
    injected: the images within 2e-3 on the [0, 256) scale. Sampling is
    f32 whatever compute_dtype says, as in JAX."""
    cfg, model, params = _model_and_params(hp)
    jcfg, num = JConfig().parse(hp), 3
    key = jax.random.PRNGKey(4242)
    hw = cfg.image_size // 2
    noise = {f"{n}/z_prior": torch.from_numpy(np.array(jax.random.normal(
        fold_name(fold_name(key, n), "z_prior"), (num, hw, hw, cfg.z_size))))
        for n in cvae.layer_names(cfg)}
    for t in (1.0, 0.5):
        want = np.asarray(jcvae.cvae_sample(jcfg, params, key, num, t))
        with torch.inference_mode():
            got = cvae.cvae_sample(cfg, model, 0, num, t, noise=noise)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    with torch.inference_mode():   # the port's own draws: one base noise
        a = cvae.cvae_sample(cfg, model, 9, num, 0.0)
        b = cvae.cvae_sample(cfg, model, 10, num, 0.0)
        c = cvae.cvae_sample(cfg, model, 9, num, 1.0)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture(scope="module")
def logdir(tmp_path_factory):
    """A logdir the port trained: ckpt-000000003.npz."""
    path = str(tmp_path_factory.mktemp("served"))
    cfg = Config().parse(RUN).replace(logdir=path)
    train_lib.train(cfg, device="cpu")
    return cfg


def _eval_setup(cfg):
    images, eval_fn = train_lib.make_eval_setup(cfg, "eval_test", 8, "cpu")
    return images[:11], eval_fn      # 2 full batches of 4 and a tail of 3


def test_evaluate_counts_the_tail(logdir):
    setup = _eval_setup(logdir)
    full = train_lib.evaluate(logdir, k=8, setup=setup, device="cpu")
    assert full == train_lib.evaluate(logdir, k=8, setup=setup,
                                      device="cpu")
    no_tail = train_lib.evaluate(logdir, k=8, device="cpu",
                                 setup=(setup[0][:8], setup[1]))
    assert full != no_tail


def test_evaluate_killed_and_resumed_is_exact(logdir, tmp_path, capsys):
    """A run cut after one batch leaves its sums; the resumed run gives
    the uninterrupted result exactly and deletes the file. The id comes
    from the checkpoint's name."""
    setup = _eval_setup(logdir)
    full = train_lib.evaluate(logdir, k=8, setup=setup, device="cpu")
    prog = str(tmp_path / "prog.json")
    train_lib.evaluate(logdir, k=8, setup=setup, max_batches=1,
                       progress_path=prog, progress_every=1, device="cpu")
    with open(prog) as f:
        saved = json.load(f)
    assert saved["i"] == 1 and saved["identity"]["id"] == \
        "ckpt-000000003.npz/ema" and saved["identity"]["impl"] == "iaf_torch"
    resumed = train_lib.evaluate(logdir, k=8, setup=setup,
                                 progress_path=prog, device="cpu")
    assert "resuming at batch 1/2" in capsys.readouterr().out
    assert resumed == full
    assert not os.path.exists(prog)


def test_evaluate_ignores_another_identity(logdir, tmp_path, capsys):
    setup = _eval_setup(logdir)
    model = train_lib._serving_model(logdir, True, torch.device("cpu"))
    full = train_lib.evaluate(logdir, params=model, k=8, setup=setup,
                              device="cpu")
    prog = str(tmp_path / "prog.json")
    train_lib.evaluate(logdir, params=model, k=8, setup=setup,
                       max_batches=1, progress_path=prog, progress_every=1,
                       progress_id="ckpt-OTHER", device="cpu")
    got = train_lib.evaluate(logdir, params=model, k=8, setup=setup,
                             progress_path=prog, progress_id="ckpt-x",
                             device="cpu")
    assert "ignoring stale eval progress" in capsys.readouterr().out
    assert got == full and not os.path.exists(prog)


def test_capped_rerun_keeps_a_more_complete_file(logdir, tmp_path, capsys):
    setup = _eval_setup(logdir)
    prog = str(tmp_path / "prog.json")
    train_lib.evaluate(logdir, k=8, setup=setup, max_batches=2,
                       progress_path=prog, progress_every=1, device="cpu")
    with open(prog) as f:
        before = f.read()
    train_lib.evaluate(logdir, k=8, setup=setup, max_batches=1,
                       progress_path=prog, progress_every=1, device="cpu")
    assert "preserving it" in capsys.readouterr().out
    with open(prog) as f:
        assert f.read() == before and json.loads(before)["i"] == 2


def test_caller_params_need_a_progress_id(logdir, tmp_path):
    model = train_lib._serving_model(logdir, True, torch.device("cpu"))
    with pytest.raises(ValueError, match="progress_id"):
        train_lib.evaluate(logdir, params=model, k=8, max_batches=1,
                           progress_path=str(tmp_path / "p.json"),
                           device="cpu")
    with pytest.raises(ValueError, match="progress_id"):
        train_lib.evaluate(logdir, params=model.state_dict(), k=8,
                           max_batches=1, device="cpu",
                           progress_path=str(tmp_path / "p.json"))


def test_progress_files_of_the_two_packages_are_stale_to_each_other(
        logdir, tmp_path, capsys):
    """The JAX package draws other noise: a file it wrote for the same
    checkpoint, k and split is ignored by the port, and the port's by it."""
    setup = _eval_setup(logdir)
    full = train_lib.evaluate(logdir, k=8, setup=setup, device="cpu")
    jcfg = JConfig().parse(RUN).replace(logdir=logdir.logdir)
    images, jfn = jtl.make_eval_setup(jcfg, "eval_test", 8, make_mesh(jcfg))
    jsetup = (images[:11], jfn)
    prog = str(tmp_path / "prog.json")
    tree = jckpt.restore(jckpt.latest_checkpoint(logdir.logdir))
    jtl.evaluate(jcfg, params=tree["opt"]["ema"], k=8, setup=jsetup,
                 max_batches=1, progress_path=prog, progress_every=1,
                 progress_id="ckpt-000000003.npz/ema")
    assert json.load(open(prog))["identity"]["id"] == \
        "ckpt-000000003.npz/ema"
    assert train_lib.evaluate(logdir, k=8, setup=setup, progress_path=prog,
                              device="cpu") == full
    assert "ignoring stale eval progress" in capsys.readouterr().out
    train_lib.evaluate(logdir, k=8, setup=setup, max_batches=1,
                       progress_path=prog, progress_every=1, device="cpu")
    jtl.evaluate(jcfg, k=8, setup=jsetup, max_batches=1, progress_path=prog,
                 progress_every=1)
    assert "ignoring stale eval progress" in capsys.readouterr().out


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_eval_loop_scores_each_new_checkpoint(logdir, tmp_path,
                                              monkeypatch, capsys):
    """max_evals=1 writes one row of eval_test_metrics.jsonl; with
    max_evals=2 a checkpoint saved while the loop sleeps is scored too,
    one row per checkpoint at its step."""
    cfg = logdir.replace(logdir=str(tmp_path))
    tree = ckpt.restore(ckpt.latest_checkpoint(logdir.logdir))
    ckpt.save(cfg.logdir, 3, tree)
    train_lib.eval_loop(cfg, poll_secs=0.0, max_evals=1, k=8, max_batches=1,
                        device="cpu")
    out = os.path.join(cfg.logdir, "eval_test_metrics.jsonl")
    assert [r["step"] for r in _rows(out)] == [3]
    assert "step 3 ->" in capsys.readouterr().out
    os.remove(out)

    def save_next(_secs):
        tree["step"] = np.asarray(6)
        tree["opt"]["ema"] = jax.tree.map(lambda a: 1.01 * a,
                                          tree["opt"]["ema"])
        ckpt.save(cfg.logdir, 6, tree)
    monkeypatch.setattr(train_lib.time, "sleep", save_next)
    train_lib.eval_loop(cfg, poll_secs=5.0, max_evals=2, k=8, max_batches=1,
                        device="cpu")
    rows = _rows(out)
    assert [r["step"] for r in rows] == [3, 6]
    assert rows[0]["bits_per_dim"] != rows[1]["bits_per_dim"]
    ema6 = train_lib._model(cfg, from_jax_params(tree["opt"]["ema"]),
                            torch.device("cpu"))
    want = train_lib.evaluate(cfg, params=ema6, k=8, max_batches=1,
                              device="cpu")
    assert rows[1]["bits_per_dim"] == pytest.approx(want, rel=1e-12)


def _jax_logdir(tmp_path):
    """A logdir whose checkpoint the JAX package's checkpoint module wrote
    (its keys; port-initialised weights, EMA = params)."""
    cfg, _, params = _model_and_params(RUN)
    zeros = jax.tree.map(np.zeros_like, params)
    jckpt.save(str(tmp_path), 5, {
        "step": np.asarray(5), "params": params,
        "opt": {"step": np.asarray(5, np.int32), "m": zeros, "u": zeros,
                "ema": params},
        "rng": np.asarray(jax.random.PRNGKey(cfg.seed))})
    return cfg.replace(logdir=str(tmp_path))


@pytest.mark.parametrize("source", ["port", "jax"])
def test_sample_recon_and_invert_check_serve_a_logdir(logdir, tmp_path,
                                                      source):
    cfg = logdir if source == "port" else _jax_logdir(tmp_path)
    out = str(tmp_path / "samples.npy")
    imgs = train_lib.sample(cfg, num=5, temperature=[1.0, 0.5],
                            out_path=out, device="cpu")
    assert imgs.shape == (5, 8, 8, 3) and imgs.dtype == np.uint8
    t1, t05 = (np.load(str(tmp_path / f"samples_T{t}.npy"))
               for t in (1.0, 0.5))
    assert t1.shape == (26, 26, 3) and not np.array_equal(t1, t05)
    model = train_lib._serving_model(cfg, True, torch.device("cpu"))
    with torch.inference_mode():
        want = cvae.cvae_sample(cfg, model, cfg.seed + 4242, 5, 0.5)
    np.testing.assert_array_equal(t05, metrics.img_tile(
        want.numpy().astype(np.uint8)))

    rec_path = str(tmp_path / "recons.npy")
    recon = train_lib.reconstruct(cfg, num=4, out_path=rec_path,
                                  device="cpu")
    assert recon.shape == (4, 8, 8, 3) and recon.dtype == np.uint8
    tile = np.load(rec_path)
    assert tile.shape == (26, 26, 3) and tile.dtype == np.uint8
    np.testing.assert_array_equal(tile[:8, 9:17], recon[0])

    r = train_lib.invert_check(cfg, batch=2, device="cpu")
    assert r["D"] == 4 * 4 * 4 and 0 < r["iters_fixed_point"] < r["D"], r
    for name in ("exact", "jacobi", "fixed_point"):
        assert r[f"err_{name}"] < 1e-4 and r[f"t_{name}"] >= 0, r
    assert "err_exact" not in train_lib.invert_check(
        cfg, batch=2, run_exact=False, device="cpu")


@pytest.mark.parametrize("summaries", [True, False])
def test_train_heartbeat_logs_image_summaries(tmp_path, summaries):
    """eval_every=2 with image_summaries: sample and reconstruction tiles
    of the EMA weights at step 2, the samples from key fold(base, 2**31 -
    5); without it no images."""
    cfg = Config().parse(RUN + ",total_steps=2,eval_every=2").replace(
        logdir=str(tmp_path), image_summaries=summaries)
    state = train_lib.train(cfg, device="cpu")
    img_dir = tmp_path / "images"
    if not summaries:
        assert not img_dir.exists()
        return
    samples = np.load(img_dir / "samples_00000002.npy")
    recons = np.load(img_dir / "recons_00000002.npy")
    assert recons.shape == (26, 26, 3) and recons.dtype == np.uint8
    ema = cvae.CVAE(cfg, device="cpu")
    ema.load_state_dict(state.opt.ema)
    with torch.inference_mode():
        want = cvae.cvae_sample(cfg, ema, fold(cfg.seed, 2**31 - 5), 4)
    np.testing.assert_array_equal(samples, metrics.img_tile(
        want.numpy().astype(np.uint8)))


def test_image_tiles_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (7, 5, 6, 3)).astype(np.uint8)
    np.testing.assert_array_equal(metrics.img_tile(imgs),
                                  jmetrics.img_tile(imgs))
    np.testing.assert_array_equal(metrics.img_tile(imgs[..., :1], pad=2),
                                  jmetrics.img_tile(imgs[..., :1], pad=2))
    f = rng.randn(4, 3, 3, 1) * 5
    np.testing.assert_array_equal(metrics.img_stretch(f),
                                  jmetrics.img_stretch(f))
    log = metrics.MetricsLogger(str(tmp_path), filename="x.jsonl")
    log.log_image("gray", metrics.img_tile(imgs[..., :1]), 12)
    log.log(1, a=2.0)
    log.close()
    saved = np.load(tmp_path / "images" / "gray_00000012.npy")
    np.testing.assert_array_equal(saved, metrics.img_tile(imgs[..., :1]))
    assert (tmp_path / "images" / "gray_00000012.png").exists()
    assert _rows(tmp_path / "x.jsonl")[0]["a"] == 2.0


def test_iaf_flow_hands_k1_contiguous_inputs(monkeypatch):
    """K1's kernel takes NHWC-contiguous z and context only; cuDNN can
    return a conv's output in NCHW memory (on the card at 16 images and
    k = 1, the reconstruction's shape), which the posterior sample and
    the context inherit. The layer that routes to K1
    (``ARMultiConv2d.forward``) hands it contiguous copies, whoever calls
    it: here ``iaf_flow``."""
    from iaf_torch import ops
    cfg, model, _ = _model_and_params(TINY)
    seen = []

    def spy(z, context, *rest):
        seen.append((z.is_contiguous(), context.is_contiguous()))
        return ops.ar_stack_ref(z, context, *rest[:2])
    monkeypatch.setattr(ops, "ar_stack", spy)
    z = torch.randn(2, 4, 4, 4).permute(0, 3, 1, 2).contiguous() \
        .permute(0, 2, 3, 1)               # NHWC values, NCHW memory
    ctx = torch.randn(2, 8, 4, 4).permute(0, 2, 3, 1)
    with torch.inference_mode():
        got, _ = cvae.iaf_flow(cfg, model.blocks[0], z, ctx,
                               torch.zeros_like(z))
        want, _ = cvae.iaf_flow(cfg, model.blocks[0], z.contiguous(),
                                ctx.contiguous(), torch.zeros(2, 4, 4, 4))
    assert seen == [(True, True)] * 2 and torch.equal(got, want)


@pytest.mark.parametrize("fn", ["sample", "probe"])
def test_sample_and_probe_compute_with_tf32_off(monkeypatch, fn):
    """The prior decode and the probe compute in f32 under any
    compute_dtype, so on the card their cuDNN convs run with TF32 off
    whatever the process's flags; the flags are restored after."""
    cfg, model, _ = _model_and_params(TINY.replace("float32", "bfloat16"))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen, split = [], cvae._split

    def spy(*args):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return split(*args)
    monkeypatch.setattr(cvae, "_split", spy)
    x = np.zeros((2, 8, 8, 3), np.uint8)
    with torch.inference_mode():
        if fn == "sample":
            cvae.cvae_sample(cfg, model, 0, 2)
        else:
            cvae.posterior_flow_probe(cfg, model, 0, x)
    assert seen and set(seen) == {(False, False)}, seen
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("mode", ["sample", "reconstruct", "invert_check"])
def test_serving_modes_print_the_config_line(logdir, capsys, mode):
    """Each serving entry point says its recipe, as ``evaluate`` does (on
    the card the f32 recipe's line turns TF32 off)."""
    cfg = logdir.replace(compute_dtype="bfloat16")
    kw = {"batch": 2, "run_exact": False} if mode == "invert_check" else {
        "num": 2}
    getattr(train_lib, mode)(cfg, device="cpu", **kw)
    assert "[config] compute_dtype=bfloat16" in capsys.readouterr().out
