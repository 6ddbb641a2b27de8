"""The port's inference export (``iaf_torch.core.export``, ``--mode
export``) on the CPU, at the sizes of tests/test_export.py: the loaded
CIFAR artifacts against ``iaf_tpu.core.export.build_inference_fns`` with
JAX's draws injected, and bitwise against the eager port with
``draw_noise``'s tensors (the port's counterpart of the JAX package's
bit-exact round trip); the graph records the kernels' torch ops (3x3 and
5x5) and no twin in their place; the static shape check; the MNIST
family; ``export_saved`` from a checkpoint, on rank 0 only; the
platforms; and a load in a process that imports no model code."""

import json
import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.core.config import Config as JConfig
from iaf_tpu.core.export import build_inference_fns as jax_fns
from iaf_tpu.core.rng import fold_name
from iaf_torch import train_lib
from iaf_torch.bridge import to_jax_params
from iaf_torch.core import export
from iaf_torch.core.config import Config
from iaf_torch.models import cvae, mnist_vae

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_export.py's CIFAR config, in f32 (the tolerance of
# tests/test_torch_cvae.py holds the f32 forward)
TINY = ("dataset=synthetic,image_size=8,channels=3,z_size=2,h_size=8,"
        "depth=1,num_blocks=2,depth_ar=1,ar_hidden_size=8,kl_min=0.25,"
        "batch_size=8,eval_batch_size=4,compute_dtype=float32")
NUM, K = 4, 2


def _images(seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (8, 8, 8, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def cifar(tmp_path_factory):
    """The port's init on 8 images, bridged to JAX params, and both
    artifacts at k=2 and 4 samples."""
    cfg = Config().parse(TINY)
    model = cvae.init_params(cfg, _images(), rng=0, device="cpu")
    paths = export.export_artifacts(
        cfg, model, str(tmp_path_factory.mktemp("export")), num_samples=NUM,
        k=K)
    return cfg, model, to_jax_params(model.state_dict()), paths


def _ops(program) -> Counter:
    return Counter(str(n.target) for n in program.graph.nodes
                   if n.op == "call_function")


def _jax_draws(cfg, key, site, rows):
    hw = cfg.image_size // 2
    return [torch.from_numpy(np.array(jax.random.normal(
        fold_name(fold_name(key, n), site), (rows, hw, hw, cfg.z_size))))
        for n in cvae.layer_names(cfg)]


def test_elbo_artifact_matches_jax(cifar):
    """JAX's ``z_post`` draws for key 3 fed to the artifact: the nats of
    JAX's ``elbo_fn(key, x)`` at rtol 1e-5, atol 1e-4."""
    cfg, _, params, paths = cifar
    jcfg, key = JConfig().parse(TINY), jax.random.PRNGKey(3)
    x = _images(1)[:cfg.eval_batch_size]
    _, elbo_fn = jax_fns(jcfg, params, num_samples=NUM, k=K)
    want = np.asarray(jax.jit(elbo_fn)(key, jnp.asarray(x)))
    fn = export.load_exported(paths["elbo"])
    got = fn(torch.from_numpy(x),
             *_jax_draws(cfg, key, "z_post", cfg.eval_batch_size * K))
    assert got.shape == (cfg.eval_batch_size,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_sample_artifact_matches_jax(cifar):
    """JAX's ``z_prior`` draws fed to the artifact: JAX's ``sample_fn``
    within 2e-3 on the [0, 256) scale, at two temperatures."""
    cfg, _, params, paths = cifar
    jcfg, key = JConfig().parse(TINY), jax.random.PRNGKey(3)
    sample_fn, _ = jax_fns(jcfg, params, num_samples=NUM, k=K)
    fn = export.load_exported(paths["sample"])
    noise = _jax_draws(cfg, key, "z_prior", NUM)
    for t in (1.0, 0.5):
        want = np.asarray(jax.jit(sample_fn)(key, jnp.float32(t)))
        got = fn(torch.tensor(t), *noise)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def test_artifacts_equal_the_eager_port_bitwise(cifar):
    """``draw_noise(contract, seed)`` gives the eager forward's draws, so
    each artifact equals the eager surface at that seed bit for bit; the
    batch here is in Fortran order (numpy hands such arrays out), which
    the loader makes contiguous, as the eager forward does."""
    cfg, model, _, paths = cifar
    elbo, sample = (export.load_exported(paths[n]) for n in ("elbo",
                                                              "sample"))
    assert elbo.contract["k"] == K and elbo.contract["batch"] == 4
    assert [s for s, _ in elbo.contract["noise"]] == list(
        cvae.noise_shapes(cfg, 8))
    x = np.asfortranarray(_images(2)[:cfg.eval_batch_size])
    assert not torch.from_numpy(x).is_contiguous()
    got = elbo(torch.from_numpy(x), *export.draw_noise(elbo.contract, 7,
                                                       "cpu"))
    with torch.inference_mode():
        want = cvae.apply_fn(cfg, model, 7, x, mode="eval", k=K).elbo_nats
        samples = {t: cvae.cvae_sample(cfg, model, 9, NUM, t)
                   for t in (1.0, 0.5)}
    assert torch.equal(got, want)
    for t, want in samples.items():
        got = sample(torch.tensor(t), *export.draw_noise(sample.contract, 9,
                                                         "cpu"))
        assert torch.equal(got, want)
    assert sample.contract["tf32"] == {"cudnn": False, "matmul": False}


@pytest.mark.parametrize("extra,k1", [("", True), (",kernel_size=5", False)])
def test_elbo_graph_records_the_kernel_ops(cifar, tmp_path, extra, k1):
    """Per IAF layer one ``iaf.ar_stack`` (3x3) or ``depth_ar + 1``
    ``iaf.masked_conv2d`` (5x5) and one ``iaf.iaf_update``, one
    ``iaf.disc_logistic_logp`` a call; the only aten convs are the
    model's own (the stem, four a layer), and K4's twin (floor, sigmoid)
    is not in the graph."""
    cfg = Config().parse(TINY + extra)
    if k1:
        program = export.load_exported(cifar[3]["elbo"]).program
    else:
        model = cvae.init_params(cfg, _images(), rng=0, device="cpu")
        program = export.load_exported(export.export_artifacts(
            cfg, model, str(tmp_path), num_samples=2, k=1)["elbo"]).program
    layers = 2
    found = _ops(program)
    want = ({"iaf.ar_stack.default": layers} if k1 else
            {"iaf.masked_conv2d.default": (cfg.depth_ar + 1) * layers})
    want.update({"iaf.iaf_update.default": layers,
                 "iaf.disc_logistic_logp.default": 1})
    assert {k: v for k, v in found.items() if k.startswith("iaf.")} == want
    assert found["aten.conv2d.default"] == 1 + 4 * layers
    assert not {"aten.floor.default", "aten.sigmoid.default"} & set(found)


def test_artifact_checks_input_shapes(cifar):
    cfg, _, _, paths = cifar
    fn = export.load_exported(paths["elbo"])
    noise = export.draw_noise(fn.contract, 0, "cpu")
    with pytest.raises(Exception, match="Guard failed"):
        fn(torch.from_numpy(_images()[:3]), *noise)   # the wrong batch


def test_mnist_round_trip(tmp_path):
    cfg = mnist_vae.mnist_config(
        dataset="synthetic", z_size=4, h_size=8, ar_hidden_size=8,
        flow_depth=1, depth_ar=1, batch_size=8, eval_batch_size=4)
    x = (np.random.RandomState(0).rand(8, 28, 28, 1) > 0.5).astype(
        np.uint8) * 255
    model = mnist_vae.init_params(cfg, x, rng=0, device="cpu")
    paths = export.export_artifacts(cfg, model, str(tmp_path),
                                    num_samples=2, k=1)
    sample, elbo = (export.load_exported(paths[n]) for n in ("sample",
                                                              "elbo"))
    assert [s for s, _ in sample.contract["noise"]] == ["z_prior"]
    assert [s for s, _ in elbo.contract["noise"]] == ["z"]
    assert not [t for t in _ops(elbo.program) if t.startswith("iaf.")]
    got = elbo(torch.from_numpy(x[:4]), *export.draw_noise(elbo.contract,
                                                           11, "cpu"))
    with torch.inference_mode():
        want = mnist_vae.apply_fn(cfg, model, 11, x[:4], mode="eval",
                                  k=1).elbo_nats
        want_s = mnist_vae.sample(cfg, model, 11, 2, 1.0)
    assert torch.equal(got, want)
    got = sample(torch.tensor(1.0), *export.draw_noise(sample.contract, 11,
                                                       "cpu"))
    assert torch.equal(got, want_s)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """tests/test_export.py's checkpoint path: a 4-step CPU training run
    with a checkpoint at step 4."""
    cfg = Config().parse(TINY).replace(
        learning_rate=0.005, total_steps=4, ckpt_every=4, log_every=4,
        eval_k=4, logdir=str(tmp_path_factory.mktemp("trained")))
    rng = np.random.RandomState(1)

    def it():
        while True:
            yield rng.randint(0, 256, (8, 8, 8, 3)).astype(np.uint8)
    train_lib.train(cfg, data_iter=it(), device="cpu")
    return cfg


def test_export_saved_from_checkpoint(trained, capsys):
    paths = train_lib.export_saved(trained, num_samples=2, device="cpu")
    assert sorted(paths) == ["elbo", "sample"]
    out = capsys.readouterr().out
    for p in paths.values():
        assert os.path.dirname(p) == os.path.join(trained.logdir, "export")
        assert f"[export] wrote {p} ({os.path.getsize(p)} bytes)" in out
    fn = export.load_exported(paths["sample"])
    assert fn.contract["use_ema"] is True
    got = fn(torch.tensor(1.0), *export.draw_noise(fn.contract, 0, "cpu"))
    assert got.shape == (2, 8, 8, 3) and torch.isfinite(got).all()


def test_export_saved_writes_on_rank_zero_only(trained, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(train_lib.mesh, "rank", lambda: 1)
    out = tmp_path / "rank1"
    assert train_lib.export_saved(trained, out_dir=str(out),
                                  device="cpu") == {}
    assert not out.exists()


@pytest.mark.parametrize("platforms,match", [
    (["tpu"], "iaf_tpu's export"), (["cpu", "gpu"], "not available")])
def test_export_platforms_that_cannot_be_served_raise(
        cifar, tmp_path, monkeypatch, platforms, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, model, _, _ = cifar
    with pytest.raises(ValueError, match=match):
        export.export_artifacts(cfg, model, str(tmp_path),
                                platforms=platforms)
    assert not os.listdir(tmp_path)


def test_export_platforms_name_each_file(cifar, tmp_path):
    cfg, model, _, _ = cifar
    paths = export.export_artifacts(cfg, model, str(tmp_path),
                                    num_samples=2, platforms=["cpu"])
    assert sorted(os.path.basename(p) for p in paths.values()) == [
        "elbo.pt2", "sample.pt2"]
    assert export.load_exported(paths["elbo"]).contract["device"] == "cpu"


_CHILD = """
import sys, json, torch
import iaf_torch.ops
from iaf_torch.core.export import draw_noise, load_exported
import numpy as np
fn = load_exported(sys.argv[1])
x = torch.from_numpy(np.load(sys.argv[2]))
out = fn(x, *draw_noise(fn.contract, 7, "cpu"))
bad = sorted(m for m in sys.modules if m.startswith(("iaf_torch.models",
             "iaf_torch.nn.layers", "iaf_torch.train_lib", "jax", "iaf_tpu")))
print(json.dumps({"out": out.tolist(), "bad": bad}))
"""


def test_artifact_loads_in_a_process_without_model_code(cifar, tmp_path):
    """A fresh process that imports only torch, ``iaf_torch.ops`` and
    ``iaf_torch.core.export`` loads the elbo artifact and gives the eager
    port's bits; no model code, no JAX is imported."""
    cfg, model, _, paths = cifar
    x = _images(2)[:cfg.eval_batch_size]
    np.save(tmp_path / "x.npy", x)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, paths["elbo"], str(tmp_path / "x.npy")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    with torch.inference_mode():
        want = cvae.apply_fn(cfg, model, 7, x, mode="eval", k=K).elbo_nats
    assert torch.equal(torch.tensor(res["out"], dtype=torch.float32), want)
