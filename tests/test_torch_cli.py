"""The port's CLI (``iaf_torch.cli``) on the CPU: ``--profile_dir`` leaves
a trace of the run; ``eval_loop``, ``sample``, ``recon`` and
``invert_check`` run on a tiny logdir and write what they serve;
``eval_test`` resumes from its progress file and removes it after a full
pass; on a tiny MNIST-family logdir (a Bernoulli ``--hpconfig`` trained
through the CLI) ``sample`` and ``recon`` write their uint8 tiles and
``invert_check`` raises, the CIFAR family's only; ``export`` writes both
serving artifacts; a training trace holds the named ranges of the model
and the step."""

import json
import os
import re

import numpy as np
import pytest

from iaf_torch import cli
from iaf_torch.utils import trace

TINY = ("dataset=synthetic,image_size=8,z_size=4,h_size=8,depth=1,"
        "num_blocks=2,batch_size=4,eval_batch_size=4,eval_k=2,"
        "eval_k_chunk=2")


def _traces(d):
    found = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert found, os.listdir(d)
    for f in found:
        with open(os.path.join(d, f)) as fh:
            assert json.load(fh)["traceEvents"]
    return found


def test_profile_dir_holds_a_trace_of_train_and_eval(tmp_path, capsys):
    """A 1-step tiny ``--mode train`` and a 1-batch ``--mode eval_test``
    on the CPU, each with ``--profile_dir``, leave a torch.profiler trace
    with events in their directory (the JAX package's CLI traces every
    mode into its profile directory)."""
    logdir = str(tmp_path / "log")
    for mode, extra in (("train", ["--hpconfig",
                                   TINY + ",total_steps=1,ckpt_every=1"]),
                        ("eval_test", ["--max_batches", "1"])):
        prof = tmp_path / f"prof_{mode}"
        cli.main(["--logdir", logdir, "--mode", mode, "--device", "cpu",
                  "--profile_dir", str(prof), *extra])
        assert f"trace written to {prof}" in capsys.readouterr().out
        _traces(prof)


def test_profile_dir_is_written_when_the_mode_fails(tmp_path, monkeypatch):
    """The trace is stopped and written in a ``finally``: a run that
    raises still leaves it."""
    def boom(*args, **kwargs):
        raise RuntimeError("boom")
    monkeypatch.setattr(cli.train_lib, "train", boom)
    prof = tmp_path / "prof"
    with pytest.raises(RuntimeError, match="boom"):
        cli.main(["--logdir", str(tmp_path / "log"), "--hpconfig", TINY,
                  "--mode", "train", "--device", "cpu", "--profile_dir",
                  str(prof)])
    _traces(prof)


def test_profile_dir_trace_holds_the_named_ranges(tmp_path):
    """The JAX package's named scopes as ``record_function`` ranges in a
    1-step ``--mode train`` trace: the model's ``iaf_up``, ``iaf_down``
    and ``ar_stack``, the step's ``grads`` and ``adamax_polyak``; and the
    port's host span around the step's loads, ``iaf.train.load``. The
    device marks the run turned on are off again after it."""
    prof = tmp_path / "prof"
    cli.main(["--logdir", str(tmp_path / "log"), "--mode", "train",
              "--device", "cpu", "--profile_dir", str(prof), "--hpconfig",
              TINY + ",total_steps=1,ckpt_every=1"])
    names = set()
    for f in _traces(prof):
        with open(os.path.join(prof, f)) as fh:
            names |= {e.get("name") for e in json.load(fh)["traceEvents"]}
    for scope in ("iaf_up", "iaf_down", "ar_stack", "grads",
                  "adamax_polyak", "iaf.train.load"):
        assert scope in names, scope
    assert trace.set_marks(False) is False


MNIST = ("dataset=synthetic,likelihood=bernoulli,binarize=true,"
         "ar_kind=dense,image_size=8,channels=1,z_size=4,h_size=8,"
         "ar_hidden_size=16,depth_ar=1,flow_depth=2,batch_size=4,"
         "eval_batch_size=4,eval_k=2,eval_k_chunk=2")


@pytest.fixture(scope="module")
def trained_mnist(tmp_path_factory):
    """A tiny MNIST-family logdir trained through the CLI:
    ckpt-000000002.npz."""
    logdir = str(tmp_path_factory.mktemp("cli_mnist"))
    cli.main(["--logdir", logdir, "--mode", "train", "--device", "cpu",
              "--hpconfig", MNIST + ",total_steps=2,ckpt_every=2"])
    return logdir


@pytest.mark.parametrize("mode,name", [("sample", "samples.npy"),
                                       ("recon", "recons.npy")])
def test_mnist_serving_writes_its_tiles(trained_mnist, mode, name):
    """``--mode sample`` and ``--mode recon`` of the MNIST family write
    uint8 tiles of single-channel Bernoulli means."""
    cli.main(["--logdir", trained_mnist, "--mode", mode, "--device", "cpu",
              "--num_samples", "4"])
    tile = np.load(os.path.join(trained_mnist, name))
    assert tile.dtype == np.uint8 and tile.ndim == 3 and tile.shape[2] == 1


def test_mnist_invert_check_raises_cifar_only(trained_mnist):
    with pytest.raises(NotImplementedError, match="CIFAR family"):
        cli.main(["--logdir", trained_mnist, "--mode", "invert_check",
                  "--device", "cpu"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny logdir trained through the CLI: ckpt-000000002.npz."""
    logdir = str(tmp_path_factory.mktemp("cli_served"))
    cli.main(["--logdir", logdir, "--mode", "train", "--device", "cpu",
              "--hpconfig", TINY + ",total_steps=2,ckpt_every=2"])
    return logdir


class _Stop(Exception):
    pass


def _stop(_secs):
    raise _Stop


def test_eval_loop_mode_logs_the_checkpoint(trained, monkeypatch, capsys):
    """``--mode eval_loop`` scores the newest checkpoint into
    eval_test_metrics.jsonl and then polls (stopped here at its sleep)."""
    monkeypatch.setattr(cli.train_lib.time, "sleep", _stop)
    with pytest.raises(_Stop):
        cli.main(["--logdir", trained, "--mode", "eval_loop", "--device",
                  "cpu", "--max_batches", "1"])
    assert "step 2 ->" in capsys.readouterr().out
    with open(os.path.join(trained, "eval_test_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows[-1]["step"] == 2 and rows[-1]["bits_per_dim"] > 0


@pytest.mark.parametrize("mode,args,files", [
    ("sample", ["--num_samples", "4"], ["samples.npy"]),
    ("sample", ["--num_samples", "4", "--temperature", "1.0,0.5"],
     ["samples_T1.0.npy", "samples_T0.5.npy"]),
    ("recon", ["--num_samples", "2"], ["recons.npy"])])
def test_sample_and_recon_modes_write_their_tiles(trained, mode, args, files):
    for name in files:
        if os.path.exists(os.path.join(trained, name)):
            os.remove(os.path.join(trained, name))
    cli.main(["--logdir", trained, "--mode", mode, "--device", "cpu", *args])
    for name in files:
        tile = np.load(os.path.join(trained, name))
        assert tile.dtype == np.uint8 and tile.shape == (17, 17, 3), name


def test_export_mode_writes_both_artifacts(trained, capsys):
    """``--mode export`` writes ``<logdir>/export/sample.pt2`` and
    ``elbo.pt2`` from the newest checkpoint, each loadable."""
    from iaf_torch.core.export import load_exported
    cli.main(["--logdir", trained, "--mode", "export", "--device", "cpu",
              "--num_samples", "2"])
    out = capsys.readouterr().out
    for name in ("sample", "elbo"):
        path = os.path.join(trained, "export", f"{name}.pt2")
        assert f"[export] wrote {path}" in out
        assert load_exported(path).contract["surface"] == name


def test_invert_check_mode_reports_the_three_inverses(trained, capsys):
    cli.main(["--logdir", trained, "--mode", "invert_check", "--device",
              "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[invert_check]")][-1]
    assert "D=64" in line and "fixed-point converged in" in line
    errs = [float(e) for e in re.findall(r"err (\S+) ", line)]
    assert len(errs) == 3 and max(errs) < 1e-4, line


def test_eval_test_mode_resumes_and_removes_its_progress(trained, capsys):
    """A capped ``--mode eval_test`` leaves
    eval_progress_eval_test.json; the full pass resumes from it and
    removes it."""
    prog = os.path.join(trained, "eval_progress_eval_test.json")
    hp = ["--hpconfig", "eval_batch_size=256"]   # 4 batches of the split
    cli.main(["--logdir", trained, "--mode", "eval_test", "--device", "cpu",
              "--max_batches", "1", *hp])
    assert json.load(open(prog))["i"] == 1
    cli.main(["--logdir", trained, "--mode", "eval_test", "--device", "cpu",
              *hp])
    assert "resuming at batch 1/4" in capsys.readouterr().out
    assert not os.path.exists(prog)
