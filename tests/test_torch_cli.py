"""The port's CLI (``iaf_torch.cli``) on the CPU: ``--profile_dir`` leaves
a trace of the run; ``eval_loop``, ``sample``, ``recon`` and
``invert_check`` run on a tiny logdir and write what they serve;
``eval_test`` resumes from its progress file and removes it after a full
pass; ``export``, not ported yet, and the MNIST family's sampling and
reconstruction raise naming the ROADMAP item that brings them."""

import json
import os
import re

import numpy as np
import pytest

from iaf_torch import cli

TINY = ("dataset=synthetic,image_size=8,z_size=4,h_size=8,depth=1,"
        "num_blocks=2,batch_size=4,eval_batch_size=4,eval_k=2,"
        "eval_k_chunk=2")
ROADMAP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ROADMAP.md")


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


def _roadmap_item(item, title):
    with open(ROADMAP) as f:
        text = f.read()
    queue = text.split("### 1. Modules still to port", 1)[1].split("\n### ")[0]
    heading = re.search(rf"^{item}\. \*\*(.+?)\*\*", queue, re.M)
    assert heading and title in heading.group(1), heading


@pytest.mark.parametrize("mode,item,title", [("export", 5, "CLI, export")])
def test_unported_modes_name_their_roadmap_item(tmp_path, mode, item, title):
    """Each unported mode raises naming its item of ROADMAP queue 1 ("Modules
    still to port"), and that item is the one that brings it."""
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue 1, item {item} "):
        cli.main(["--logdir", str(tmp_path), "--hpconfig", TINY, "--mode",
                  mode, "--device", "cpu"])
    _roadmap_item(item, title)


@pytest.mark.parametrize("mode", ["sample", "recon"])
def test_mnist_serving_names_its_roadmap_item(tmp_path, mode):
    """Sampling and reconstruction of the MNIST family (Bernoulli means)
    raise naming ROADMAP queue 1's MNIST item, which brings them."""
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1, item 3 "):
        cli.main(["--logdir", str(tmp_path), "--hpconfig",
                  TINY + ",likelihood=bernoulli", "--mode", mode,
                  "--device", "cpu"])
    _roadmap_item(3, "MNIST family")


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
