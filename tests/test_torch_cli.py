"""The port's CLI (``iaf_torch.cli``) on the CPU: ``--profile_dir`` leaves
a trace of the run, and the modes not ported yet raise naming the
ROADMAP item that brings them."""

import json
import os
import re

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


@pytest.mark.parametrize("mode,item,title", [
    ("eval_loop", 1, "Eval, the rest"),
    ("sample", 5, "Sampling"), ("recon", 5, "Sampling"),
    ("invert_check", 5, "Sampling"), ("export", 7, "CLI, export")])
def test_unported_modes_name_their_roadmap_item(tmp_path, mode, item, title):
    """Each unported mode raises naming its item of ROADMAP queue 1 ("Modules
    still to port"), and that item is the one that brings it."""
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue 1, item {item} "):
        cli.main(["--logdir", str(tmp_path), "--hpconfig", TINY, "--mode",
                  mode, "--device", "cpu"])
    with open(ROADMAP) as f:
        text = f.read()
    queue = text.split("### 1. Modules still to port", 1)[1].split("\n### ")[0]
    heading = re.search(rf"^{item}\. \*\*(.+?)\*\*", queue, re.M)
    assert heading and title in heading.group(1), heading
