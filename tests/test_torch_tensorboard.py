"""``MetricsLogger(tensorboard=True)`` (``iaf_tpu/utils/metrics.py``'s
mirroring): rows reach an event file under ``<logdir>/tb``; where the
writer does not import, one line says so and the JSON rows go on."""

import builtins
import json
import os

import numpy as np

from iaf_torch.utils.metrics import MetricsLogger


def test_tensorboard_writes_an_event_file(tmp_path):
    logger = MetricsLogger(str(tmp_path), tensorboard=True)
    logger.log(3, loss=1.5, kl_per_layer=np.array([0.25, 0.5]))
    logger.log_image("samples", np.zeros((4, 4, 3), np.uint8), 3)
    logger.close()
    events = [f for f in os.listdir(tmp_path / "tb")
              if f.startswith("events.out.tfevents")]
    assert events and os.path.getsize(tmp_path / "tb" / events[0]) > 0
    with open(tmp_path / "metrics.jsonl") as f:
        assert json.loads(f.readline())["kl_per_layer"] == [0.25, 0.5]


def test_without_tensorboard_one_line_says_so(tmp_path, monkeypatch,
                                             capsys):
    real_import = builtins.__import__

    def no_tb(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard here")
        return real_import(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_tb)
    logger = MetricsLogger(str(tmp_path), tensorboard=True)
    logger.log(1, loss=2.0)
    logger.close()
    assert ("[metrics] tensorboard writer unavailable: no tensorboard here"
            in capsys.readouterr().out)
    assert not os.path.exists(tmp_path / "tb")
    with open(tmp_path / "metrics.jsonl") as f:
        assert json.loads(f.readline())["loss"] == 2.0
