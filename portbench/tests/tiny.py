"""A tiny configuration and traffic for CPU tests: the cells' own files
with the model cut to a few channels and two IAF layers."""

import json
import time

import torch

from portbench import cells, spec


def config(name: str = "iaf-paper", **kw) -> dict:
    c = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
    small = dict(image_size=8, z_size=4, h_size=16, num_blocks=2)
    return dict(c["config"], **{**small, **kw})


def traffic(name: str, **kw) -> dict:
    t = json.loads((spec.HERE / "traffic" / f"{name}.json").read_text())
    if t["kind"] == "train":
        t.update(batch_size=4, images=64, trace_steps=3)
    else:
        t.update(batch_size=2, k=16, k_chunk=4, images=8, ref_block=8)
    t.update(kw)
    return t


def run(c: dict, t: dict, seed: int = 12345, seconds: float = 0.3):
    return cells.Run("tiny", c, t, seed, seconds, False, torch.device("cpu"),
                     time.time())
