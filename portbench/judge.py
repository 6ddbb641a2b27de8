"""The numbers that decide ``correct``: the program's readings against the
plain reference's, each number held to its limit.

Training (the first three steps of the object the window then drives):

- ``loss``: the largest relative gap of a step's loss.
- ``parts``: the largest gap of a step's parts (mean free-bits KL, mean
  KL, mean log p(x|z), each layer's mean KL), against the reference's
  part or the median part, whichever is larger.
- ``grad``: the last checked step's gradient (a graph replay's) as the
  optimizer got it (the program's from its first moment before and
  after that step, (m' - beta1 m) / (1 - beta1)), by the worst leaf: the
  gap between the two norms against the reference's norm of that leaf or
  of the median leaf, whichever is larger.
- ``change``: the parameters' change over the three steps, the same way,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (Adamax moves those by round-off alone).
- ``ema``: the Polyak average's change over the three steps, the same.

IW eval: ``nll``, the largest gap in nats between the program's and the
reference's negative k-sample bound over the images sampled from each
half of every batch of the window.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
SMALL_GRAD = 1e-3


def _median(xs: torch.Tensor) -> float:
    return float(torch.median(xs.double()))


def worst_leaf(prog: dict[str, float], ref: dict[str, float],
               keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, median ref)."""
    names = [n for n in ref if keep is None or n in keep]
    r = torch.tensor([ref[n] for n in names], dtype=torch.float64)
    p = torch.tensor([prog[n] for n in names], dtype=torch.float64)
    floor = max(_median(r), 1e-300)
    return float(torch.max((p - r).abs() / torch.clamp(r, min=floor)))


def norms(ts: dict[str, torch.Tensor], scale: float = 1.0
          ) -> dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) * scale
            for n, t in ts.items()}


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``prog`` and ``ref`` hold "loss" [steps], "parts" [steps][...],
    "grad", "change", "ema" (per-leaf norms); ``ref`` also "grad" norms
    for the rule on small gradients."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    parts = 0.0
    for p, r in zip(prog["parts"], ref["parts"]):
        p, r = p.double(), r.double()
        floor = max(_median(r.abs()), 1e-300)
        parts = max(parts, float(torch.max((p - r).abs()
                                           / torch.clamp(r.abs(), min=floor))))
    g = torch.tensor(list(ref["grad"].values()), dtype=torch.float64)
    cut = SMALL_GRAD * _median(g)
    keep = {n for n, v in ref["grad"].items() if v >= cut}
    return {"loss": loss, "parts": parts,
            "grad": worst_leaf(prog["grad"], ref["grad"]),
            "change": worst_leaf(prog["change"], ref["change"], keep),
            "ema": worst_leaf(prog["ema"], ref["ema"], keep)}


def eval_numbers(prog: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
    return {"nll": float(torch.max((prog.double() - ref.double()).abs()))}


def limits(workload: str) -> dict[str, float] | None:
    path = HERE / "limits" / f"{workload}.json"
    if not path.is_file():
        return None
    return json.loads(path.read_text())["limits"]


def verdict(numbers: dict[str, float], lim: dict[str, float] | None
            ) -> tuple[bool, dict[str, list]]:
    """(every limited number finite and at most its limit, {name:
    [number, limit]}). A number without a limit is shown, not judged; no
    limits at all is not correct."""
    lim = lim or {}
    checks = {k: [v, lim.get(k)] for k, v in numbers.items()}
    ok = bool(lim) and all(k in numbers and numbers[k] == numbers[k]
                           and numbers[k] <= v for k, v in lim.items())
    return ok, checks
