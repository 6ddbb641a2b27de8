"""The readings that the limits of ``limits/<cell>.json`` are set from,
in one process on the card, at the cell's own size:

    python3 -m portbench.controls --workload <cell> --seeds 12 \
        --control-seeds 3 [--out FILE]

- ``program``: the program's numbers on each seed (sound runs: the
  training object's first steps, or an eval batch's sampled answers,
  against the f32 reference), the lower readings.
- ``control``: the reference computed with every conv operand rounded to
  float8 e4m3 (per-tensor scale), put in the program's place: the
  precision below the configuration's bf16.
- ``half_batch``: training, the reference with half of each batch left
  out, the mean taken over the rest, put in the program's place; IW
  eval, the program with the second half of each batch's bounds left
  out and the mean of the first half's given for them, read through the
  cell's own picks.

A state left unchanged reads 1 on ``change`` and ``ema`` by construction
and needs no run. One JSON line per reading, on standard output and in
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from portbench import cells, inputs, judge, spec
from portbench import reference as ref


def _emit(out, **row) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def train_readings(r: cells.Run, control: bool, out) -> None:
    s = cells.TrainSetup(r, builds=False)
    batches, prog = s.batches, s.readings
    s.prog.close()
    del s
    cells._free(r.device)
    steps = r.traffic["check_steps"]
    base = cells.train_reference(r.c, r.seed, batches, steps, r.device)
    _emit(out, workload=r.workload, seed=r.seed, kind="program",
          numbers=judge.train_numbers(prog, base))
    if not control:
        return
    q = cells.train_reference(r.c, r.seed, batches, steps, r.device,
                              quant=ref.fp8_quant)
    _emit(out, workload=r.workload, seed=r.seed, kind="control",
          numbers=judge.train_numbers(q, base))
    half = slice(0, r.traffic["batch_size"] // 2)
    h = cells.train_reference(r.c, r.seed, batches, steps, r.device,
                              rows=half)
    _emit(out, workload=r.workload, seed=r.seed, kind="half_batch",
          numbers=judge.train_numbers(h, base))


def eval_readings(s: cells.EvalSetup, r: cells.Run, control: bool,
                  out) -> None:
    """Batch 1 of seed ``r.seed`` through the warmed-up eval step: its
    weights copied in place (the graph reads them where they live) and
    its draws."""
    t = r.traffic
    P = inputs.weights(r.c, r.seed, r.device)
    with torch.no_grad():
        for n, p in s.prog.model.named_parameters():
            p.copy_(P[n])
    del P
    s.r = r
    s.images = inputs.images(r.seed, t["images"], r.c["image_size"],
                             r.c["channels"])
    s.noise = inputs.NoiseStream(r.c, r.seed, "eval",
                                 s.bs * s.prog.step.k_chunk, r.device)
    got = s.batch(1)
    picks = cells.pick(r.seed, [1], s.bs, t["check_per_half"])
    images = [s.batch_images(b)[i] for b, i in picks]
    prog = torch.stack([got[i] for _, i in picks])
    args = (r.c, r.seed, picks, images, s.bs, s.k, s.prog.step.k_chunk,
            t["ref_block"], r.device)
    base = cells.eval_reference(*args)
    _emit(out, workload=r.workload, seed=r.seed, kind="program",
          numbers=judge.eval_numbers(prog, base),
          answers=[[float(a), float(b)] for a, b in zip(prog, base)])
    if control:
        q = cells.eval_reference(*args, quant=ref.fp8_quant)
        _emit(out, workload=r.workload, seed=r.seed, kind="control",
              numbers=judge.eval_numbers(q, base))
        half = _half_batch(s)
        _emit(out, workload=r.workload, seed=r.seed, kind="half_batch",
              numbers=judge.eval_numbers(
                  torch.stack([half[i] for _, i in picks]), base))


def _half_batch(s: cells.EvalSetup) -> torch.Tensor:
    """Batch 1 again, with the second half of its bounds replaced by the
    mean of the first half's."""
    from iaf_torch.parallel import eval_step
    real = eval_step._bound

    def half(m, s_run, k, g):
        b = real(m, s_run, k, g)
        n = b.shape[0] // 2
        return torch.cat([b[:n], b[:n].mean().expand(b.shape[0] - n)])

    eval_step._bound = half
    try:
        return s.batch(1)
    finally:
        eval_step._bound = real


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    root = spec.ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(root / "iaf_torch" / "triton"))
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    w, conf, traffic = spec.cell(spec.benchmark(), a.workload)
    from portbench import program
    program.build_kernels()
    t0 = time.time()
    setup = None
    for j in range(a.seeds):
        seed = a.first_seed + 7919 * j
        r = cells.Run(a.workload, conf["config"], traffic, seed, 0, False,
                      dev, time.time())
        control = j < a.control_seeds
        if traffic["kind"] == "train":
            train_readings(r, control, a.out)
        else:
            if setup is None:
                setup = cells.EvalSetup(r, builds=False)
            eval_readings(setup, r, control, a.out)
        print(f"[controls] seed {seed} done at {time.time() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
