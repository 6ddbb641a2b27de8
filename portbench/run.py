"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``iaf_torch`` and a CUDA card.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared with the plain reference, beside its limit. The lines before it
name the card, its power limit and clocks, the kernel builds of a cold
checkout and what the window held. Exits 2 with no result where there
is no card or too few, and 3 where a module of the JAX package or JAX
itself was loaded.

Kernel builds (``build/iaf_torch``) and Triton's cache
(``build/iaf_torch/triton``) stay inside the checkout, at fixed paths, so
that only a checkout's first run builds.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "iaf_tpu")


def process_start() -> float:
    """The process's start on the host clock (from its start in clock
    ticks since boot), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        since = time.clock_gettime(time.CLOCK_BOOTTIME) \
            - ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - since
    except (OSError, ValueError, IndexError):
        return time.time()


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
        return out or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if a.seed < 0:
        p.error("--seed must be non-negative")
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "iaf_torch" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "portbench" / "cuda_cache")

    from portbench import spec
    bench = spec.benchmark()
    w, conf, traffic = spec.cell(bench, a.workload)

    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < w["chips"]:
        print(f"portbench: {w['chips']} cards asked, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from portbench import cells, judge
    r = cells.Run(a.workload, conf["config"], traffic, a.seed, a.seconds,
                  bool(a.trace), dev, t_start)
    card = card_line()
    r.say(f"[card] {torch.cuda.get_device_name(dev)}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = cells.KINDS[traffic["kind"]](r)
    r.say(f"[card] after the run: {card_line()}")

    metrics = {}
    if a.trace:
        x = cells.Reading(conf["config"], traffic, out)
        for m in spec.metrics(bench, a.workload, True):
            v = spec.reader(m["name"])(x)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec.metrics(bench, a.workload, False):
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    correct, checks = judge.verdict(out.numbers, judge.limits(a.workload))
    finite = all(math.isfinite(v["value"]) for v in metrics.values())
    correct = correct and out.failed == 0 and finite
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": w["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    if a.trace:
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.by_name(),
                               "idle_gaps": out.trace.idle_gaps()}
    result["checks"] = checks

    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    for line in r.lines:
        print(line)
    sys.stdout.flush()
    for k, (v, lim) in checks.items():
        print(f"[check] {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
