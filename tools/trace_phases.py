#!/usr/bin/env python3
"""A benchmark cell run with the port's device marks on: where a replayed
training step's or eval chunk's time goes, by phase (iaf_torch, one
NVIDIA card).

    python3 tools/trace_phases.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--marks <0|1>]

Runs ``portbench.run`` on the cell as the benchmark runs it, with the
device marks of ``iaf_torch.utils.trace`` on (``--marks 1``, the default)
from before set-up captures the graphs. With ``--trace 0`` it prints the
cell's end-to-end line; beside runs with ``--marks 0`` (the benchmark as
it is) on the same seeds, that is what the marks cost with no profiler
running. With ``--trace 1`` it prints the cell's traced line, whose idle
gaps are labelled by the innermost range open where each begins, the
program's ``iaf.*`` host spans among the ranges, and then one more JSON
line: ``phases``, the metrics ``read`` finds in the ``iaf_mark_*``
kernels of the traced window, with ``covered``, the share of the window
that the phases of a step or chunk times the window's steps or chunks
make up; ``idle_s``, the window's idle seconds inside the replays and
between them, beside all of its idle time; ``host_us``, what a span and
a mark cost the host with no profiler running and marks off.

The benchmark's harness reads none of this: it has no switch for the
marks, and its trace keeps only its own ranges (PERF.md §7).
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "iaf_mark_"
LAST = {"train": "opt", "iw_eval": "end"}


def marks(ops) -> list[tuple[str, float]]:
    """(mark, start s) of every ``iaf_mark_*`` operation of ``ops``
    [(name, class, start s, end s)], in time order."""
    return sorted(((n[len(PREFIX):], s) for n, _, s, _ in ops
                   if n.startswith(PREFIX)), key=lambda m: m[1])


def replays(found: list[tuple[str, float]], last: str
            ) -> list[list[tuple[str, float]]]:
    """Each replay's marks, from a ``begin`` to the next ``last``; a replay
    that the window cuts is left out."""
    out, cur = [], None
    for name, t in found:
        if name == "begin":
            cur = [(name, t)]
        elif cur is not None:
            cur.append((name, t))
            if name == last:
                out.append(cur)
                cur = None
    return out


def _busy(union, starts, lo: float, hi: float) -> float:
    """The length of ``union`` (disjoint, sorted; ``starts`` its starts)
    inside [lo, hi]."""
    i = max(0, bisect.bisect_right(starts, lo) - 1)
    busy = 0.0
    while i < len(union) and union[i][0] < hi:
        busy += max(0.0, min(hi, union[i][1]) - max(lo, union[i][0]))
        i += 1
    return busy


def phase_sums(ops, kind: str) -> dict | None:
    """Over the window's whole replays (``n``): the seconds summed by the
    mark that closes each interval (``phase``), the gaps from one
    replay's last mark to the next one's ``begin`` (``gaps``), the idle
    seconds inside the replays and inside the gaps (``idle_in``,
    ``idle_between``), the device operations inside the replays with
    marks left out (``count``); None where no replay is whole."""
    from portbench.trace import _union
    reps = replays(marks(ops), LAST[kind])
    if not reps:
        return None
    union = _union([(s, e) for _, _, s, e in ops])
    starts = [u[0] for u in union]
    work = sorted(s for n, _, s, _ in ops if not n.startswith(PREFIX))
    phase: dict[str, float] = {}
    idle, count = 0.0, 0
    for rep in reps:
        for (_, t0), (name, t1) in zip(rep, rep[1:]):
            phase[name] = phase.get(name, 0.0) + (t1 - t0)
        lo, hi = rep[0][1], rep[-1][1]
        idle += (hi - lo) - _busy(union, starts, lo, hi)
        count += bisect.bisect_left(work, hi) - bisect.bisect_left(work, lo)
    spans = [(a[-1][1], b[0][1]) for a, b in zip(reps, reps[1:])]
    return {"n": len(reps), "phase": phase,
            "gaps": [hi - lo for lo, hi in spans], "idle_in": idle,
            "idle_between": sum(hi - lo - _busy(union, starts, lo, hi)
                                for lo, hi in spans),
            "count": count}


def read(ops, kind: str) -> dict | None:
    """The phase metrics of a traced window, ms (or operations) a step or
    chunk; None where the window holds no whole replay. Training:
    ``fwd_ms`` begin to out (every micro-batch's up, down and out),
    ``bwd_ms`` out to bwd, ``opt_ms`` bwd (or reduce) to opt, ``gap_ms``
    one replay's opt to the next one's begin, ``graph_idle_ms`` begin to
    opt less the device's busy time in it, ``kernels_per_step`` the
    device operations begin to opt. Eval: ``up_ms`` begin to up,
    ``down_ms`` up to down, ``out_ms`` down to end, ``gap_ms`` end to the
    next begin, ``kernels_per_chunk``."""
    sums = phase_sums(ops, kind)
    if sums is None:
        return None
    gaps, ms = sums["gaps"], 1e3 / sums["n"]

    def p(*names):
        return ms * sum(sums["phase"].get(x, 0.0) for x in names)

    gap = 1e3 * sum(gaps) / len(gaps) if gaps else None
    per = sums["count"] / sums["n"]
    if kind == "train":
        return {"fwd_ms.train": p("up", "down", "out"),
                "bwd_ms.train": p("bwd"), "opt_ms.train": p("opt"),
                "gap_ms.train": gap,
                "graph_idle_ms.train": ms * sums["idle_in"],
                "kernels_per_step.train": per}
    return {"up_ms.eval": p("up"), "down_ms.eval": p("down"),
            "out_ms.eval": p("out", "end"), "gap_ms.eval": gap,
            "kernels_per_chunk.eval": per}


def covered(ops, kind: str, units: int, window_s: float) -> float | None:
    """The phases of a replay (every interval, ``reduce`` included) plus
    the mean gap, times the window's steps or chunks, over the window."""
    sums = phase_sums(ops, kind)
    if sums is None or not sums["gaps"]:
        return None
    gaps = sums["gaps"]
    per = sum(sums["phase"].values()) / sums["n"] + sum(gaps) / len(gaps)
    return per * units / window_s


def with_program_spans(events):
    """``portbench.trace._events`` with the program's ``iaf.*`` host spans
    named as the harness's ranges, so that the window keeps them."""
    def wrapped(prof):
        return [("portbench." + n if not dev and n.startswith("iaf.") else n,
                 dev, s, e) for n, dev, s, e in events(prof)]
    return wrapped


def host_us(n: int = 200_000) -> dict[str, float]:
    """Host microseconds a call, with no profiler running: an empty loop,
    an empty ``span``, and a ``mark`` with marks off."""
    from iaf_torch.utils import trace
    prev = trace.set_marks(False)
    out = {}
    try:
        for what, body in (("loop", lambda: None),
                           ("mark_off", lambda: trace.mark("begin", "cuda"))):
            t = time.perf_counter()
            for _ in range(n):
                body()
            out[what] = 1e6 * (time.perf_counter() - t) / n
        t = time.perf_counter()
        for _ in range(n):
            with trace.span("iaf.cost"):
                pass
        out["span"] = 1e6 * (time.perf_counter() - t) / n
    finally:
        trace.set_marks(prev)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--marks", type=int, choices=(0, 1), default=1)
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from iaf_torch.utils import trace
    from portbench import cells, run, spec
    from portbench import trace as bench_trace
    trace.set_marks(bool(a.marks))
    kept = {}

    def keeping(fn):
        def kind(r):
            kept["out"] = fn(r)
            return kept["out"]
        return kind

    for k in list(cells.KINDS):
        cells.KINDS[k] = keeping(cells.KINDS[k])
    bench_trace._events = with_program_spans(bench_trace._events)
    rc = run.main(["--workload", a.workload, "--seed", str(a.seed),
                   "--seconds", str(a.seconds), "--trace", str(a.trace)])
    if rc or not a.trace:
        return rc
    out = kept["out"]
    kind = spec.cell(spec.benchmark(), a.workload)[2]["kind"]
    ops = out.trace.ops
    sums = phase_sums(ops, kind) or {"n": 0}
    print(json.dumps({
        "phases": read(ops, kind), "replays": sums["n"],
        "units": out.layer["units"],
        "covered": covered(ops, kind, out.layer["units"],
                           out.trace.window_s),
        "idle_s": {k: sums.get(k) for k in ("idle_in", "idle_between")},
        "window_idle_s": out.trace.window_s - out.trace.busy_s(),
        "host_us": host_us()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
