"""The traced window: torch.profiler (CUPTI) over a stretch of steady
work, reduced to device intervals, the union of their busy time, the
idle gaps labelled by what the harness was doing, and device time by
kernel class.

The profiler on that card has started recording late (a short window
missed its first launches), so the window opens with a pause, and a
window whose harness range holds no device operation is traced again
after a longer pause. Kernels replayed from CUDA graphs are recorded one
by one. Busy time is the union of the operations' intervals, never
their sum: overlapping kernels are busy time once.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
WINDOW = "portbench.window"


@dataclass
class Trace:
    """Device operations (name, class, start s, end s) inside the traced
    window, the window's length, and the harness's labelled host ranges
    (label, start s, end s), all on the trace's clock."""
    ops: list[tuple[str, str, float, float]]
    window_s: float
    ranges: list[tuple[str, float, float]] = field(default_factory=list)

    def busy_s(self) -> float:
        return sum(e - s for s, e in _union([(o[2], o[3]) for o in self.ops]))

    def class_s(self, *classes: str) -> float:
        return sum(o[3] - o[2] for o in self.ops if o[1] in classes)

    def by_name(self, top: int = 10) -> list[list]:
        tot: dict[str, float] = {}
        for name, _, s, e in self.ops:
            tot[name] = tot.get(name, 0.0) + (e - s)
        return [[n[:160], t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The idle time between device operations, summed by the label of
        the innermost harness range open when each gap began."""
        busy = _union([(o[2], o[3]) for o in self.ops])
        if not busy:
            return []
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        gaps = [(0.0, busy[0][0])] + gaps + [(busy[-1][1], self.window_s)]
        tot: dict[str, float] = {}
        for s, e in gaps:
            if e <= s:
                continue
            label = "untraced host work"
            best = None
            for name, rs, re in self.ranges:
                if rs <= s < re and (best is None or rs >= best):
                    label, best = name, rs
            tot[label] = tot.get(label, 0.0) + (e - s)
        return [[n, t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def classes() -> tuple[list[str], dict[str, list[str]]]:
    data = json.loads((HERE / "kernel_classes.json").read_text())
    return data["order"], data["classes"]


def classify(name: str, order=None, table=None) -> str:
    if order is None:
        order, table = classes()
    for cls in order:
        if any(p in name for p in table[cls]):
            return cls
    return "elementwise"


def _events(prof):
    """(name, is_device, start ns, end ns) of every recorded event. The
    device side of a host range (``record_function``: the harness's and
    the program's) is no device operation and is left out: its name is a
    host event's."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = e.start_us() * 1000, e.duration_us() * 1000
        annotation = getattr(e, "is_user_annotation", None)
        out.append((e.name(), e.device_type() == cuda, s, s + d,
                    bool(annotation()) if callable(annotation) else False))
    host = {n for n, dev, _, _, _ in out if not dev}
    return [(n, dev, s, e) for n, dev, s, e, ann in out
            if not (dev and (ann or n in host))]


@contextmanager
def label(name: str):
    """A harness range that names the host's work in the idle gaps."""
    with torch.profiler.record_function("portbench." + name):
        yield


def traced(fn, attempts: int = 3) -> tuple[Trace, object]:
    """Run ``fn()`` (which ends in a synchronise) under the profiler
    inside the harness range ``portbench.window``; returns the window's
    trace and ``fn``'s result. A window with no device operation is
    traced again (``fn`` must allow being run again)."""
    from torch.profiler import ProfilerActivity, profile
    order, table = classes()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05 * 4 ** attempt)
            with torch.profiler.record_function(WINDOW):
                result = fn()
                torch.cuda.synchronize()
        events = _events(prof)
        win = [(s, e) for n, dev, s, e in events if not dev and n == WINDOW]
        if not win:
            continue
        w0, w1 = win[0]
        ops = [(n, classify(n, order, table), (max(s, w0) - w0) / 1e9,
                (min(e, w1) - w0) / 1e9)
               for n, dev, s, e in events if dev and e > w0 and s < w1]
        ranges = [(n[len("portbench."):], (s - w0) / 1e9, (e - w0) / 1e9)
                  for n, dev, s, e in events
                  if not dev and n.startswith("portbench.") and n != WINDOW]
        if ops:
            return Trace(ops, (w1 - w0) / 1e9, ranges), result
    raise RuntimeError(f"{attempts} profiler windows recorded no device "
                       "operation")
