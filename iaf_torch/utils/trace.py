"""The port's tracing: host spans on the profiler's clock and device marks
inside the captured CUDA graphs.

- ``span(name)``: a host range (``torch.profiler.record_function``), in a
  ``torch.profiler`` trace beside the device's work. The JAX package's
  scope names (``iaf_up``, ``iaf_down``, ``ar_stack``, ``grads``,
  ``adamax_polyak``) and the port's own host work around a replay
  (``iaf.train.load``, ``iaf.train.replay``, ``iaf.train.stack``,
  ``iaf.eval.load``, ``iaf.eval.draw``, ``iaf.eval.replay``,
  ``iaf.eval.bound``). A replay runs no Python, so the scope ranges show
  only in eager bodies and at the capture; the ``iaf.*`` spans show at
  every step.
- ``mark(name, device)``: with marks on, one launch of an empty Triton
  kernel named ``iaf_mark_<name>`` on the current stream of a CUDA
  ``device``. Launched inside a captured body it is a node of the graph,
  so every replay runs it, and a device trace shows by kernel name where
  each phase of a replayed step begins. The interval from one mark to the
  next belongs to the later mark's phase. A training step issues
  ``begin``, then per micro-batch ``up`` (the encoder and the up passes),
  ``down`` (the down passes and the KL stack), ``out`` (decoder,
  likelihood, loss) and ``bwd`` (its backward), then ``reduce`` (under a
  process group) and ``opt`` (K5 and its tail); an eval chunk ``begin up
  down out end`` (``end``: the running update). The MNIST family's
  forward issues ``out`` alone.

Marks are off by default; ``set_marks`` turns them on for the process
(the CLI does so with ``--profile_dir``). The switch is read as a body
runs, so a graph holds the marks that were on at its capture: with marks
off no kernel is built, launched or captured. A mark inside a
``torch.export`` or ``torch.compile`` trace issues nothing, and on the
CPU nothing launches.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch
from torch.profiler import record_function

MARKS = ("begin", "up", "down", "out", "bwd", "reduce", "opt", "end")
PREFIX = "iaf_mark_"

_marks = False


def set_marks(on: bool) -> bool:
    """Device marks on or off for the process; returns the previous
    setting. Graphs captured before keep what they hold."""
    global _marks
    prev, _marks = _marks, bool(on)
    return prev


def span(name: str) -> contextlib.AbstractContextManager:
    """A host range named ``name`` on the profiler's clock; where no
    profiler runs, an empty context (a ``record_function`` costs ~12 µs
    of host time even then)."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return record_function(name)


def mark(name: str, device) -> None:
    """The device mark ``iaf_mark_<name>`` on ``device``'s current stream,
    where marks are on (nothing otherwise)."""
    if not _marks or torch.compiler.is_compiling():
        return
    if name not in MARKS:
        raise ValueError(f"unknown mark {name!r}; marks are {MARKS}")
    _launch(name, torch.device(device))


def _launch(name: str, device: torch.device) -> None:
    if device.type == "cuda":
        _kernels()[name][(1,)](num_warps=1)


@functools.cache
def _kernels() -> dict:
    """One empty one-program Triton kernel per mark, compiled at its first
    launch (the eager step before a capture)."""
    from iaf_torch.ops import _build
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_DIR / "triton"))
    import triton

    @triton.jit
    def iaf_mark_begin():
        pass

    @triton.jit
    def iaf_mark_up():
        pass

    @triton.jit
    def iaf_mark_down():
        pass

    @triton.jit
    def iaf_mark_out():
        pass

    @triton.jit
    def iaf_mark_bwd():
        pass

    @triton.jit
    def iaf_mark_reduce():
        pass

    @triton.jit
    def iaf_mark_opt():
        pass

    @triton.jit
    def iaf_mark_end():
        pass

    return dict(zip(MARKS, (iaf_mark_begin, iaf_mark_up, iaf_mark_down,
                            iaf_mark_out, iaf_mark_bwd, iaf_mark_reduce,
                            iaf_mark_opt, iaf_mark_end), strict=True))
