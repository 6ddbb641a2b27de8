"""Hand-written Hopper kernels, each with its plain twin.

On CUDA tensors the kernels always run; a twin serves CPU tensors (and the
tests) only. There is no switch between the two. Under autograd the
forward kernels are ``torch.autograd.Function``s whose backward is a
kernel too (on the CPU autograd differentiates the twins). Without grad
the forward wrappers of K1-K4 call torch ops, ``iaf::ar_stack``,
``iaf::masked_conv2d``, ``iaf::iaf_update`` and
``iaf::disc_logistic_logp`` (``torch.library``: the kernel for CUDA
tensors, the twin for CPU tensors, a fake for tracing), which
``torch.export`` records, so that an exported program launches the
kernels (``core/export.py``). Importing this package registers them.

- K1 ``ar_stack`` (CUDA C++, ``csrc/ar_stack.cu``; its forward spread
  over the card by ``ar_stack.fwd_plan``), twin ``ar_stack_ref``
  (``ar_stack_ref_pre`` with the hidden pre-activations);
  backward ``ar_stack_bwd`` (``csrc/ar_stack_bwd.cu``), twin
  ``ar_stack_bwd_ref``
- K2 ``masked_conv2d`` (CUDA C++, ``csrc/masked_conv.cu``), twin
  ``masked_conv2d_ref``; backward ``masked_conv2d_bwd``
  (``csrc/masked_conv_bwd.cu``), twin ``masked_conv2d_bwd_ref``
- K3 ``iaf_update`` (Triton), twin ``iaf_update_ref``; backward
  ``iaf_update_bwd``, twin ``iaf_update_bwd_ref``
- K4 ``disc_logistic_logp`` (CUDA C++, ``csrc/disc_logistic.cu``; each row
  split over ``dl_plan(rows, row_len)`` blocks of a cluster), twin
  ``disc_logistic_ref``; backward ``disc_logistic_bwd`` (the same source,
  one launch), twin ``disc_logistic_bwd_ref``
- K5 ``adamax_polyak`` (Triton, one launch over all leaves), twin
  ``adamax_polyak_ref``
- the IAF layer's inference glue around the trunk convs (Triton,
  ``glue.py``; torch ops ``iaf::elu_bf16``, ``iaf::residual_elu``,
  ``iaf::up_stats``, ``iaf::posterior``, ``iaf::kl_join``), twins
  ``elu_bf16_ref``, ``residual_elu_ref``, ``up_stats_ref``,
  ``posterior_ref``, ``kl_join_ref``; no backward

Each wrapper counts its launches (``launch_counts``). A replayed CUDA graph
runs no Python, so the launches its capture saw (``launches_apart``) are
added once per replay (``add_launch_counts``); ``Graphed`` does both for a
function replayed as one graph.
"""

import contextlib
import gc

import torch

from iaf_torch.ops import ar_stack as _ar_stack_mod
from iaf_torch.ops import fused as _fused_mod
from iaf_torch.ops import fused_adamax as _adamax_mod
from iaf_torch.ops import glue as _glue_mod
from iaf_torch.ops import masked_conv as _masked_conv_mod
from iaf_torch.ops.ar_stack import (  # noqa: F401
    ar_stack,
    ar_stack_bwd,
    ar_stack_bwd_ref,
    ar_stack_fits,
    ar_stack_ref,
    ar_stack_ref_pre,
    check_masks,
)
from iaf_torch.ops.fused import (  # noqa: F401
    disc_logistic_bwd,
    disc_logistic_bwd_ref,
    disc_logistic_logp,
    disc_logistic_ref,
    dl_plan,
    iaf_update,
    iaf_update_bwd,
    iaf_update_bwd_ref,
    iaf_update_ref,
)
from iaf_torch.ops.fused_adamax import (  # noqa: F401
    adamax_polyak,
    adamax_polyak_ref,
)
from iaf_torch.ops.glue import (  # noqa: F401
    elu_bf16,
    elu_bf16_ref,
    kl_join,
    kl_join_ref,
    posterior,
    posterior_ref,
    residual_elu,
    residual_elu_ref,
    up_stats,
    up_stats_ref,
)
from iaf_torch.ops.masked_conv import (  # noqa: F401
    masked_conv2d,
    masked_conv2d_bwd,
    masked_conv2d_bwd_ref,
    masked_conv2d_ref,
)

_COUNTERS = (_ar_stack_mod.launches, _masked_conv_mod.launches,
             _fused_mod.launches, _adamax_mod.launches, _glue_mod.launches)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {k: v for counts in _COUNTERS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` (name -> launches) to the counters."""
    for counters in _COUNTERS:
        for name in counters:
            counters[name] += counts.get(name, 0)


@contextlib.contextmanager
def launches_apart():
    """Leave the launches made inside the block out of the counters; the
    yielded dict holds them (name -> launches) when the block ends."""
    before = launch_counts()
    seen: dict[str, int] = {}
    try:
        yield seen
    finally:
        now = launch_counts()
        seen.update({k: now[k] - before[k] for k in now
                     if now[k] != before[k]})
        for counters in _COUNTERS:
            for name in counters:
                counters[name] = before[name]


class Graphed:
    """A call replayed from one CUDA graph on ``device``: ``graphed(fn)``,
    with the same ``fn`` (no arguments; it reads and writes tensors it
    holds) at every call. The first call runs ``fn`` eagerly on a side
    stream (the warm-up: builds, the wrappers' caches, library handles);
    the second captures it there ("thread_local" capture errors, the
    capture's launches kept out of the counters) and replays it; every
    later call replays the graph on the current stream and adds the
    capture's launches. So a run of one call captures nothing. On the
    CPU every call runs ``fn`` eagerly. A capture or a replay that fails
    raises. It keeps no reference to ``fn``, so an owner whose method
    ``fn`` is forms no reference cycle with it."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.graph = None
        self.per_replay: dict[str, int] = {}
        self._warm = False
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def __call__(self, fn) -> None:
        if self.device.type != "cuda":
            fn()
            return
        cur = torch.cuda.current_stream(self.device)
        if not self._warm:
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                fn()
            cur.wait_stream(self._stream)
            self._warm = True
            return
        if self.graph is None:
            # a dead graph that the collector frees inside the capture
            # would invalidate it (torch.cuda.graph no longer collects)
            gc.collect()
            graph = torch.cuda.CUDAGraph()
            with launches_apart() as seen:
                with torch.cuda.graph(graph, stream=self._stream,
                                      capture_error_mode="thread_local"):
                    fn()
            self.graph, self.per_replay = graph, seen
        self.graph.replay()
        add_launch_counts(self.per_replay)
