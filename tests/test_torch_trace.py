"""The port's tracing (``iaf_torch/utils/trace.py``) on the CPU: with marks
off a training step and an eval chunk issue no device mark; with marks on
they issue the documented sequences (``grad_accum=2``: two forwards and
backwards; under a group ``reduce``; the MNIST family ``out`` alone), a
mark issues nothing inside ``torch.export``; the phase readers of
``tools/trace_phases.py`` on synthetic traces, each exact, None without
marks; the benchmark's idle gaps labelled by the innermost program span.
On the card (``cuda``): a graph captured with marks on shows each mark
once per replay by name in a profiler trace, one captured with marks off
none."""

import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from iaf_torch.core.config import Config
from iaf_torch.models import cvae
from iaf_torch.models import mnist_vae as mv
from iaf_torch.parallel import eval_step, mesh
from iaf_torch.parallel import train_step as ts
from iaf_torch.utils import trace
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[1]
CIFAR = ("image_size=8,z_size=4,h_size=8,depth=1,num_blocks=2,depth_ar=2,"
         "compute_dtype=float32,batch_size=4,eval_k=4,eval_k_chunk=2")
MNIST = dict(image_size=8, z_size=4, h_size=8, ar_hidden_size=16,
             depth_ar=2, compute_dtype="float32", batch_size=4, eval_k=4,
             eval_k_chunk=2)
TRAIN = ["begin", "up", "down", "out", "bwd", "opt"]
CHUNK = ["begin", "up", "down", "out", "end"]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trace_phases", ROOT / "tools" / "trace_phases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def issued(monkeypatch):
    """The marks issued, in order (``_launch`` patched to record them)."""
    names = []
    monkeypatch.setattr(trace, "_launch",
                        lambda name, device: names.append(name))
    prev = trace.set_marks(False)
    yield names
    trace.set_marks(prev)


def _model(family: str, device="cpu", **kw):
    rs = np.random.RandomState(0)
    if family == "cifar":
        cfg = Config().parse(CIFAR).replace(**kw)
        x = rs.randint(0, 256, (4, 8, 8, 3)).astype(np.uint8)
        return cfg, x, cvae.init_params(cfg, x, rng=0, device=device)
    cfg = mv.mnist_config(**MNIST).replace(**kw)
    x = (rs.rand(8, 8, 8, 1) > 0.6).astype(np.uint8) * 255
    return cfg, x[:4], mv.init_params(cfg, x, rng=0, device=device)


def _train(family: str, device="cpu", group: bool = False, **kw):
    """A training step (``make_train_step``) and its batch."""
    cfg, x, model = _model(family, device, **kw)
    state = ts.TrainState(model, ts.optim.init_state(
        dict(model.named_parameters())))
    step = ts.make_train_step(cfg, state)
    step._group = group
    return step, state, x


def _eval(family: str, device="cpu"):
    cfg, x, model = _model(family, device)
    return eval_step.make_graphed_eval_step(cfg, device), model, x


def test_marks_off_issue_nothing(issued):
    """Off by default: a training step and a two-chunk eval issue no
    mark."""
    step, state, x = _train("cifar")
    step(state, 3, x)
    fn, model, x = _eval("cifar")
    fn(model, 3, x)
    assert fn.n_chunks == 2
    assert issued == []


@pytest.mark.parametrize("case,want", [
    ("train", TRAIN),
    ("train_accum2", ["begin"] + ["up", "down", "out", "bwd"] * 2 + ["opt"]),
    ("train_group", ["begin", "up", "down", "out", "bwd", "reduce", "opt"]),
    ("train_eager", TRAIN),
    ("eval", CHUNK * 2),
    ("mnist_train", ["begin", "out", "bwd", "opt"]),
    ("mnist_eval", ["begin", "out", "end"] * 2),
])
def test_marks_on_issue_the_documented_sequence(issued, monkeypatch, case,
                                                want):
    """With marks on: a step ``begin``, per micro-batch ``up down out
    bwd``, ``reduce`` under a group, ``opt``; the eager ``train_step``
    the same; an eval chunk ``begin up down out end``; the MNIST family's
    forward ``out`` alone."""
    family = "mnist" if case.startswith("mnist") else "cifar"
    monkeypatch.setattr(mesh, "all_reduce_", lambda t, op="sum": t)
    trace.set_marks(True)
    if case.endswith("eval"):
        fn, model, x = _eval(family)
        issued.clear()     # the init's forward issues nothing; be sure
        fn(model, 3, x)
    else:
        step, state, x = _train(
            family, group=case == "train_group",
            grad_accum=2 if case == "train_accum2" else 1)
        issued.clear()
        if case == "train_eager":
            ts.train_step(step.cfg, state, 3, x)
        else:
            step(state, 3, x)
    assert issued == want


def test_mark_checks_its_name_and_the_switch_restores(issued):
    trace.set_marks(True)
    with pytest.raises(ValueError, match="unknown mark"):
        trace.mark("fwd", "cpu")
    assert trace.set_marks(False) is True
    trace.mark("fwd", "cpu")       # off: nothing is checked or issued
    assert issued == [] and trace.set_marks(False) is False


def test_span_is_a_range_only_under_a_profiler():
    """With no profiler running a span is an empty context (a
    ``record_function`` costs host time even then); under one it is a
    named range in the trace."""
    from torch.profiler import ProfilerActivity, profile
    assert not isinstance(trace.span("iaf.test"),
                          torch.profiler.record_function)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("iaf.test"):
            torch.ones(2).sum()
    assert "iaf.test" in {e.name for e in prof.events()}


def test_mark_issues_nothing_inside_export(issued):
    """A ``torch.export`` trace of a forward records no mark (the exported
    artifacts stay the kernels' alone)."""
    class M(torch.nn.Module):
        def forward(self, x):
            trace.mark("out", x.device)
            return x * 2

    trace.set_marks(True)
    torch.export.export(M(), (torch.ones(2),), strict=False)
    assert issued == []
    M()(torch.ones(2))
    assert issued == ["out"]


# ------------------------------------------------ the phase readers

def _op(name, s, e, cls="elementwise"):
    return (name, cls, s, e)


def _mk(name, t):
    return _op("iaf_mark_" + name, t, t)


def _train_trace():
    """Two replays of a step, 10 s apart: marks at begin 0, up 1, down 2,
    out 3, bwd 6, opt 7 (+10 s for the second); kernels busy [0, 0.5] +
    [1, 2.5] + [3, 6] + [6.5, 7] in each; the window 0-20 s."""
    ops = []
    for base in (0.0, 10.0):
        for name, t in zip(TRAIN, (0, 1, 2, 3, 6, 7)):
            ops.append(_mk(name, base + t))
        for s, e in ((0.0, 0.5), (1.0, 2.5), (3.0, 6.0), (6.5, 7.0)):
            ops.append(_op("k", base + s, base + e))
    ops.append(_op("copy", 8.0, 8.2, "memory"))    # in the gap
    return ops


@pytest.mark.parametrize("kind", ["train", "iw_eval"])
def test_phase_readers_are_exact_on_a_synthetic_trace(kind):
    tool = _tool()
    if kind == "train":
        got = tool.read(_train_trace(), "train")
        # busy inside [0, 7]: 0.5 + 1.5 + 3 + 0.5
        assert got == pytest.approx({
            "fwd_ms.train": 3000.0, "bwd_ms.train": 3000.0,
            "opt_ms.train": 1000.0, "gap_ms.train": 3000.0,
            "graph_idle_ms.train": 1500.0,
            "kernels_per_step.train": 4.0})
        assert tool.covered(_train_trace(), "train", 2, 20.0) == \
            pytest.approx(1.0)
        sums = tool.phase_sums(_train_trace(), "train")
        assert (sums["idle_in"], sums["idle_between"]) == \
            pytest.approx((3.0, 2.8))     # 1.5 a replay; 3 less the copy
    else:
        ops = []
        for base in (0.0, 4.0, 8.0):
            for name, t in zip(CHUNK, (0.0, 1.0, 1.5, 2.0, 3.0)):
                ops.append(_mk(name, base + t))
            ops.append(_op("k", base + 0.1, base + 2.9))
        got = tool.read(ops, "iw_eval")
        assert got == pytest.approx({
            "up_ms.eval": 1000.0, "down_ms.eval": 500.0,
            "out_ms.eval": 1500.0, "gap_ms.eval": 1000.0,
            "kernels_per_chunk.eval": 1.0})
        assert tool.covered(ops, "iw_eval", 3, 12.0) == pytest.approx(1.0)


def test_phase_readers_leave_cut_replays_out_and_read_none_without_marks():
    tool = _tool()
    ops = _train_trace()
    # the window opened after the first replay's begin and up
    cut = [o for o in ops if not (o[0] in ("iaf_mark_begin", "iaf_mark_up")
                                  and o[2] < 5)]
    got = tool.read(cut, "train")
    assert got["fwd_ms.train"] == pytest.approx(3000.0)
    assert got["gap_ms.train"] is None
    assert tool.covered(cut, "train", 2, 20.0) is None
    plain = [o for o in ops if not o[0].startswith("iaf_mark_")]
    assert tool.read(plain, "train") is None
    assert tool.read(plain, "iw_eval") is None
    assert tool.read([], "train") is None


def test_idle_gaps_are_labelled_by_the_innermost_program_span():
    """The harness's ``Trace.idle_gaps`` with the program's spans kept (the
    tool's ``with_program_spans``): a gap opening inside ``step`` and
    inside the program's ``iaf.train.load`` goes to the latter; a trace
    with no ``iaf.*`` span reads as before."""
    tool = _tool()
    events = [("portbench.window", False, 0, 100),
              ("portbench.step", False, 10, 90),
              ("iaf.train.load", False, 11, 30),
              ("iaf.train.replay", False, 30, 80),
              ("kern", True, 5, 20), ("kern", True, 40, 60)]
    kept = tool.with_program_spans(lambda prof: events)(None)
    assert ("portbench.iaf.train.load", False, 11, 30) in kept
    assert tool.with_program_spans(lambda prof: events[:2] + events[4:])(
        None) == events[:2] + events[4:]
    ranges = [(n[len("portbench."):], s, e) for n, dev, s, e in kept
              if not dev and n.startswith("portbench.")
              and n != "portbench.window"]
    ops = [("kern", "elementwise", s, e) for n, dev, s, e in kept if dev]
    gaps = dict(Trace(ops, 100.0, ranges).idle_gaps())
    assert gaps == {"iaf.train.load": 20.0, "iaf.train.replay": 40.0,
                    "untraced host work": 5.0}
    no_spans = [r for r in ranges if not r[0].startswith("iaf.")]
    gaps = dict(Trace(ops, 100.0, no_spans).idle_gaps())
    assert gaps == {"step": 60.0, "untraced host work": 5.0}


# ------------------------------------------------------------ card

@pytest.mark.cuda
@pytest.mark.parametrize("on", [True, False])
def test_graph_holds_each_mark_once_per_replay_on_card(on):
    """A tiny CIFAR step and eval chunk on the card, captured with marks on
    (off): three replays each under the profiler show every mark of the
    documented sequence once per replay by its kernel's name (none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    from torch.profiler import ProfilerActivity, profile
    prev = trace.set_marks(on)
    try:
        step, state, x = _train("cifar", "cuda")
        fn, model, xe = _eval("cifar", "cuda")
        for _ in range(2):              # the eager step / chunk, captures
            step(state, 3, x)
            fn(model, 3, xe)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.2)             # the profiler can start late
            for _ in range(3):
                step(state, 3, x)
            torch.cuda.synchronize()
            for _ in range(3):
                fn(model, 3, xe)
            torch.cuda.synchronize()
        step.close()
        fn.close()
    finally:
        trace.set_marks(prev)
    cuda = torch.autograd.DeviceType.CUDA
    seen = sorted((e.start_ns(), e.name()) for e in
                  prof.profiler.kineto_results.events()
                  if e.device_type() == cuda
                  and e.name().startswith(trace.PREFIX))
    names = [n[len(trace.PREFIX):] for _, n in seen]
    assert names == ((TRAIN * 3 + CHUNK * 2 * 3) if on else [])
