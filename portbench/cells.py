"""The two kinds of traffic the benchmark drives: training steps and the
IW eval. Each kind sets up the program from the seed, measures a window
(or traces one), then, once the program's state is freed, checks what
the program produced against the plain reference.

The parameters of a kind come from its traffic file (``traffic/*.json``):

- ``train``: ``batch_size``, ``steps_per_dispatch``, ``log_every`` (the
  loop reads the loss every so many steps, waiting for it),
  ``images`` (the synthetic set's size), ``check_steps`` (the first
  steps, driven in set-up and followed by the reference),
  ``trace_steps`` (the traced window's steps).
- ``iw_eval``: ``batch_size`` images a batch, ``k`` importance samples,
  ``k_chunk`` samples an image a chunk, ``images``, ``check_per_half``
  (answers drawn for the reference from each half of every batch of the
  window), ``ref_block`` (rows of one reference forward),
  ``trace_batches``.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import inputs, judge, program
from portbench import reference as ref
from portbench.trace import label, traced


@dataclass
class Run:
    """One run of one cell."""
    workload: str
    c: dict                     # the configuration file's "config"
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float              # the process's start, host clock
    lines: list = field(default_factory=list)   # printed before the result

    def say(self, msg: str) -> None:
        self.lines.append(msg)


@dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: dict[str, float]       # end-to-end metrics (untraced runs)
    layer: dict                 # what the per-layer readers read
    numbers: dict[str, float]   # compared with the reference
    memory_peak_bytes: int
    trace: object = None


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN's convs and for matmuls: the reference's f32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    """The most memory the caching allocator held for the process since
    the last reset: a CUDA graph's private pool stays reserved between
    replays, so its blocks count whether or not a tensor holds them."""
    return torch.cuda.max_memory_reserved(device) \
        if device.type == "cuda" else 0


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _free(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Stamps:
    """Times between steps: CUDA events recorded on the stream after each
    step, which keep the host from waiting (on the CPU, which runs each
    step to its end, the host clock)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.stamp()

    def stamp(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


# ------------------------------------------------------------ training

def prog_parts(m: dict, i: int) -> torch.Tensor:
    """Step i's parts from the chunk's stacked metrics, in
    ``reference.parts_of``'s order."""
    return torch.cat([torch.stack([m["kl_obj"][i], m["kl_cost"][i],
                                   m["log_pxz"][i]]),
                      m["kl_per_layer"][i]]).detach().double().cpu()


class TrainSetup:
    """The program's training object driven from the seed through its
    first ``check_steps`` steps, with what the check needs of them."""

    def __init__(self, r: Run, builds: bool = True):
        c, t = r.c, r.traffic
        self.cfg = program.config(c, t)
        self.builds = program.build_kernels() \
            if builds and r.device.type == "cuda" else {}
        imgs = inputs.images(r.seed, t["images"], c["image_size"],
                             c["channels"])
        P0 = inputs.weights(c, r.seed, r.device)
        self.prog = program.Train(self.cfg, P0, imgs, r.seed, r.device)
        S = t["steps_per_dispatch"]
        if S != 1:
            raise ValueError("the check reads the optimizer's state after "
                             "the first step: steps_per_dispatch must be 1")
        self.noise = [inputs.NoiseStream(c, r.seed, "train",
                                         t["batch_size"], r.device)
                      for _ in range(S)]
        self.batches, self.readings = [], {"loss": [], "parts": []}
        if t["check_steps"] < 2:
            raise ValueError("the check reads the gradient of a replayed "
                             "step: check_steps must be 2 or more")
        t0 = time.perf_counter()
        first_s = m_before = None
        while self.prog.step < t["check_steps"]:
            if self.prog.step == t["check_steps"] - 1:
                # on the host: the window's memory peak is the program's
                m_before = {n: v.to("cpu", copy=True)
                            for n, v in self.prog.state.opt.m.items()}
            b = self.prog.next_batches()
            self.batches.extend(np.array(x) for x in b)
            m = self.run(b)
            for i in range(b.shape[0]):
                self.readings["loss"].append(float(m["loss"][i]))
                self.readings["parts"].append(prog_parts(m, i))
            if first_s is None:
                _sync(r.device)
                first_s = time.perf_counter() - t0
        # the last checked step's gradient, a graph replay's, as the
        # optimizer got it: m' = b1 m + (1 - b1) g
        b1 = c["beta1"]
        self.readings["grad"] = {
            n: float(torch.linalg.vector_norm(
                v.to("cpu").double() - b1 * m_before[n].double()))
            / (1.0 - b1) for n, v in self.prog.state.opt.m.items()}
        del m_before
        self.readings["change"], self.readings["ema"] = _changes(
            self.prog.named(), self.prog.state.opt.ema,
            inputs.weights(c, r.seed, r.device))
        _sync(r.device)
        r.say(f"[setup] first step {first_s:.3f} s (eager, then the "
              "capture; Triton compiles here on a cold run), "
              f"{t['check_steps']} checked steps")

    def run(self, b: np.ndarray):
        eps = [s.draw(self.prog.step + i) for i, s in
               enumerate(self.noise[:b.shape[0]])]
        return self.prog.run(b, eps)


def _changes(params, ema, P0) -> tuple[dict, dict]:
    with torch.no_grad():
        return (judge.norms({n: p - P0[n] for n, p in params.items()}),
                judge.norms({n: e - P0[n] for n, e in ema.items()}))


def train_reference(c: dict, seed: int, batches: list, steps: int,
                    device, quant=None, rows=None) -> dict:
    """The reference's readings over the first ``steps`` batches, with the
    same weights and draws, in f32 with TF32 off."""
    B = batches[0].shape[0]
    noise = inputs.NoiseStream(c, seed, "train", B, device)
    draws = [[v.clone() for v in noise.draw(s)] for s in range(steps)]
    P0 = inputs.weights(c, seed, device)
    xb = [torch.from_numpy(b).to(device) for b in batches[:steps]]
    with full_f32():
        out = ref.train_steps(c, P0, xb, draws, quant=quant, rows=rows)
    change, ema = _changes(out["params"], out["ema"], P0)
    return {"loss": out["loss"], "parts": out["parts"],
            "grad": judge.norms(out["grad"]), "change": change, "ema": ema}


def run_train(r: Run) -> Outcome:
    t = r.traffic
    s = TrainSetup(r)
    prog, dev, B = s.prog, r.device, t["batch_size"]
    for name, secs in s.builds.items():
        r.say(f"[setup] nvcc {name}.cu {secs:.1f} s")
    log_every = t["log_every"]
    losses: list[torch.Tensor] = []

    def step(read_loss: bool = True):
        with label("feed"):
            b = prog.next_batches()
        with label("step"):
            m = s.run(b)
        losses.append(m["loss"])
        if read_loss and prog.step % log_every < b.shape[0]:
            with label("loss_read"):
                float(m["loss"][-1])      # the loop's log read waits
        return b.shape[0]

    _sync(dev)
    setup_peak = _peak(dev)
    _reset_peak(dev)
    layer, e2e, tr = {}, {}, None
    if r.trace:
        prog.feed_wait = 0.0

        def window():
            n = 0
            while n < t["trace_steps"]:
                n += step()
            return n

        tr, n = traced(window)
        attempted = n
        layer = {"units": n, "samples": n * B, "window_s": tr.window_s,
                 "feed_wait_s": prog.feed_wait}
        r.say(f"[window] traced {n} steps in {tr.window_s:.3f} s")
    else:
        setup_s = time.time() - r.t_start
        prog.feed_wait = 0.0
        clock = Stamps(dev)
        t0 = time.perf_counter()
        n = 0
        while True:
            n += step()
            clock.stamp()
            if time.perf_counter() - t0 >= r.seconds:
                break
        _sync(dev)
        wall = time.perf_counter() - t0
        step_ms = clock.intervals_ms()
        attempted = n
        e2e = {"train_examples_per_s": n * B / wall, "setup_s": setup_s}
        r.say(f"[window] {n} steps, {n * B} images in {wall:.3f} s; step "
              f"ms (CUDA events) median {float(np.median(step_ms)):.3f}, "
              f"p95 {float(np.percentile(step_ms, 95)):.3f}, max "
              f"{max(step_ms):.3f}; feed wait "
              f"{1e3 * prog.feed_wait / n:.4f} ms a step")
    window_peak = _peak(dev)
    e2e_peak = window_peak / 2 ** 30
    if not r.trace:
        e2e["peak_mem_gib"] = e2e_peak
    failed = int((~torch.isfinite(torch.cat(losses))).sum())
    batches, readings = s.batches, s.readings
    prog.close()
    del s, prog
    _free(dev)
    t_ref = time.perf_counter()
    ref_r = train_reference(r.c, r.seed, batches, t["check_steps"], dev)
    r.say(f"[check] the reference's {t['check_steps']} steps "
          f"{time.perf_counter() - t_ref:.1f} s")
    numbers = judge.train_numbers(readings, ref_r)
    return Outcome(attempted, failed, e2e, layer, numbers,
                   max(setup_peak, window_peak), tr)


# ------------------------------------------------------------- IW eval

class EvalSetup:
    """The program's IW eval, warmed up on one whole batch (its eager
    first chunk and the capture), and the batches' draws."""

    def __init__(self, r: Run, builds: bool = True):
        c, t = r.c, r.traffic
        self.r = r
        self.cfg = program.config(c, t)
        self.builds = program.build_kernels() \
            if builds and r.device.type == "cuda" else {}
        self.images = inputs.images(r.seed, t["images"], c["image_size"],
                                    c["channels"])
        P = inputs.weights(c, r.seed, r.device)
        self.prog = program.Eval(self.cfg, P, r.device)
        del P
        self.bs, self.k = t["batch_size"], t["k"]
        self.noise = inputs.NoiseStream(c, r.seed, "eval",
                                        self.bs * self.prog.step.k_chunk,
                                        r.device)
        t0 = time.perf_counter()
        self.batch(0)
        r.say(f"[setup] warm-up batch {time.perf_counter() - t0:.3f} s "
              "(eager first chunk, the capture, replays)")

    def batch_images(self, b: int) -> np.ndarray:
        n = len(self.images) // self.bs
        i = b % n
        return self.images[i * self.bs:(i + 1) * self.bs]

    def draws(self, b: int):
        n = self.prog.n_chunks
        return lambda ch: self._draw(b * n + ch)

    def _draw(self, index: int):
        with label("noise"):
            return self.noise.draw(index)

    def batch(self, b: int) -> torch.Tensor:
        return self.prog.run(inputs.key(self.r.seed, "batch", b),
                             self.batch_images(b), self.draws(b))


def eval_reference(c: dict, seed: int, picks: list[tuple[int, int]],
                   images: list[np.ndarray], bs: int, k: int, k_chunk: int,
                   block: int, device, quant=None) -> torch.Tensor:
    """The reference's bound for each picked (batch, image) with the
    program's draws for it: image i of batch b took rows i*k_chunk ..
    of every chunk of batch b."""
    n_chunks = k // k_chunk
    noise = inputs.NoiseStream(c, seed, "eval", bs * k_chunk, device)

    def eps_rows(j, lo, hi):
        b, i = picks[j]
        parts = [[] for _ in range(ref.n_layers(c))]
        for s in range(lo, hi, k_chunk):
            views = noise.draw(b * n_chunks + s // k_chunk)
            for layer, v in enumerate(views):
                parts[layer].append(v[i * k_chunk:(i + 1) * k_chunk].clone())
        return [torch.cat(p) for p in parts]

    P = inputs.weights(c, seed, device)
    x = torch.from_numpy(np.stack(images)).to(device)
    with full_f32():
        return ref.iw_nll(c, P, x, eps_rows, k, block, quant=quant)


def pick(seed: int, batches: list[int], bs: int, per_half: int
         ) -> list[tuple[int, int]]:
    """(batch, image) answers of the window, drawn from the seed:
    ``per_half`` from each half of every batch, so that a batch computed
    only in part shows in every run."""
    rng = np.random.default_rng(inputs.key(seed, "check"))
    out = []
    for b in batches:
        for lo, hi in ((0, bs // 2), (bs // 2, bs)):
            n = min(per_half, hi - lo)
            out += [(b, lo + int(i)) for i in
                    sorted(rng.choice(hi - lo, size=n, replace=False))]
    return out


def run_eval(r: Run) -> Outcome:
    t = r.traffic
    s = EvalSetup(r)
    prog, dev = s.prog, r.device
    for name, secs in s.builds.items():
        r.say(f"[setup] nvcc {name}.cu {secs:.1f} s")
    answers: dict[int, torch.Tensor] = {}
    per_batch = s.bs * s.k
    _sync(dev)
    setup_peak = _peak(dev)
    _reset_peak(dev)
    layer, e2e, tr = {}, {}, None
    if r.trace:
        def window():
            start = len(answers) + 1
            for b in range(start, start + t["trace_batches"]):
                with label("eval_batch"):
                    answers[b] = s.batch(b)
            return t["trace_batches"]

        tr, nb = traced(window)
        attempted = nb * s.bs
        layer = {"units": nb * prog.n_chunks, "samples": nb * per_batch,
                 "window_s": tr.window_s, "feed_wait_s": 0.0}
        answers = {b: answers[b] for b in sorted(answers)[-nb:]}
        r.say(f"[window] traced {nb} batches, {nb * prog.n_chunks} chunks "
              f"in {tr.window_s:.3f} s")
    else:
        e2e["setup_s"] = time.time() - r.t_start
        t0 = time.perf_counter()
        times = []
        b = 1
        while time.perf_counter() - t0 < r.seconds:
            tb = time.perf_counter()
            answers[b] = s.batch(b)
            times.append(time.perf_counter() - tb)
            b += 1
        wall = time.perf_counter() - t0
        nb = len(answers)
        attempted = nb * s.bs
        e2e["iw_samples_per_s"] = nb * per_batch / wall
        r.say(f"[window] {nb} batches, {nb * prog.n_chunks} chunks, "
              f"{nb * per_batch} importance samples in {wall:.3f} s; "
              f"batch s {', '.join(f'{x:.3f}' for x in times)}")
    window_peak = _peak(dev)
    if not r.trace:
        e2e["peak_mem_gib"] = window_peak / 2 ** 30
    got = torch.cat([answers[b] for b in sorted(answers)])
    failed = int((~torch.isfinite(got)).sum())
    picks = pick(r.seed, sorted(answers), s.bs, t["check_per_half"])
    images = [s.batch_images(b)[i] for b, i in picks]
    prog_nll = torch.stack([answers[b][i] for b, i in picks])
    k_chunk = prog.step.k_chunk
    prog.close()
    del s, prog
    _free(dev)
    t_ref = time.perf_counter()
    ref_nll = eval_reference(r.c, r.seed, picks, images, t["batch_size"],
                             t["k"], k_chunk, t["ref_block"], dev)
    r.say(f"[check] the reference's {len(picks)} answers "
          f"{time.perf_counter() - t_ref:.1f} s")
    r.say("[check] answers (batch, image, program nats, reference nats): "
          + "; ".join(f"{b} {i} {float(p):.4f} {float(q):.4f}"
                      for (b, i), p, q in zip(picks, prog_nll, ref_nll)))
    numbers = judge.eval_numbers(prog_nll, ref_nll)
    if math.isnan(numbers["nll"]):
        numbers["nll"] = float("inf")
    return Outcome(attempted, failed, e2e, layer, numbers,
                   max(setup_peak, window_peak), tr)


KINDS = {"train": run_train, "iw_eval": run_eval}


@dataclass
class Reading:
    """What a per-layer metric's reader reads: the configuration, the
    traffic, the traced window (``trace``: device operations by class),
    the steps or chunks it held (``units``), the importance samples or
    images it processed (``samples``), its host-clock length and the
    harness's wait on the data feed."""
    c: dict
    traffic: dict
    out: Outcome

    @property
    def trace(self):
        return self.out.trace

    @property
    def units(self) -> int:
        return self.out.layer["units"]

    @property
    def samples(self) -> int:
        return self.out.layer["samples"]

    @property
    def window_s(self) -> float:
        return self.out.layer["window_s"]

    @property
    def feed_wait_s(self) -> float:
        return self.out.layer["feed_wait_s"]
