"""The training step on one device (``iaf_tpu/parallel/train_step.py``).

``train_step`` is one eager step: the gradient of the train-mode loss
(autograd; on CUDA every AR net, IAF update and the likelihood run their
forward and backward kernels), then Adamax + Polyak over every parameter
(``optim.apply_updates``; K5 on CUDA). ``grad_accum`` A > 1 takes the
exact mean over A equal micro-batches, micro-batch a drawing its noise
from ``fold(rng, a)``.

``make_train_step`` and ``make_train_chunk`` are the counterparts of the
JAX package's compiled step and its ``steps_per_dispatch`` chunk. They run
the same step on fixed buffers: the batch, each posterior site's noise
and the gradients (one flat buffer, zeroed in place at the start of the
step; a parameter the loss does not reach keeps a zero gradient, as
``apply_updates`` and JAX count it). On the card the first step runs
eagerly (the warm-up: Triton compiles, the kernel libraries load, the
wrappers' caches fill and cuDNN picks its algorithms), is then captured
as one CUDA graph (forward, backward, K5 and the step count), and every
later step is a replay of it. Before each step the host draws that
step's noise into its buffers (the family's ``draw_noise``, the bits the
eager step draws) and copies its batch in, so the trajectory is the
eager loop's. On the CPU the same body runs eagerly at every step.

Both model families take this path (``models.get_model``): the model,
its noise sites and its metrics (``bits_per_dim`` and ``kl_per_layer``
for CIFAR, ``nll_nats`` for MNIST) come from the family.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from iaf_torch import ops, optim
from iaf_torch.core.config import Config
from iaf_torch.core.rng import fold
from iaf_torch.models import get_model
from iaf_torch.utils.params import param_device

Noise = Mapping[str, torch.Tensor]


class TrainState(NamedTuple):
    params: torch.nn.Module     # the family's ``Model``
    opt: optim.AdamaxState


def loss_fn(cfg: Config, params: torch.nn.Module, rng: int, batch,
            noise: Noise | None = None):
    out = get_model(cfg).apply_fn(cfg, params, rng, batch, mode="train",
                                  noise=noise)
    return out.loss, out


def _out_metrics(loss, out) -> dict[str, torch.Tensor]:
    """The logged metrics: the objective's parts, and the family's own
    (``bits_per_dim`` and ``kl_per_layer``, or ``nll_nats``)."""
    metrics = {"loss": loss.detach(), "kl_obj": out.kl_obj.detach(),
               "kl_cost": out.kl_cost.detach(),
               "log_pxz": out.log_pxz.detach()}
    for name in ("bits_per_dim", "nll_nats", "kl_per_layer"):
        if name in out._fields:
            metrics[name] = getattr(out, name).detach()
    return metrics


def _device_batch(batch, device: torch.device) -> torch.Tensor:
    """The images on ``device``; a numpy batch goes through pinned memory
    so the copy does not wait for the device's queue."""
    if torch.is_tensor(batch):
        return batch.to(device)
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _grads_and_metrics(cfg: Config, model: torch.nn.Module, rng: int, batch,
                       noise: Noise | Sequence[Noise] | None = None):
    """Mean gradients (None where the loss does not reach a parameter) and
    metrics over the batch, over ``cfg.grad_accum`` sequential micro-batches
    when it is above 1 (``noise`` is then one dict per micro-batch)."""
    for p in model.parameters():
        p.grad = None
    return _accumulate(cfg, model, rng, batch, noise)


def _accumulate(cfg: Config, model: torch.nn.Module, rng: int, batch,
                noise: Noise | Sequence[Noise] | None):
    """``_grads_and_metrics`` summing into the gradients as they are (None,
    or zeros)."""
    a_count = max(1, cfg.grad_accum)
    if a_count == 1:
        loss, out = loss_fn(cfg, model, rng, batch, noise)
        loss.backward()
        metrics = _out_metrics(loss, out)
    else:
        micro = _micro_batch(cfg, batch.shape[0])
        m_sum = None
        for a in range(a_count):
            loss, out = loss_fn(cfg, model, fold(rng, a),
                                batch[a * micro:(a + 1) * micro],
                                None if noise is None else noise[a])
            loss.backward()   # sums into .grad: g_0 + g_1 + ...
            m = _out_metrics(loss, out)
            m_sum = m if m_sum is None else {k: m_sum[k] + m[k] for k in m}
        metrics = {k: v / a_count for k, v in m_sum.items()}
        with torch.no_grad():
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(a_count)
    grads = {k: p.grad for k, p in model.named_parameters()}
    return grads, metrics


def _micro_batch(cfg: Config, n: int) -> int:
    a_count = max(1, cfg.grad_accum)
    if n % a_count:
        raise ValueError(f"batch {n} does not split into grad_accum="
                         f"{a_count} equal micro-batches")
    return n // a_count


def _apply_updates(cfg: Config, state: TrainState, grads) -> None:
    optim.apply_updates(
        dict(state.params.named_parameters()), grads, state.opt,
        lr=cfg.learning_rate, beta1=cfg.beta1, beta2=cfg.beta2,
        eps=cfg.adamax_eps, polyak_decay=cfg.polyak_decay,
        bias_correction=cfg.bias_correction, grad_clip=cfg.grad_clip)


def train_step(cfg: Config, state: TrainState, rng: int, batch,
               noise: Noise | Sequence[Noise] | None = None):
    """One eager step: returns (the state, updated in place, and the
    metrics as device tensors). ``noise`` injects posterior draws by
    site, as the family's ``apply_fn`` takes them."""
    model = state.params
    batch = _device_batch(batch, param_device(model))
    grads, metrics = _grads_and_metrics(cfg, model, rng, batch, noise)
    _apply_updates(cfg, state, grads)
    return state, metrics


class TrainStep:
    """``make_train_step``'s step on the fixed buffers of one training
    state: ``step(state, key, batch, noise=None) -> (state, metrics)``,
    the state updated in place. ``noise`` (one dict, or one per
    micro-batch) is copied into the noise buffers instead of the draws
    for ``key``. Every batch has the first one's shape; a Bernoulli
    config's batch buffer is f32 (as JAX's step takes it), the 0/255
    pixels exact in it. On the card the metrics are the graph's own
    output tensors, overwritten by the next step: copy them out before
    it.
    ``close`` releases the graph and its memory pool. A capture or a
    replay that fails raises; nothing falls back to the eager step."""

    def __init__(self, cfg: Config, state: TrainState):
        self.cfg, self.state = cfg, state
        self.family = get_model(cfg)
        self.device = param_device(state.params)
        params = list(state.params.parameters())
        self._grads = torch.zeros(sum(p.numel() for p in params),
                                  device=self.device)
        off = 0
        for p in params:
            p.grad = self._grads[off:off + p.numel()].view_as(p)
            off += p.numel()
        self._batch = None
        self._noise: list[dict[str, torch.Tensor]] = []
        self._graph = self._out = None
        self._per_replay: dict[str, int] = {}
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def _buffers(self, batch: torch.Tensor) -> None:
        """The batch and noise buffers, made at the first batch."""
        cfg = self.cfg
        dtype = (torch.float32 if cfg.likelihood == "bernoulli"
                 else batch.dtype)
        self._batch = torch.empty(batch.shape, dtype=dtype,
                                  device=self.device)
        rows = _micro_batch(cfg, batch.shape[0]) * max(1, cfg.k)
        shapes = self.family.noise_shapes(cfg, rows)
        self._noise = [{site: torch.empty(shape, device=self.device)
                        for site, shape in shapes.items()}
                       for _ in range(max(1, cfg.grad_accum))]

    def _load(self, key: int, batch, noise) -> None:
        batch = torch.as_tensor(batch)
        if self._batch is None:
            self._buffers(batch)
        if batch.shape != self._batch.shape:
            raise ValueError(f"batch of shape {tuple(batch.shape)}; this "
                             f"step's buffers hold "
                             f"{tuple(self._batch.shape)}")
        self._batch.copy_(batch, non_blocking=True)
        if noise is None:
            for a, bufs in enumerate(self._noise):
                self.family.draw_noise(self.cfg, key if len(self._noise) == 1
                                       else fold(key, a), bufs)
            return
        given = [noise] if len(self._noise) == 1 else noise
        for bufs, src in zip(self._noise, given, strict=True):
            for site, buf in bufs.items():
                buf.copy_(src[site])

    def _body(self) -> dict[str, torch.Tensor]:
        self._grads.zero_()
        noise = self._noise[0] if len(self._noise) == 1 else self._noise
        grads, metrics = _accumulate(self.cfg, self.state.params, 0,
                                     self._batch, noise)
        _apply_updates(self.cfg, self.state, grads)
        return metrics

    def _warm_up_and_capture(self) -> dict[str, torch.Tensor]:
        """The eager first step on the capture stream, then the capture
        (which runs nothing). The prefetch thread may run meanwhile: it
        calls no CUDA, and "thread_local" confines the capture's checks
        to this thread in any case."""
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            metrics = self._body()
        cur.wait_stream(self._stream)
        for t in metrics.values():
            t.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with ops.launches_apart() as seen:
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                self._out = self._body()
        self._graph, self._per_replay = graph, seen
        return metrics

    def __call__(self, state: TrainState, key: int, batch,
                 noise: Noise | Sequence[Noise] | None = None):
        if state is not self.state:
            raise ValueError("a TrainStep updates the state it was made "
                             "for")
        self._load(key, batch, noise)
        if self.device.type != "cuda":
            return state, self._body()
        if self._graph is None:
            return state, self._warm_up_and_capture()
        self._graph.replay()
        ops.add_launch_counts(self._per_replay)
        return state, self._out

    def close(self) -> None:
        """Release the graph, its private memory pool and the buffers."""
        self._out = self._graph = self._batch = None
        self._noise = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def make_train_step(cfg: Config, state: TrainState) -> TrainStep:
    """The step on ``state``'s fixed buffers: a CUDA graph replayed after
    an eager first step on the card, the same body eagerly on the CPU."""
    return TrainStep(cfg, state)


class TrainChunk:
    """``make_train_chunk``'s chunk: ``chunk(state, base_key, start_step,
    batches[n, B, ...], noise=None) -> (state, metrics stacked [n, ...])``,
    step i of the chunk on ``batches[i]`` with the key ``fold(base_key,
    start_step + i)`` (``noise``, if given, one per step), as the unchunked
    loop keys it. On the card the n steps are enqueued back to back (the
    batches through pinned memory) and the host does not wait for them."""

    def __init__(self, cfg: Config, state: TrainState):
        self.step = make_train_step(cfg, state)

    def __call__(self, state: TrainState, base_key: int, start_step: int,
                 batches, noise: Sequence | None = None):
        host = torch.as_tensor(np.ascontiguousarray(batches))
        if self.step.device.type == "cuda":
            host = host.pin_memory()
        n = host.shape[0]
        stacked: dict[str, torch.Tensor] = {}
        for i in range(n):
            state, metrics = self.step(state, fold(base_key, start_step + i),
                                       host[i],
                                       None if noise is None else noise[i])
            for k, v in metrics.items():
                if k not in stacked:
                    stacked[k] = torch.empty((n,) + v.shape, dtype=v.dtype,
                                             device=v.device)
                stacked[k][i].copy_(v)
        return state, stacked

    def close(self) -> None:
        self.step.close()


def make_train_chunk(cfg: Config, state: TrainState) -> TrainChunk:
    """Any number of steps per call on ``state`` (``steps_per_dispatch``
    and its tail), through one ``make_train_step``."""
    return TrainChunk(cfg, state)


def init_train_state(cfg: Config, rng: int, sample_batch,
                     device="cuda") -> TrainState:
    model = get_model(cfg).init_params(cfg, sample_batch, rng=rng,
                                       device=device)
    return TrainState(model,
                      optim.init_state(dict(model.named_parameters())))
