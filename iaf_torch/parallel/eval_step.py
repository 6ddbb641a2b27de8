"""Importance-weighted eval (``iaf_tpu/parallel/eval_step.py``).

The k samples are streamed in ``eval_k_chunk`` chunks with an online
(running max, rescaled sum-exp) logsumexp, so memory stays at B *
eval_k_chunk model replicas. Under a process group (``parallel/mesh.py``)
the k axis is sharded: every rank scores the whole batch with its k / N
samples, keyed as JAX's shards are (the step key folded with the rank,
then with the chunk index), and the ranks' (max, sum-exp) pairs are
combined: all-reduce MAX of the running max, then all-reduce SUM of
``s * exp(m - m_glob)``. With no group the key is folded with shard 0,
as on a one-shard mesh. ``make_batch_sharded_elbo`` is the path for a k
that the world size does not divide (the k = 1 plain ELBO): the batch is
sharded instead, each rank drawing its rows of the global noise.

``make_graphed_eval_step`` is the counterpart of the JAX package's
compiled step, whose chunk loop is a ``lax.scan``: the same step on fixed
buffers (the batch, one chunk's noise, the running max and sum-exp). On
the card the first chunk runs eagerly (the warm-up), the second is
captured as one CUDA graph of a chunk (the model's eval forward and the
running update) and every chunk from the second on is a replay of it
(``ops.Graphed``); before each chunk the host draws that chunk's noise
into its buffers (the family's ``draw_noise``, the bits the eager step
draws). The graph reads the parameters where they
live, so weights copied in place are seen by the next replay. On the CPU
the same body runs eagerly. The batch-sharded path stays eager.

A replay runs no Python, so the model's scope ranges show only in the
eager chunk and at the capture. The host's work around the replays is in
the spans ``iaf.eval.load`` (the batch in, the sums reset),
``iaf.eval.draw`` (a chunk's noise), ``iaf.eval.replay`` (a chunk's
graph; the eager chunk and the capture at the first two calls) and
``iaf.eval.bound``. With marks on (``utils.trace``) the chunk's graph
holds the device marks ``begin``, the model's ``up``, ``down`` and
``out``, and ``end`` after the running update.
"""

from __future__ import annotations

import itertools
import math
from typing import Mapping, Sequence

import torch

from iaf_torch import ops
from iaf_torch.core.config import Config
from iaf_torch.core.device import resolve_device
from iaf_torch.core.rng import fold
from iaf_torch.models import get_model
from iaf_torch.parallel import mesh
from iaf_torch.utils.params import param_device
from iaf_torch.utils.trace import mark, span


def k_chunking(k: int, eval_k_chunk: int) -> tuple[int, int]:
    """(chunk size, chunk count): the chunk is ``eval_k_chunk`` rounded
    down to a divisor of k."""
    k_chunk = min(k, max(1, eval_k_chunk))
    while k % k_chunk:
        k_chunk -= 1
    return k_chunk, k // k_chunk


def make_eval_step(cfg: Config, device="cuda", k: int | None = None):
    """Returns f(model, rng, batch, noise=None) -> per-example negative IW
    bound in nats, [B], for the config's model family; under a process
    group each rank draws k / world samples (k must divide) and every
    rank returns the combined bound. ``noise``, when given, holds one
    site-keyed noise dict per chunk of this rank's samples."""
    k = cfg.eval_k if k is None else k
    resolve_device(device)
    group, world = mesh.active(), mesh.world()
    if k % world:
        raise ValueError(f"k={k} does not shard over {world} ranks; "
                         "make_eval_setup takes the batch-sharded path")
    k_chunk, n_chunks = k_chunking(k // world, cfg.eval_k_chunk)
    apply_fn = get_model(cfg).apply_fn

    def step(model: torch.nn.Module, rng: int, batch,
             noise: Sequence[Mapping[str, torch.Tensor]] | None = None):
        rng_shard = fold(rng, mesh.rank())
        with torch.inference_mode():
            n = len(batch)
            dev = param_device(model)
            m_run = torch.full((n,), -math.inf, device=dev)
            s_run = torch.zeros((n,), device=dev)
            for i in range(n_chunks):
                out = apply_fn(
                    cfg, model, fold(rng_shard, i), batch, mode="eval",
                    k=k_chunk, noise=None if noise is None else noise[i])
                m_run, s_run = _running_update(
                    m_run, s_run, out.log_w.reshape(n, k_chunk))
            return _bound(m_run, s_run, k, group)

    return step


def _running_update(m_run, s_run, log_w):
    """One chunk's [B, k_chunk] log-weights folded into the running max and
    rescaled sum-exp."""
    m_new = torch.maximum(m_run, torch.amax(log_w, dim=1))
    s_new = (s_run * torch.exp(m_run - m_new)
             + torch.sum(torch.exp(log_w - m_new[:, None]), dim=1))
    return m_new, s_new


def _bound(m_run, s_run, k: int, group: bool) -> torch.Tensor:
    """The negative IW bound from the running (max, sum-exp) pair, the
    ranks' pairs combined first under a group."""
    if group:
        m_glob = mesh.all_reduce_(m_run.clone(), "max")
        s_run = mesh.all_reduce_(s_run * torch.exp(m_run - m_glob))
        m_run = m_glob
    return -(torch.log(s_run) + m_run - math.log(float(k)))


class EvalStep:
    """``make_graphed_eval_step``'s step: ``step(model, rng, batch,
    noise=None) -> [B] nats``, the bits of ``make_eval_step``'s on the
    same arguments. Every batch has the first one's shape (a Bernoulli
    config's batch buffer is f32, the 0/255 pixels exact in it). A graph
    belongs to the tensors it was captured on: a model whose parameters
    or buffers live elsewhere (another model, or tensors replaced rather
    than copied into) is warmed up and captured afresh. ``close``
    releases the graph, its memory pool and the buffers. A capture or a
    replay that fails raises; nothing falls back to the eager step."""

    def __init__(self, cfg: Config, device="cuda", k: int | None = None):
        self.cfg, self.k = cfg, cfg.eval_k if k is None else k
        self.device = resolve_device(device)
        world = mesh.world()
        if self.k % world:
            raise ValueError(f"k={self.k} does not shard over {world} "
                             "ranks; make_eval_setup takes the "
                             "batch-sharded path")
        self.k_chunk, self.n_chunks = k_chunking(self.k // world,
                                                 cfg.eval_k_chunk)
        self.family = get_model(cfg)
        self._group = mesh.active()
        self._model = None
        self._tensors: list[int] = []
        self._batch: torch.Tensor | None = None
        self._noise: dict[str, torch.Tensor] = {}
        self._m = self._s = None
        self._graph: ops.Graphed | None = None

    def _bind(self, model: torch.nn.Module) -> None:
        """Drop the graph unless ``model``'s tensors are the captured
        ones."""
        if param_device(model) != self.device:
            raise ValueError(f"model is on {param_device(model)}, this "
                             f"step on {self.device}")
        ptrs = [t.data_ptr() for t in itertools.chain(model.parameters(),
                                                       model.buffers())]
        if model is not self._model or ptrs != self._tensors:
            self._model, self._tensors = model, ptrs
            self._graph = ops.Graphed(self.device)

    def _load(self, batch) -> None:
        """The batch copied into its buffer (made at the first batch) and
        the running sums reset."""
        batch = torch.as_tensor(batch)
        if self._batch is None:
            dtype = (torch.float32 if self.cfg.likelihood == "bernoulli"
                     else batch.dtype)
            self._batch = torch.empty(batch.shape, dtype=dtype,
                                      device=self.device)
            shapes = self.family.noise_shapes(
                self.cfg, batch.shape[0] * self.k_chunk)
            self._noise = {site: torch.empty(shape, device=self.device)
                           for site, shape in shapes.items()}
            self._m = torch.empty(batch.shape[0], device=self.device)
            self._s = torch.empty(batch.shape[0], device=self.device)
        if batch.shape != self._batch.shape:
            raise ValueError(f"batch of shape {tuple(batch.shape)}; this "
                             f"step's buffers hold "
                             f"{tuple(self._batch.shape)}")
        self._batch.copy_(batch, non_blocking=True)
        self._m.fill_(-math.inf)
        self._s.zero_()

    def _draw(self, key: int, given) -> None:
        """One chunk's noise into the buffers: the draws for ``key``, or
        the injected dict's tensors."""
        if given is None:
            self.family.draw_noise(self.cfg, key, self._noise)
            return
        for site, buf in self._noise.items():
            src = torch.as_tensor(given[site])
            if tuple(src.shape) != tuple(buf.shape):
                raise ValueError(f"injected noise {site!r} has shape "
                                 f"{tuple(src.shape)}, want "
                                 f"{tuple(buf.shape)}")
            buf.copy_(src)

    def _chunk(self) -> None:
        """One chunk's eval forward on the buffers, folded into the running
        sums in place, between the device marks ``begin`` and ``end``."""
        mark("begin", self.device)
        out = self.family.apply_fn(self.cfg, self._model, 0, self._batch,
                                   mode="eval", k=self.k_chunk,
                                   noise=self._noise)
        m_new, s_new = _running_update(
            self._m, self._s, out.log_w.reshape(-1, self.k_chunk))
        self._m.copy_(m_new)
        self._s.copy_(s_new)
        mark("end", self.device)

    def __call__(self, model: torch.nn.Module, rng: int, batch,
                 noise: Sequence[Mapping[str, torch.Tensor]] | None = None
                 ) -> torch.Tensor:
        rng_shard = fold(rng, mesh.rank())
        with torch.inference_mode():
            self._bind(model)
            with span("iaf.eval.load"):
                self._load(batch)
            for i in range(self.n_chunks):
                with span("iaf.eval.draw"):
                    self._draw(fold(rng_shard, i),
                               None if noise is None else noise[i])
                with span("iaf.eval.replay"):
                    self._graph(self._chunk)
            with span("iaf.eval.bound"):
                return _bound(self._m, self._s, self.k, self._group)

    def close(self) -> None:
        """Release the graph, its private memory pool and the buffers."""
        self._graph = self._model = self._batch = self._m = self._s = None
        self._noise, self._tensors = {}, []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def make_graphed_eval_step(cfg: Config, device="cuda",
                           k: int | None = None) -> EvalStep:
    """``make_eval_step`` on fixed buffers: on the card a CUDA graph of
    one chunk, captured after an eager first chunk and replayed; the
    same body eagerly on the CPU."""
    return EvalStep(cfg, device, k)


def make_batch_sharded_elbo(cfg: Config, device="cuda", k: int = 1):
    """The batch-sharded eval (``make_batch_sharded_elbo``): returns
    f(model, rng, batch, noise=None) -> [B] nats, ``apply_fn``'s
    ``elbo_nats`` at k. Under a process group rank r scores its B / world
    images with its rows of the global noise (an injected ``noise`` dict
    is the global draw) and the ranks' results are gathered, so every
    rank returns all B."""
    resolve_device(device)
    world = mesh.world()
    apply_fn = get_model(cfg).apply_fn

    def step(model: torch.nn.Module, rng: int, batch,
             noise: Mapping[str, torch.Tensor] | None = None):
        n = len(batch)
        if n % world:
            raise ValueError(f"batch {n} does not shard over {world} ranks")
        per = n // world
        mine = batch[mesh.rank() * per:(mesh.rank() + 1) * per]
        with torch.inference_mode(), mesh.data_rows():
            out = apply_fn(cfg, model, rng, mine, mode="eval", k=k,
                           noise=noise)
            return mesh.all_gather(out.elbo_nats)

    return step
