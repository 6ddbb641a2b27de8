"""The process group of data parallelism (``iaf_tpu/parallel/mesh.py —
make_mesh`` and ``iaf_tpu/train_lib.py — maybe_init_distributed``).

One process per GPU, launched as ``torchrun --nproc_per_node N -m
iaf_torch.cli ...``: rank, world size, local rank and the rendezvous
address come from the environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). ``init_distributed``
makes the group once: NCCL when the device is CUDA (the process's card
is ``cuda:LOCAL_RANK``, ``core.device.resolve_device``), gloo on the
CPU. Without ``WORLD_SIZE`` there is no group: ``rank()`` is 0,
``world()`` 1, and no collective is issued, so every path computes what
one process computes. ``WORLD_SIZE=1`` makes a group of one, whose
collectives change no bit.

The data axis is the group: ``cfg.batch_size`` is the global batch, each
rank takes ``batch_size / world`` rows of it, and a data-parallel step
equals one step on the whole batch (``parallel/train_step.py``). With
``grad_accum`` > 1 the step exchanges rows first: ``all_gather`` makes
the global batch on every rank, and each rank takes its part of every
micro-batch, as JAX reshards each micro-batch over the data axis. JAX's
``model`` axis, reserved and off by default there
(``iaf_tpu/parallel/mesh.py:27-33``), is not ported: no layer of either
package shards over it, and JAX's feed gives each process its own rows
(``iaf_tpu/data/feed.py — make_global_batch``), so a model axis across
processes (the only kind one process per card allows) has no meaning
the reference defines; ``mesh_model > 1`` raises, naming ROADMAP queue 1
item 4.
A fault in the group (it does not form, a collective fails) raises;
nothing falls back to one process.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from iaf_torch.core import rng


def requested() -> bool:
    """Whether the launcher asked for a group (``WORLD_SIZE`` is set)."""
    return "WORLD_SIZE" in os.environ


def active() -> bool:
    """Whether a process group exists (collectives are issued)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def init_distributed(device: torch.device) -> None:
    """Make the process group once, if the launcher asked for one: NCCL
    for a CUDA ``device`` (already the process's card and the current
    device, ``resolve_device``), gloo for the CPU. A later call checks
    that the group's backend serves ``device``."""
    if not requested():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if active():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()}; a "
                f"{device.type} entry point needs {backend}")
        return
    kw: dict[str, Any] = {}
    if backend == "nccl":
        # NCCL's communicator is bound to this card; with device_id it is
        # made at once, so a fault shows here
        kw["device_id"] = device
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kw)


def check_config(cfg) -> None:
    """``mesh_data`` must be 0 (all ranks) or the world size; the model
    axis (``mesh_model > 1``) is not ported."""
    if cfg.mesh_model > 1:
        raise NotImplementedError(
            f"mesh_model={cfg.mesh_model}: the model axis is not ported "
            "(ROADMAP queue 1, item 4); iaf_torch shards the data axis only")
    if cfg.mesh_data not in (0, world()):
        raise ValueError(f"mesh_data={cfg.mesh_data} but the process group "
                         f"has {world()} ranks (WORLD_SIZE); use 0 or "
                         f"{world()}")


def _comm_device() -> torch.device:
    """Where the group's tensors live: the current card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str) -> None:
    """Every rank waits here for the others (``name`` says where, for
    the reader of a hang; JAX's ``sync_global_devices(name)``)."""
    del name
    if active():
        dist.barrier()


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks in place (``"sum"`` or ``"max"``);
    returns ``t``. No group: ``t`` as it is."""
    if active():
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op])
    return t


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all) concatenated along dim 0, in
    rank order. No group: ``t``."""
    if not active():
        return t
    parts = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def all_gather_host(a: np.ndarray) -> np.ndarray:
    """``all_gather`` of a host array (through the group's device)."""
    if not active():
        return a
    t = torch.from_numpy(np.ascontiguousarray(a)).to(_comm_device())
    return all_gather(t).cpu().numpy()


def broadcast_values(values: Sequence) -> list:
    """Rank 0's small host values (picklable) on every rank."""
    values = list(values)
    if active():
        dist.broadcast_object_list(values, src=0, device=(
            _comm_device() if dist.get_backend() == "nccl" else None))
    return values


def broadcast_params_(module: torch.nn.Module) -> None:
    """Rank 0's parameters into every rank's ``module``, through one flat
    buffer."""
    if not active():
        return
    params = list(module.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params]).to(
        _comm_device())
    dist.broadcast(flat, src=0)
    off = 0
    with torch.no_grad():
        for p in params:
            p.copy_(flat[off:off + p.numel()].view_as(p))
            off += p.numel()


def global_means(local: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Each batch mean of ``local`` (this rank's rows; every rank has as
    many) as the global batch's, in one all-reduce: the value is the
    mean of the ranks' means, the gradient the local mean's, which the
    gradient all-reduce then averages into the global mean's gradient.
    Free bits clamps these (``cvae``, ``mnist_vae``). At world size 1
    every bit is the local one's."""
    stacked = torch.stack(list(local))
    glob = all_reduce_(stacked.detach().clone()).div_(world())
    out = stacked + (glob - stacked.detach())
    return list(out.unbind(0))


def data_rows():
    """The context in which each noise site's draw is this rank's rows of
    the global draw (``core.rng.rows_of``); no group: the whole draw."""
    if not active():
        return contextlib.nullcontext()
    return rng.rows_of(rank(), world())


def print0(*args, **kw) -> None:
    """``print`` on rank 0 only."""
    if rank() == 0:
        print(*args, **kw)
