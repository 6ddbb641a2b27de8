"""The training step on one device (``iaf_tpu/parallel/train_step.py``).

The gradient of the train-mode loss (autograd; on CUDA every AR net, IAF
update and the likelihood run their forward and backward kernels), then
Adamax + Polyak over every parameter (``optim.apply_updates``; K5 on
CUDA). ``grad_accum`` A > 1 takes the exact mean over A equal
micro-batches, micro-batch a drawing its noise from ``fold(rng, a)``.
``steps_per_dispatch`` (a TPU dispatch knob) is accepted and ignored; its
CUDA counterpart, a captured graph of the step, waits for a measurement
that shows it helps.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from iaf_torch import optim
from iaf_torch.core.config import Config
from iaf_torch.core.rng import fold
from iaf_torch.models import cvae

Noise = Mapping[str, torch.Tensor]


class TrainState(NamedTuple):
    params: cvae.CVAE
    opt: optim.AdamaxState


def loss_fn(cfg: Config, params: cvae.CVAE, rng: int, batch,
            noise: Noise | None = None):
    out = cvae.apply_fn(cfg, params, rng, batch, mode="train", noise=noise)
    return out.loss, out


def _out_metrics(loss, out) -> dict[str, torch.Tensor]:
    return {
        "loss": loss.detach(),
        "kl_obj": out.kl_obj.detach(),
        "kl_cost": out.kl_cost.detach(),
        "log_pxz": out.log_pxz.detach(),
        "bits_per_dim": out.bits_per_dim.detach(),
        "kl_per_layer": out.kl_per_layer.detach(),
    }


def _device_batch(batch, device: torch.device) -> torch.Tensor:
    """The images on ``device``; a numpy batch goes through pinned memory
    so the copy does not wait for the device's queue."""
    if torch.is_tensor(batch):
        return batch.to(device)
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _grads_and_metrics(cfg: Config, model: cvae.CVAE, rng: int, batch,
                       noise: Noise | Sequence[Noise] | None = None):
    """Mean gradients (None where the loss does not reach a parameter) and
    metrics over the batch, over ``cfg.grad_accum`` sequential micro-batches
    when it is above 1 (``noise`` is then one dict per micro-batch)."""
    for p in model.parameters():
        p.grad = None
    a_count = max(1, cfg.grad_accum)
    if a_count == 1:
        loss, out = loss_fn(cfg, model, rng, batch, noise)
        loss.backward()
        metrics = _out_metrics(loss, out)
    else:
        n = batch.shape[0]
        if n % a_count:
            raise ValueError(f"batch {n} does not split into grad_accum="
                             f"{a_count} equal micro-batches")
        micro = n // a_count
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


def train_step(cfg: Config, state: TrainState, rng: int, batch,
               noise: Noise | Sequence[Noise] | None = None):
    """One step: returns (the state, updated in place, and the metrics as
    device tensors). ``noise`` injects posterior draws by site, as
    ``cvae.apply_fn`` takes them."""
    model = state.params
    batch = _device_batch(batch, model.h_top.device)
    grads, metrics = _grads_and_metrics(cfg, model, rng, batch, noise)
    _, opt = optim.apply_updates(
        dict(model.named_parameters()), grads, state.opt,
        lr=cfg.learning_rate, beta1=cfg.beta1, beta2=cfg.beta2,
        eps=cfg.adamax_eps, polyak_decay=cfg.polyak_decay,
        bias_correction=cfg.bias_correction, grad_clip=cfg.grad_clip)
    return TrainState(model, opt), metrics


def init_train_state(cfg: Config, rng: int, sample_batch,
                     device="cuda") -> TrainState:
    model = cvae.init_params(cfg, sample_batch, rng=rng, device=device)
    return TrainState(model,
                      optim.init_state(dict(model.named_parameters())))
