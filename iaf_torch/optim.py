"""Adamax + Polyak (EMA) parameter averaging (``iaf_tpu/optim.py``).

m <- b1*m + (1-b1)*g; u <- max(b2*u, |g|); p <- p - lr*m/(u+eps), with no
bias correction by default, then the Polyak shadow taken from the updated
params. Optional bias correction (lr / (1 - b1^t)) and global-norm grad
clipping are off by default, as in the JAX package.

The state lives beside the model's parameters as name -> tensor dicts
(the model's ``named_parameters`` names). ``apply_updates`` updates the
params, m, u and ema in place: on CUDA every leaf goes through one launch
of K5 (``ops.adamax_polyak``), on the CPU through its twin. The step
count, the bias-corrected lr and the clip factor stay on the device, so
the host never waits on the card. The step count is advanced in place,
so a captured CUDA graph of the step (``parallel/train_step.py``) counts
on the same tensor at every replay. A ``None`` gradient (a parameter the
loss does not reach) counts as zeros, as JAX's zero cotangent does.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from iaf_torch import ops


class AdamaxState(NamedTuple):
    step: torch.Tensor              # int32 scalar, on the params' device
    m: dict[str, torch.Tensor]      # first moment
    u: dict[str, torch.Tensor]      # exponentially weighted infinity norm
    ema: dict[str, torch.Tensor]    # Polyak average of the params


def init_state(params: Mapping[str, torch.Tensor]) -> AdamaxState:
    """Zero moments and an EMA that is a copy of the params, never an
    alias (the update writes both in place)."""
    dev = next(iter(params.values())).device
    with torch.no_grad():
        return AdamaxState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m={k: torch.zeros_like(p) for k, p in params.items()},
            u={k: torch.zeros_like(p) for k, p in params.items()},
            ema={k: p.detach().clone() for k, p in params.items()})


def apply_updates(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor | None], state: AdamaxState, *,
    lr: float, beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
    polyak_decay: float = 0.999, bias_correction: bool = False,
    grad_clip: float = 0.0,
) -> tuple[Mapping[str, torch.Tensor], AdamaxState]:
    """One Adamax + Polyak step over every leaf of ``params``, in place,
    the step count too. Returns (params, the state, its tensors the same
    ones)."""
    names = list(params)
    ps = [params[k].detach() for k in names]
    gs = [grads.get(k) for k in names]
    gs = [torch.zeros_like(p) if g is None else g.detach()
          for p, g in zip(ps, gs)]
    dev = ps[0].device
    step = state.step.add_(1)
    scale = None
    if grad_clip > 0.0:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in gs))
        scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
    if bias_correction:
        # filled on the device: a copy from the host would wait on it
        b1 = torch.full((), beta1, dtype=torch.float32, device=dev)
        lr_t = lr / (1.0 - torch.pow(b1, step.to(torch.float32)))
    else:
        lr_t = torch.full((), lr, dtype=torch.float32, device=dev)
    ops.adamax_polyak(ps, gs, [state.m[k] for k in names],
                      [state.u[k] for k in names],
                      [state.ema[k] for k in names], lr_t, beta1=beta1,
                      beta2=beta2, eps=eps, polyak_decay=polyak_decay,
                      scale=scale)
    return params, state
