"""Vector-latent VAE with a dense-MADE IAF posterior, the MNIST model
family (``iaf_tpu/models/mnist_vae.py``).

x/255 (the encoder sees x/255 - 0.5) -> two 5x5 stride-2 weight-norm convs
(``enc1``, ``enc2``), flattened NHWC into the posterior stats
(``enc_out``) and the flow context (``enc_context``) -> a posterior sample
of the vector z -> ``flow_depth`` MADE-dense IAF steps (``flow_{t}/made``,
z and logqs reversed between steps, not after the last) -> free-bits KL
per z dimension against N(0, I) -> ``dec_in`` to 7x7 NHWC and two 5x5
stride-2 deconvs (``dec1``, ``dec2``) to Bernoulli logits. Both flow
updates: "division" ((z - m) e^-s, logqs + s) and "gate" (the sigmoid
forget gate with ``gate_forget_bias``).

No kernel of the port runs here: the JAX package computes this model in
plain XLA, so the port does in plain PyTorch (``F.linear`` and cuDNN's
convs); in training K5 updates its parameters.

Noise: the posterior draw comes from the root site ``z``, the prior draw
when sampling from ``z_prior`` (``core.rng``), or either from the
``noise`` dict when it holds that site. ``draw_noise`` writes a training
forward's draw into a given buffer, with the same bits. ``sample``
decodes in f32 whatever ``compute_dtype`` says, as JAX's sampling context
carries no compute dtype; on the card with TF32 off.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from iaf_torch.bridge import normal_leaf
from iaf_torch.core.config import Config
from iaf_torch.core.device import cudnn_deterministic, no_tf32
from iaf_torch.core.rng import fold_name, normal_into, site_normal
from iaf_torch.distributions import (DiagonalGaussian, bernoulli_logp,
                                     compute_lowerbound)
from iaf_torch.nn.layers import (ARMultiDense, WNConv2d, WNDeconv2d,
                                 WNDense, compute_dtype)
from iaf_torch.utils.params import param_device

_LOG2PI = math.log(2.0 * math.pi)


class MnistOut(NamedTuple):
    loss: torch.Tensor       # scalar training objective (mean nats/ex)
    elbo_nats: torch.Tensor  # [B] negative k-sample IW bound
    nll_nats: torch.Tensor   # scalar mean of elbo_nats (the paper's metric)
    kl_obj: torch.Tensor     # scalar mean free-bits KL
    kl_cost: torch.Tensor    # scalar mean raw KL
    log_pxz: torch.Tensor    # scalar mean reconstruction term
    log_w: torch.Tensor      # [B*k] log importance weights
    logits: torch.Tensor     # Bernoulli logits, NHWC


def _down(size: int) -> int:
    """A 5x5 stride-2 SAME conv's output size."""
    return size // 2 + size % 2


class MnistVAE(nn.Module):
    """All parameters of the MNIST model, named after the JAX scopes."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        hs, zs = cfg.h_size, cfg.z_size
        k5, s2 = (5, 5), (2, 2)
        self.enc1 = WNConv2d(cfg.channels, hs, k5, s2, device=device)
        self.enc2 = WNConv2d(hs, 2 * hs, k5, s2, device=device)
        enc_hw = _down(_down(cfg.image_size))
        flat = enc_hw * enc_hw * 2 * hs
        self.enc_out = WNDense(flat, 2 * zs, init_scale=cfg.stat_init_scale,
                               device=device)
        self.enc_context = WNDense(flat, cfg.ar_hidden, device=device)
        self.n_flows = cfg.flow_depth if cfg.flow == "iaf" else 0
        n_h = [cfg.ar_hidden] * max(cfg.depth_ar, 1)
        for t in range(self.n_flows):
            self.add_module(f"flow_{t}", nn.ModuleDict({"made": ARMultiDense(
                zs, n_h, [zs, zs], device=device)}))
        hw = cfg.image_size // 4
        self.dec_in = WNDense(zs, hw * hw * 2 * hs, device=device)
        self.dec1 = WNDeconv2d(2 * hs, hs, k5, s2, device=device)
        self.dec2 = WNDeconv2d(hs, cfg.channels, k5, s2, device=device)

    def flows(self) -> list[ARMultiDense]:
        return [getattr(self, f"flow_{t}")["made"]
                for t in range(self.n_flows)]


def _layer(layer, x, dtype, init: bool):
    return layer.init_forward(x) if init else layer(x, dtype)


def _encoder(cfg: Config, model: MnistVAE, x, dtype, init: bool):
    h = F.elu(_layer(model.enc1, x, dtype, init))
    h = F.elu(_layer(model.enc2, h, dtype, init))
    # the logical NHWC order, whatever memory cuDNN handed back
    h = h.reshape(h.shape[0], -1)
    stats = _layer(model.enc_out, h, dtype, init)
    context = _layer(model.enc_context, h, dtype, init)
    zs = cfg.z_size
    return stats[:, :zs], stats[:, zs:], context


def _decoder(cfg: Config, model: MnistVAE, z, dtype, init: bool = False):
    hw = cfg.image_size // 4
    h = F.elu(_layer(model.dec_in, z, dtype, init))
    h = h.reshape(-1, hw, hw, 2 * cfg.h_size)
    h = F.elu(_layer(model.dec1, h, dtype, init))
    return _layer(model.dec2, h, dtype, init)


def _iaf_chain(cfg: Config, model: MnistVAE, z, context, logqs, dtype,
               init: bool = False):
    """The MADE-dense IAF steps, z and logqs reversed between steps."""
    flows = model.flows()
    for t, made in enumerate(flows):
        if init:
            m, s = made.init_forward(z, context)
        else:
            m, s = made(z, context, dtype)
        m = 0.1 * m
        s = 0.1 * s
        if cfg.flow_update == "division":
            z = (z - m) * torch.exp(-s)
            logqs = logqs + s
        elif cfg.flow_update == "gate":
            gate = torch.sigmoid(s + cfg.gate_forget_bias)
            z = gate * z + (1.0 - gate) * m
            logqs = logqs - F.logsigmoid(s + cfg.gate_forget_bias)
        else:
            raise ValueError(f"unknown flow_update {cfg.flow_update!r}")
        if t + 1 < len(flows):
            z = torch.flip(z, (-1,))
            logqs = torch.flip(logqs, (-1,))
    return z, logqs


def _images(x, device) -> torch.Tensor:
    """Pixels in [0, 256) as x/255 in f32 (the likelihood's targets)."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    return x.to(device=device, dtype=torch.float32) / 255.0


def noise_shapes(cfg: Config, rows: int) -> dict[str, tuple[int, ...]]:
    """A training forward's noise sites over ``rows`` rows (batch x k)."""
    return {"z": (rows, cfg.z_size)}


def draw_noise(cfg: Config, rng: int,
               out: Mapping[str, torch.Tensor]) -> None:
    """Write into ``out["z"]`` the posterior draw a forward at key ``rng``
    makes."""
    normal_into(fold_name(rng, "z"), out["z"])


def _forward(cfg: Config, model: MnistVAE, x, rng: int, k: int, dtype,
             noise, init: bool) -> MnistOut:
    device = param_device(model)
    x = _images(x, device)
    if k > 1:
        x = torch.repeat_interleave(x, k, dim=0)
    qz_mean, qz_logsd, context = _encoder(cfg, model, x - 0.5, dtype, init)
    posterior = DiagonalGaussian(qz_mean, 2.0 * qz_logsd)
    eps = site_normal(fold_name(rng, "z"), "z", tuple(qz_mean.shape), device,
                      noise)
    z = posterior.sample(eps)
    logqs = posterior.logps(z)
    if model.n_flows:
        z, logqs = _iaf_chain(cfg, model, z, context, logqs, dtype, init)
    logps = -0.5 * (_LOG2PI + torch.square(z))
    kl_cost = logqs - logps                      # [B, z]
    if cfg.kl_min > 0:
        # free bits per z dimension: the mean over the batch (k repeats
        # included), clamped at kl_min (the training objective only)
        kl_ave = torch.clamp(torch.mean(kl_cost, dim=0, keepdim=True),
                             min=cfg.kl_min)
        kl_obj = torch.sum(kl_ave.expand(kl_cost.shape), dim=1)
    else:
        kl_obj = torch.sum(kl_cost, dim=1)
    kl_cost = torch.sum(kl_cost, dim=1)
    logits = _decoder(cfg, model, z, dtype, init)
    log_pxz = bernoulli_logp(logits, x)
    elbo_nats = compute_lowerbound(log_pxz, kl_cost, k)
    return MnistOut(
        loss=torch.mean(kl_obj - log_pxz),
        elbo_nats=elbo_nats,
        nll_nats=torch.mean(elbo_nats),
        kl_obj=torch.mean(kl_obj),
        kl_cost=torch.mean(kl_cost),
        log_pxz=torch.mean(log_pxz),
        log_w=log_pxz - kl_cost,
        logits=logits,
    )


def apply_fn(cfg: Config, model: MnistVAE, rng: int, x, mode: str = "train",
             k: int | None = None,
             noise: Mapping[str, torch.Tensor] | None = None) -> MnistOut:
    """The forward pass (``forward``): ``x`` holds images in [0, 256),
    NHWC, already binarized by the feed; ``k`` importance samples repeat
    each image k times, interleaved. Train and eval modes compute the
    same."""
    if mode not in ("train", "eval"):
        raise ValueError(f"mode {mode!r} not in ('train', 'eval')")
    k = cfg.k if k is None else k
    return _forward(cfg, model, x, rng, k, compute_dtype(cfg.compute_dtype),
                    noise, init=False)


def pixels(out: MnistOut) -> torch.Tensor:
    """The Bernoulli means as pixel values in [0, 255]."""
    return torch.sigmoid(out.logits) * 255.0


def _draw_params(model: MnistVAE, rng: int) -> None:
    """Draw every ``V`` as N(0, 0.05^2) from its site key (JAX's
    ``normal_init(0.05)`` sites, all under the root key), in the JAX
    layout then moved to the port's."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".V"):
                path = tuple(name.split("."))
                p.copy_(normal_leaf(path, tuple(p.shape),
                                    fold_name(rng, "/".join(path)), 0.05))


def init_params(cfg: Config, batch, rng: int = 0,
                model: MnistVAE | None = None, device="cuda",
                noise: Mapping[str, torch.Tensor] | None = None
                ) -> MnistVAE:
    """Weight-norm data-dependent init on a real batch (``init_params``):
    the forward in init mode (f32), each layer's g and b set from the
    moments of its activations. A fresh model draws its ``V`` from
    ``rng``; a given ``model`` keeps them. On cuDNN's deterministic
    algorithms, so one seed gives the same bits on the card from run to
    run."""
    if model is None:
        model = MnistVAE(cfg, device=device)
        _draw_params(model, rng)
    with torch.no_grad(), cudnn_deterministic():
        _forward(cfg, model, batch, rng, cfg.k, None, noise, init=True)
    return model


@no_tf32()
def sample(cfg: Config, model: MnistVAE, rng: int, num: int,
           temperature: float = 1.0,
           noise: Mapping[str, torch.Tensor] | None = None) -> torch.Tensor:
    """Decode z ~ N(0, T^2 I) (site ``z_prior``) to Bernoulli means in
    [0, 255], [num, H, W, C], in f32 (TF32 off)."""
    device = param_device(model)
    eps = site_normal(fold_name(rng, "z_prior"), "z_prior",
                      (num, cfg.z_size), device, noise)
    return torch.sigmoid(_decoder(cfg, model, temperature * eps, None)) \
        * 255.0


def mnist_config(**overrides) -> Config:
    """The MNIST family's configuration (``mnist_config``): z = h = 64, a
    640-wide two-layer MADE, two IAF steps, Bernoulli on binarized
    28x28x1 images, batch 100."""
    base = Config(
        dataset="mnist", image_size=28, channels=1, z_size=64, h_size=64,
        ar_hidden_size=640, depth_ar=2, flow_depth=2, flow="iaf",
        flow_update="division", ar_kind="dense", likelihood="bernoulli",
        binarize=True, kl_min=0.25, learning_rate=0.002, batch_size=100,
        eval_k=4096,
    )
    return base.replace(**overrides)


Model = MnistVAE
