"""ResNet VAE with deep IAF posteriors, the CIFAR-10 model
(``iaf_tpu/models/cvae.py``).

x/256 - 0.5 -> stride-2 weight-norm stem -> ``num_blocks * depth`` IAF
layers bottom-up (posterior stats + context), then top-down from the
learned ``h_top`` (prior, posterior sample, IAF step, free-bits KL,
residual decode) -> stride-2 deconv -> discretized-logistic likelihood
with the scalar ``dec_log_stdv``. Activations are NHWC; layer i of the
flat stack is JAX's ``block_{i // depth}/layer_{i % depth}``.

On CUDA the eval/train forward runs the AR net of every IAF step through
K1 (3x3 convs) or conv by conv through K2 (any other kernel size), the
division-form update through K3 and the likelihood through K4
(``iaf_torch.ops``); on CPU tensors the same calls run the twins. With
``ar_kind=dense`` the AR net is a MADE over the channels at each latent
position (``ARMultiDense``, plain ``F.linear``, as the JAX package runs
it in XLA). The
data-dependent init runs plain convs, as JAX's init never reaches Pallas.
With ``scan_blocks`` and ``remat`` a training forward under autograd
checkpoints each layer's up and down pass (``torch.utils.checkpoint``):
their activations are recomputed in the backward, so on CUDA every
layer's forward kernels run twice a step. Where autograd does not record
and the conv operands are bf16 (``fused_route``: the IW eval, the
serving modes, export), the IAF layers run ``iaf_layer_up_fused`` and
``iaf_layer_down_fused``: the trunk convs return their raw bf16 outputs
from inputs that hold their zero border, ``ops.glue``'s passes do the
rest of each layer's elementwise work, and each layer's up-pass
statistics stay bf16 (``RawStats``); the arithmetic is the plain
passes', which the training step and the f32 recipes keep.

Noise: every layer's posterior draw comes from the site
``block_i/layer_j/z_post`` under the step key (``core.rng``), its prior
draw when sampling from ``block_i/layer_j/z_prior``, or either from the
``noise`` dict when it holds that site. ``draw_noise`` writes a training
forward's posterior draws into given buffers, with the same bits.

``cvae_sample`` (prior decode) and ``posterior_flow_probe`` (the top
layer's flow for inversion) compute in f32 whatever ``compute_dtype``
says, as JAX's sampling and probe contexts carry no compute dtype; on
the card their cuDNN convs run with TF32 off (``core.device.no_tf32``).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from iaf_torch import ops
from iaf_torch.bridge import normal_leaf
from iaf_torch.core.config import Config
from iaf_torch.core.device import cudnn_deterministic, no_tf32
from iaf_torch.core.rng import fold_name, normal_into, site_normal
from iaf_torch.distributions import DiagonalGaussian, compute_lowerbound
from iaf_torch.nn.layers import (ARMultiConv2d, ARMultiDense, WNConv2d,
                                 WNDeconv2d, compute_dtype)
from iaf_torch.parallel import mesh
from iaf_torch.utils.trace import mark, span

LOG2 = math.log(2.0)


class LayerStats(NamedTuple):
    qz_mean: torch.Tensor
    qz_logsd: torch.Tensor
    up_context: torch.Tensor


class RawStats(NamedTuple):
    """A layer's up-pass statistics on the fused route: ``up_conv1``'s raw
    bf16 output (NHWC; qz_mean, qz_logsd, up_context, hidden) and its
    bias, which the down pass adds as it reads them."""
    out: torch.Tensor
    b: torch.Tensor


class ModelOut(NamedTuple):
    loss: torch.Tensor          # scalar training objective (mean nats/ex)
    elbo_nats: torch.Tensor     # [B] negative k-sample IW bound
    bits_per_dim: torch.Tensor  # scalar
    kl_obj: torch.Tensor        # scalar mean free-bits KL
    kl_cost: torch.Tensor       # scalar mean raw KL
    log_pxz: torch.Tensor       # scalar mean reconstruction term
    log_w: torch.Tensor         # [B*k] log importance weights
    x_out: torch.Tensor         # decoded means, NHWC
    kl_per_layer: torch.Tensor  # [L] mean raw KL per layer, bottom-up


def _split(x: torch.Tensor, sizes) -> list[torch.Tensor]:
    out, start = [], 0
    for s in sizes:
        out.append(x[..., start:start + s])
        start += s
    return out


def layer_names(cfg: Config) -> list[str]:
    return [f"block_{i}/layer_{j}"
            for i in range(cfg.num_blocks) for j in range(cfg.depth)]


class IAFLayer(nn.Module):
    """Parameters of one stochastic layer (``IAFLayer``)."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        zs, hs = cfg.z_size, cfg.h_size
        ks = (cfg.kernel_size, cfg.kernel_size)
        self.up_conv1 = WNConv2d(hs, 2 * zs + 2 * hs, ks,
                                 init_scale=cfg.stat_init_scale, device=device)
        self.up_conv3 = WNConv2d(hs, hs, ks, device=device)
        self.down_conv1 = WNConv2d(hs, 4 * zs + 2 * hs, ks,
                                   init_scale=cfg.stat_init_scale,
                                   device=device)
        if cfg.flow == "iaf":
            n_h = [cfg.ar_hidden] * cfg.depth_ar
            if cfg.ar_kind == "conv":
                self.ar1 = ARMultiConv2d(
                    zs, n_h, [zs, zs], ks, trim_rows=cfg.ar_row_trim,
                    merge_heads=cfg.merge_ar_heads, device=device)
            elif cfg.ar_kind == "dense":
                # a MADE over the channel vector at every latent position
                self.ar1 = ARMultiDense(zs, n_h, [zs, zs], device=device)
            else:
                raise ValueError(f"unknown ar_kind {cfg.ar_kind!r} (conv "
                                 "or dense)")
        self.down_conv2 = WNConv2d(zs + hs, hs, ks, device=device)


class CVAE(nn.Module):
    """All parameters of the CIFAR model, named after the JAX scopes."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        if cfg.likelihood != "dlogistic":
            raise ValueError(
                f"likelihood={cfg.likelihood!r}: the CIFAR family is "
                "discretized-logistic; models.get_model sends bernoulli "
                "configs to models/mnist_vae.py")
        sks = (cfg.stem_kernel_size, cfg.stem_kernel_size)
        self.x_enc = WNConv2d(cfg.channels, cfg.h_size, sks, stride=(2, 2),
                              device=device)
        self.blocks = nn.ModuleList(
            [IAFLayer(cfg, device) for _ in range(cfg.num_blocks * cfg.depth)])
        self.h_top = nn.Parameter(torch.zeros(cfg.h_size, device=device))
        self.x_dec = WNDeconv2d(cfg.h_size, cfg.channels, sks, stride=(2, 2),
                                device=device)
        self.dec_log_stdv = nn.Parameter(torch.zeros((), device=device))


def _conv(conv, x, dtype, init):
    return conv.init_forward(x) if init else conv(x, dtype)


def iaf_layer_up(cfg: Config, layer: IAFLayer, h: torch.Tensor, dtype=None,
                 init: bool = False):
    """Bottom-up pass of one stochastic layer (``IAFLayer.up``), in the
    host span ``iaf_up``. A replayed graph runs no Python: there the up
    passes are the device time before the mark ``up`` (``utils.trace``)."""
    zs, hs = cfg.z_size, cfg.h_size
    with span("iaf_up"):
        x = _conv(layer.up_conv1, F.elu(h), dtype, init)
        qz_mean, qz_logsd, up_context, hidden = _split(x, [zs, zs, hs, hs])
        hidden = _conv(layer.up_conv3, F.elu(hidden), dtype, init)
        return h + 0.1 * hidden, LayerStats(qz_mean, qz_logsd, up_context)


def iaf_flow(cfg: Config, layer: IAFLayer, z, context, logqs, dtype=None,
             init: bool = False, z_ar=None):
    """One IAF step: masked AR net (the host span ``ar_stack``; in a
    replay, inside the ``down`` phase) -> (m, s) heads scaled by 0.1 ->
    invertible update, the log-det-Jacobian folded into ``logqs``.
    ``z_ar``, where given, is z already in ``dtype`` for the AR net."""
    with span("ar_stack"):
        if init:
            m, s = layer.ar1.init_forward(z, context)
        else:
            m, s = layer.ar1(z if z_ar is None else z_ar, context, dtype)
    m = m * 0.1
    s = s * 0.1
    if cfg.flow_update == "division":
        if init:
            return (z - m) * torch.exp(-s), logqs + s
        return ops.iaf_update(z.contiguous(), m.contiguous(), s.contiguous(),
                              logqs.contiguous())
    if cfg.flow_update == "gate":
        gate = torch.sigmoid(s + cfg.gate_forget_bias)
        z = gate * z + (1.0 - gate) * m
        return z, logqs - F.logsigmoid(s + cfg.gate_forget_bias)
    raise ValueError(f"unknown flow_update {cfg.flow_update!r}")


def iaf_layer_down(cfg: Config, layer: IAFLayer, h, stats: LayerStats,
                   eps: torch.Tensor, dtype=None, init: bool = False):
    """Top-down pass of one stochastic layer (``IAFLayer.down``) with the
    posterior drawn from standard-normal ``eps``. Returns (new h, the
    free-bits term, kl_cost per example): with ``kl_min`` > 0 the term
    is the per-channel KL summed over space and averaged over the batch,
    [1, zs], which ``free_bits`` clamps; else kl_obj per example. In the
    host span ``iaf_down``; in a replay, the device time between the
    marks ``up`` and ``down``."""
    zs, hs = cfg.z_size, cfg.h_size
    with span("iaf_down"):
        x = _conv(layer.down_conv1, F.elu(h), dtype, init)
        pz_mean, pz_logsd, rz_mean, rz_logsd, down_context, h_det = _split(
            x, [zs, zs, zs, zs, hs, hs])
        prior = DiagonalGaussian(pz_mean, 2.0 * pz_logsd)
        posterior = DiagonalGaussian(stats.qz_mean + rz_mean,
                                     2.0 * (stats.qz_logsd + rz_logsd))
        z = posterior.sample(eps)
        logqs = posterior.logps(z)
        if cfg.flow == "iaf":
            context = stats.up_context + down_context
            z, logqs = iaf_flow(cfg, layer, z, context, logqs, dtype, init)
        kl_cost = logqs - prior.logps(z)           # [B, H, W, zs]
        if cfg.kl_min > 0:
            kl_obj = torch.mean(torch.sum(kl_cost, dim=(1, 2)), dim=0,
                                keepdim=True)
        else:
            kl_obj = torch.sum(kl_cost, dim=(1, 2, 3))
        kl_cost = torch.sum(kl_cost, dim=(1, 2, 3))
        hidden = F.elu(torch.cat([z, h_det], dim=-1))
        hidden = _conv(layer.down_conv2, hidden, dtype, init)
        return h + 0.1 * hidden, kl_obj, kl_cost


def fused_route(model: CVAE, dtype) -> bool:
    """Whether a forward takes the fused inference passes (``ops.glue``):
    the conv operands are bf16, the trunk convs run on a bordered input
    (``WNConv2d.same_pad``) and autograd does not record (the test
    ``ops.ar_stack`` makes). The training step, the f32 recipes and
    everything under autograd keep the plain passes."""
    return (dtype == torch.bfloat16
            and model.blocks[0].up_conv1.same_pad is not None
            and not (torch.is_grad_enabled()
                     and any(p.requires_grad for p in model.parameters())))


def iaf_layer_up_fused(cfg: Config, layer: IAFLayer, h, a):
    """``iaf_layer_up`` on the fused route: ``a`` is bf16 ELU(h) with the
    trunk convs' zero border, the convs run unpadded on such inputs and
    return their raw bf16 outputs, and ``ops.glue``'s passes add the
    biases. Returns (new h, its bf16 ELU with the border, ``RawStats``)."""
    pad = layer.up_conv1.same_pad
    with span("iaf_up"):
        out = layer.up_conv1.raw(a)
        hidden = ops.up_stats(out, layer.up_conv1.b, cfg.h_size, pad)
        h, a = ops.residual_elu(h, layer.up_conv3.raw(hidden),
                                layer.up_conv3.b, pad)
        return h, a, RawStats(out, layer.up_conv1.b)


def iaf_layer_down_fused(cfg: Config, layer: IAFLayer, h, a,
                         stats: RawStats, eps: torch.Tensor, dtype,
                         last: bool):
    """``iaf_layer_down`` on the fused route (as ``iaf_layer_up_fused``;
    the ``last`` layer's ELU(h) goes to the deconv, with no border):
    returns (new h, its bf16 ELU, the free-bits term, kl_cost)."""
    pad = layer.down_conv1.same_pad
    with span("iaf_down"):
        out, b = layer.down_conv1.raw(a), layer.down_conv1.b
        z, z_ar, logqs, context = ops.posterior(out, b, stats.out, stats.b,
                                                eps)
        if cfg.flow == "iaf":
            z, logqs = iaf_flow(cfg, layer, z, context, logqs, dtype,
                                z_ar=z_ar)
        kl_sums, kl_cost, joined = ops.kl_join(z, logqs, out, b, pad)
        kl_obj = (torch.mean(kl_sums, dim=0, keepdim=True)
                  if cfg.kl_min > 0 else kl_cost)
        h, a = ops.residual_elu(h, layer.down_conv2.raw(joined),
                                layer.down_conv2.b, 0 if last else pad)
        return h, a, kl_obj, kl_cost


def free_bits(cfg: Config, kl_aves, batch: int, global_batch: bool):
    """Each layer's free-bits objective per example (enters the training
    objective only): its per-channel KL means clamped at ``kl_min`` and
    summed over the channels. With ``global_batch`` (training under a
    process group) the means are the global batch's, all layers' in one
    all-reduce (``mesh.global_means``), as JAX takes them over the
    sharded global batch."""
    if global_batch:
        kl_aves = mesh.global_means(kl_aves)
    return [torch.sum(torch.clamp(a, min=cfg.kl_min).expand(batch,
                                                            cfg.z_size),
                      dim=1) for a in kl_aves]


def _images(x, device) -> torch.Tensor:
    # NHWC-contiguous whatever layout the images came in: cuDNN's
    # algorithms, and so the last bits, follow the memory layout
    x = torch.as_tensor(np.ascontiguousarray(x) if not torch.is_tensor(x)
                        else x.contiguous())
    return x.to(device=device, dtype=torch.float32) / 256.0 - 0.5


def _eps(cfg, rng, i, shape, device, noise, site: str = "z_post"):
    """Layer i's standard-normal draw at ``site`` (``z_post`` or
    ``z_prior``): key fold_name(fold_name(rng, layer), site), or the
    ``noise`` dict's tensor for ``<layer>/<site>``."""
    name = layer_names(cfg)[i]
    key = fold_name(fold_name(rng, name), site)
    return site_normal(key, f"{name}/{site}", shape, device, noise)


def noise_shapes(cfg: Config, rows: int) -> dict[str, tuple[int, ...]]:
    """A training forward's noise sites over ``rows`` rows (batch x k):
    each layer's posterior draw."""
    hw = cfg.image_size // 2
    return {f"{n}/z_post": (rows, hw, hw, cfg.z_size)
            for n in layer_names(cfg)}


def sample_noise_shapes(cfg: Config, num: int
                        ) -> dict[str, tuple[int, ...]]:
    """``cvae_sample``'s noise sites for ``num`` images: each layer's prior
    draw."""
    hw = cfg.image_size // 2
    return {f"{n}/z_prior": (num, hw, hw, cfg.z_size)
            for n in layer_names(cfg)}


def draw_noise(cfg: Config, rng: int,
               out: Mapping[str, torch.Tensor]) -> None:
    """Write into each buffer of ``out`` (``<layer>/z_post`` -> tensor) the
    posterior draw a forward at key ``rng`` makes there (``_eps``)."""
    for name in layer_names(cfg):
        site = f"{name}/z_post"
        normal_into(fold_name(fold_name(rng, name), "z_post"), out[site])


def _layer_pass(remat: bool, fn, *args):
    """``fn(*args)``, one layer's up or down pass; under ``remat`` in a
    non-reentrant ``torch.utils.checkpoint``, which keeps the arguments
    (the layer's noise among them, so the recompute draws nothing) and
    runs ``fn`` again in the backward to rebuild what it saved."""
    if not remat:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def cvae_forward(cfg: Config, model: CVAE, x, rng: int, mode: str = "train",
                 k: int | None = None,
                 noise: Mapping[str, torch.Tensor] | None = None) -> ModelOut:
    """Full forward pass. ``x`` holds images in [0, 256), NHWC; ``k``
    importance samples repeat each image k times, interleaved. Issues the
    device marks ``up`` after the up passes, ``down`` after the down
    passes and the KL stack, and ``out`` after the loss and the bound
    (``utils.trace``; nothing where marks are off). Where ``fused_route``
    holds, the IAF layers run ``iaf_layer_up_fused`` and
    ``iaf_layer_down_fused``, which carry h and its bf16 ELU."""
    if mode not in ("train", "eval"):
        raise ValueError(f"mode {mode!r} not in ('train', 'eval')")
    k = cfg.k if k is None else k
    dtype = compute_dtype(cfg.compute_dtype)
    device = model.h_top.device
    x = _images(x, device)
    if k > 1:
        x = torch.repeat_interleave(x, k, dim=0)
    batch = x.shape[0]

    h = model.x_enc(x, dtype)
    # remat: each layer's up and down pass keeps only its inputs and
    # recomputes the rest in the backward (JAX's jax.checkpoint of the
    # scanned layer body, so only with scan_blocks); training only
    remat = (cfg.scan_blocks and cfg.remat and mode == "train"
             and torch.is_grad_enabled())
    fused = fused_route(model, dtype)
    pad = model.blocks[0].up_conv1.same_pad if fused else 0
    a = ops.elu_bf16(h, pad) if fused else None
    stats = []
    for layer in model.blocks:
        if fused:
            h, a, st = iaf_layer_up_fused(cfg, layer, h, a)
        else:
            h, st = _layer_pass(remat, iaf_layer_up, cfg, layer, h, dtype)
        stats.append(st)
    mark("up", device)

    dec_hw = cfg.image_size // 2
    h = model.h_top.expand(batch, dec_hw, dec_hw, cfg.h_size)
    a = ops.elu_bf16(h, pad) if fused else None
    n = len(model.blocks)
    objs, costs = [None] * n, [None] * n
    zshape = (batch, dec_hw, dec_hw, cfg.z_size)
    for i in reversed(range(n)):
        eps = _eps(cfg, rng, i, zshape, device, noise)
        if fused:
            h, a, objs[i], costs[i] = iaf_layer_down_fused(
                cfg, model.blocks[i], h, a, stats[i], eps, dtype, i == 0)
        else:
            h, objs[i], costs[i] = _layer_pass(remat, iaf_layer_down, cfg,
                                               model.blocks[i], h, stats[i],
                                               eps, dtype)
    if cfg.kl_min > 0:
        objs = free_bits(cfg, objs, batch,
                         mode == "train" and mesh.active())
    kl_objs, kl_costs = torch.stack(objs), torch.stack(costs)
    kl_obj_total = kl_objs.sum(0)
    kl_cost_total = kl_costs.sum(0)
    mark("down", device)

    x_out = model.x_dec(a if fused else F.elu(h), dtype)
    log_pxz = ops.disc_logistic_logp(x_out.contiguous(), model.dec_log_stdv,
                                     x.contiguous())
    loss = torch.mean(kl_obj_total - log_pxz)
    elbo_nats = compute_lowerbound(log_pxz, kl_cost_total, k)
    out = ModelOut(
        loss=loss,
        elbo_nats=elbo_nats,
        bits_per_dim=torch.mean(elbo_nats) / (LOG2 * cfg.num_pixels),
        kl_obj=torch.mean(kl_obj_total),
        kl_cost=torch.mean(kl_cost_total),
        log_pxz=torch.mean(log_pxz),
        log_w=log_pxz - kl_cost_total,
        x_out=x_out,
        kl_per_layer=torch.mean(kl_costs, dim=1),
    )
    mark("out", device)
    return out


def apply_fn(cfg: Config, model: CVAE, rng: int, x, mode: str = "train",
             k: int | None = None,
             noise: Mapping[str, torch.Tensor] | None = None) -> ModelOut:
    return cvae_forward(cfg, model, x, rng, mode=mode, k=k, noise=noise)


def _jax_path(name: str, cfg: Config) -> tuple[str, str]:
    """(key scope, site) of a state_dict entry under JAX's naming: a layer
    parameter draws from its layer's key, the rest from the root key."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return layer_names(cfg)[int(parts[1])], "/".join(parts[2:])
    return "", "/".join(parts)


def _draw_params(cfg: Config, model: CVAE, rng: int) -> None:
    """Draw every ``V`` and ``h_top`` as N(0, 0.05^2) from its site key
    (JAX's ``normal_init(0.05)`` sites), in the JAX layout then moved to
    the port's."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not (name.endswith(".V") or name == "h_top"):
                continue
            scope, site = _jax_path(name, cfg)
            key = fold_name(fold_name(rng, scope), site) if scope else \
                fold_name(rng, site)
            p.copy_(normal_leaf(tuple(site.split("/")), tuple(p.shape),
                                key, 0.05))


def init_params(cfg: Config, batch, rng: int = 0, model: CVAE | None = None,
                device="cuda",
                noise: Mapping[str, torch.Tensor] | None = None) -> CVAE:
    """Weight-norm data-dependent init on a real batch (``init_params``):
    the forward sequencing in init mode, where each layer's g and b are
    set from the moments of its activations. A fresh model draws its
    ``V`` and ``h_top`` from ``rng``; a given ``model`` keeps them. On
    cuDNN's deterministic algorithms, so one seed gives the same bits
    on the card from run to run."""
    if model is None:
        model = CVAE(cfg, device=device)
        _draw_params(cfg, model, rng)
    device = model.h_top.device
    with torch.no_grad(), cudnn_deterministic():
        x = _images(batch, device)
        h = model.x_enc.init_forward(x)
        stats = []
        for layer in model.blocks:
            h, st = iaf_layer_up(cfg, layer, h, init=True)
            stats.append(st)
        dec_hw = cfg.image_size // 2
        h = model.h_top.expand(x.shape[0], dec_hw, dec_hw, cfg.h_size)
        zshape = (x.shape[0], dec_hw, dec_hw, cfg.z_size)
        for i in reversed(range(len(model.blocks))):
            eps = _eps(cfg, rng, i, zshape, device, noise)
            h, _, _ = iaf_layer_down(cfg, model.blocks[i], h, stats[i], eps,
                                     init=True)
        model.x_dec.init_forward(F.elu(h))
        model.dec_log_stdv.zero_()
    return model


@no_tf32()
def cvae_sample(cfg: Config, model: CVAE, rng: int, num: int,
                temperature: float = 1.0,
                noise: Mapping[str, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """Generative sampling (``cvae_sample``): no up pass; from ``h_top``
    each layer top-down draws z = prior mean + T * prior sd * eps and
    decodes, all in f32 (TF32 off). Returns [num, H, W, C] images in
    [0, 255]."""
    zs, hs = cfg.z_size, cfg.h_size
    device = model.h_top.device
    dec_hw = cfg.image_size // 2
    h = model.h_top.expand(num, dec_hw, dec_hw, hs)
    for i in reversed(range(len(model.blocks))):
        layer = model.blocks[i]
        x = layer.down_conv1(F.elu(h))
        pz_mean, pz_logsd, _, _, _, h_det = _split(
            x, [zs, zs, zs, zs, hs, hs])
        eps = _eps(cfg, rng, i, tuple(pz_mean.shape), device, noise,
                   "z_prior")
        z = pz_mean + temperature * torch.exp(pz_logsd) * eps
        hidden = layer.down_conv2(F.elu(torch.cat([z, h_det], dim=-1)))
        h = h + 0.1 * hidden
    return _pixels(model.x_dec(F.elu(h)))


def _pixels(x_out: torch.Tensor) -> torch.Tensor:
    return torch.clamp((x_out + 0.5) * 256.0, 0.0, 255.0)


def pixels(out: ModelOut) -> torch.Tensor:
    """The decoded means as pixel values in [0, 255]."""
    return _pixels(out.x_out)


@no_tf32()
def posterior_flow_probe(cfg: Config, model: CVAE, rng: int, x,
                         noise: Mapping[str, torch.Tensor] | None = None):
    """The top layer's pre-flow posterior sample, its flow context and its
    AR net for images ``x``, in f32 with TF32 off (``posterior_flow_probe``):
    the up pass, then the top layer's ``down_conv1`` on ELU(h_top), and
    the posterior draw from site ``<top layer>/z_post``. Returns (z0,
    context, ar_fn) with ``ar_fn(z) -> (0.1 m, 0.1 s)`` through the top
    layer's ``ARMultiConv2d`` with its weights folded once for every sweep
    (``frozen``), so on the card it runs K1 (or K2) as the model does."""
    zs, hs = cfg.z_size, cfg.h_size
    device = model.h_top.device
    xf = _images(x, device)
    h = model.x_enc(xf)
    for layer in model.blocks:
        h, stats = iaf_layer_up(cfg, layer, h)
    top = model.blocks[-1]          # stats: the top layer's up pass
    dec_hw = cfg.image_size // 2
    h = model.h_top.expand(xf.shape[0], dec_hw, dec_hw, hs)
    xd = top.down_conv1(F.elu(h))
    _, _, rz_mean, rz_logsd, down_context, _ = _split(
        xd, [zs, zs, zs, zs, hs, hs])
    posterior = DiagonalGaussian(stats.qz_mean + rz_mean,
                                 2.0 * (stats.qz_logsd + rz_logsd))
    eps = _eps(cfg, rng, len(model.blocks) - 1, tuple(rz_mean.shape),
               device, noise)
    z = posterior.sample(eps)
    # contiguous once here, and the AR weights folded once (``frozen``),
    # not at every sweep inside ``ar1``
    context = (stats.up_context + down_context).contiguous()
    ar = top.ar1.frozen()

    def ar_fn(zq: torch.Tensor):
        m, s = ar(zq, context)
        return m * 0.1, s * 0.1

    return z, context, ar_fn


Model = CVAE
sample = cvae_sample
