"""Plain PyTorch reference of the ResNet VAE with IAF posteriors.

The architecture of Kingma et al. 2016 (arXiv:1606.04934) as the
openai/iaf code builds it for CIFAR-10, written here from its equations
in plain ``torch`` operations, NCHW, float32 (run it with TF32 off), with
no kernel, cache or batching of the program under test. It imports
nothing of that program, and takes from the benchmark only the
configuration (a dict of sizes), the parameters (a dict of tensors
named as below), the images and the standard-normal draws.

One forward:

- x = images / 256 - 0.5; ``x_enc``: a weight-normalised stride-2 conv
  (XLA's SAME padding).
- bottom-up, per IAF layer: ``up_conv1`` on ELU(h) gives the posterior
  mean and log-sd, the up context and a hidden part; h += 0.1 *
  ``up_conv3``(ELU(hidden)).
- top-down from ``h_top``, per layer from the top: ``down_conv1`` on
  ELU(h) gives the prior's mean and log-sd, the posterior's corrections,
  the down context and h_det; z = posterior mean + sd * eps; the AR net
  (masked convs, the first with a zero diagonal, the context added after
  it, ELU after each hidden conv) gives (m, s), scaled by 0.1; z <- (z -
  m) exp(-s), log q += s; KL = log q(z) - log p(z); h += 0.1 *
  ``down_conv2``(ELU([z, h_det])).
- free bits: per layer the per-channel KL averaged over the batch and
  summed over space, clamped below at ``kl_min``, summed over channels.
- ``x_dec``: a weight-normalised stride-2 transposed conv (JAX's
  ``conv_transpose`` with SAME padding: the input dilated by the stride,
  padded, correlated with the kernel as stored), then the discretized
  logistic likelihood with the scalar log-scale ``dec_log_stdv``.

Weight norm: W = V / |V| * g per output unit, then the AR mask. The
optional ``quant`` maps every conv operand (input and weight) to a
lower precision with a straight-through gradient: the precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LOG2PI = math.log(2.0 * math.pi)
BINSIZE = 1.0 / 256.0


# --------------------------------------------------------------- masks

def linear_ar_mask(n_in: int, n_out: int, zerodiagonal: bool) -> np.ndarray:
    """[n_in, n_out] MADE mask over channel order, degrees evenly
    strided; ``zerodiagonal`` forbids an output its own group."""
    mask = np.ones((n_in, n_out), dtype=np.float32)
    if n_out >= n_in:
        k = n_out // n_in
        for i in range(n_in):
            mask[i + 1:, i * k:(i + 1) * k] = 0.0
            if zerodiagonal:
                mask[i, i * k:(i + 1) * k] = 0.0
    else:
        k = n_in // n_out
        for i in range(n_out):
            mask[(i + 1) * k:, i] = 0.0
            if zerodiagonal:
                mask[i * k:(i + 1) * k, i] = 0.0
    return mask


def conv_ar_mask(kh: int, kw: int, n_in: int, n_out: int,
                 zerodiagonal: bool) -> np.ndarray:
    """[n_out, n_in, kh, kw] mask: taps before the centre in raster order
    pass everything, taps after it nothing, the centre the MADE mask."""
    mask = np.ones((kh, kw, n_in, n_out), dtype=np.float32)
    cy, cx = (kh - 1) // 2, (kw - 1) // 2
    mask[cy + 1:] = 0.0
    mask[cy, cx + 1:] = 0.0
    mask[cy, cx] = linear_ar_mask(n_in, n_out, zerodiagonal)
    return np.ascontiguousarray(mask.transpose(3, 2, 0, 1))


def live_taps(kh: int, kw: int) -> int:
    """Taps of a causal mask with any weight: the rows above the centre,
    and the centre row up to the centre."""
    return (kh - 1) // 2 * kw + (kw - 1) // 2 + 1


# --------------------------------------------------------- parameters

def n_layers(c: dict) -> int:
    return c["num_blocks"] * c["depth"]


def ar_widths(c: dict) -> list[tuple[int, int]]:
    """(in, out) of each conv of one AR net, hidden ones then the merged
    (m, s) heads."""
    z, hid = c["z_size"], c["ar_hidden_size"] or c["h_size"]
    dims = [z] + [hid] * c["depth_ar"]
    return list(zip(dims[:-1], dims[1:])) + [(dims[-1], 2 * z)]


def conv_specs(c: dict) -> list[tuple[str, int, int, int, float, bool]]:
    """(name, in, out, kernel, init scale, masked) of every weight-normed
    conv but the decoder, in the order of the parameters."""
    z, h, k, sk = c["z_size"], c["h_size"], c["kernel_size"], \
        c["stem_kernel_size"]
    s = c["stat_init_scale"]
    out = [("x_enc", c["channels"], h, sk, 1.0, False)]
    for i in range(n_layers(c)):
        p = f"blocks.{i}."
        out += [(p + "up_conv1", h, 2 * z + 2 * h, k, s, False),
                (p + "up_conv3", h, h, k, 1.0, False),
                (p + "down_conv1", h, 4 * z + 2 * h, k, s, False)]
        widths = ar_widths(c)
        for j, (ci, co) in enumerate(widths):
            name = "layer_out" if j == len(widths) - 1 else f"layer_{j}"
            out.append((p + "ar1." + name, ci, co, k, 1.0, True))
        out.append((p + "down_conv2", z + h, h, k, 1.0, False))
    return out


def param_shapes(c: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape (conv weights [out, in, kh, kw];
    the decoder's [in, out, kh, kw])."""
    shapes: dict[str, tuple[int, ...]] = {}
    for name, ci, co, k, _, _ in conv_specs(c):
        shapes[name + ".V"] = (co, ci, k, k)
        shapes[name + ".g"] = (co,)
        shapes[name + ".b"] = (co,)
    shapes["h_top"] = (c["h_size"],)
    sk = c["stem_kernel_size"]
    shapes["x_dec.V"] = (c["h_size"], c["channels"], sk, sk)
    shapes["x_dec.g"] = (c["channels"],)
    shapes["x_dec.b"] = (c["channels"],)
    shapes["dec_log_stdv"] = ()
    return shapes


def masks(c: dict, device) -> dict[str, torch.Tensor]:
    """The AR mask of each masked conv, by conv name."""
    k = c["kernel_size"]
    out = {}
    for i in range(n_layers(c)):
        widths = ar_widths(c)
        for j, (ci, co) in enumerate(widths):
            if j == len(widths) - 1:
                m = np.concatenate([conv_ar_mask(k, k, ci, co // 2, False)]
                                   * 2, axis=0)
                name = "layer_out"
            else:
                m = conv_ar_mask(k, k, ci, co, j == 0)
                name = f"layer_{j}"
            out[f"blocks.{i}.ar1.{name}"] = torch.from_numpy(m).to(device)
    return out


# ------------------------------------------------------------- layers

def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding (before, after) of one spatial dim."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def wn_weight(V: torch.Tensor, g: torch.Tensor, dims: tuple[int, ...],
              out_dim: int) -> torch.Tensor:
    shape = [1] * V.dim()
    shape[out_dim] = -1
    norm = torch.rsqrt(torch.sum(V * V, dim=dims, keepdim=True) + 1e-12)
    return V * norm * g.reshape(shape)


def _q(quant, t):
    return t if quant is None else quant(t)


def conv(P, name: str, x: torch.Tensor, stride: int = 1, mask=None,
         quant=None) -> torch.Tensor:
    """A weight-normalised conv, SAME padding, NCHW."""
    W = wn_weight(P[name + ".V"], P[name + ".g"], (1, 2, 3), 0)
    if mask is not None:
        W = W * mask
    kh, kw = W.shape[2:]
    (pt, pb), (pl, pr) = (same_pads(x.shape[2], kh, stride),
                          same_pads(x.shape[3], kw, stride))
    xp = F.pad(_q(quant, x), (pl, pr, pt, pb))
    return F.conv2d(xp, _q(quant, W), stride=stride) \
        + P[name + ".b"].reshape(1, -1, 1, 1)


def deconv(P, name: str, x: torch.Tensor, stride: int,
           quant=None) -> torch.Tensor:
    """JAX's ``conv_transpose(x, k, s, "SAME")`` with the kernel as
    stored ([in, out, kh, kw]): x dilated by s, padded (a, b) with a =
    ceil((k + s - 2) / 2), b = k + s - 2 - a (a = k - 1 where s > k - 1),
    correlated with the kernel."""
    W = wn_weight(P[name + ".V"], P[name + ".g"], (0, 2, 3), 1)
    n, c, h, w = x.shape
    k = W.shape[2]
    xd = x.new_zeros((n, c, (h - 1) * stride + 1, (w - 1) * stride + 1))
    xd[:, :, ::stride, ::stride] = x
    pad = k + stride - 2
    a = k - 1 if stride > k - 1 else math.ceil(pad / 2)
    xp = F.pad(_q(quant, xd), (a, pad - a, a, pad - a))
    out = F.conv2d(xp, _q(quant, W.transpose(0, 1)))
    return out + P[name + ".b"].reshape(1, -1, 1, 1)


def gaussian_logp(x, mean, logsd):
    return -0.5 * (LOG2PI + 2.0 * logsd + (x - mean) ** 2
                   * torch.exp(-2.0 * logsd))


def disc_logistic_logp(mean, logscale, sample):
    """log p(sample) under a logistic discretised into 1/256 bins, summed
    per example."""
    scale = torch.exp(logscale)
    x = (torch.floor(sample / BINSIZE) * BINSIZE - mean) / scale
    logp = torch.log(torch.sigmoid(x + BINSIZE / scale) - torch.sigmoid(x)
                     + 1e-7)
    return logp.flatten(1).sum(1)


def ar_net(c, P, M, prefix: str, z, context, quant=None):
    h = z
    widths = ar_widths(c)
    for j in range(len(widths) - 1):
        name = f"{prefix}ar1.layer_{j}"
        h = conv(P, name, h, mask=M[name], quant=quant)
        if j == 0:
            h = h + context
        h = F.elu(h)
    name = prefix + "ar1.layer_out"
    out = conv(P, name, h, mask=M[name], quant=quant)
    zs = c["z_size"]
    return out[:, :zs], out[:, zs:]


# ------------------------------------------------------------ forward

def forward(c: dict, P: dict, M: dict, images: torch.Tensor,
            eps: list[torch.Tensor], k: int = 1, quant=None) -> dict:
    """One forward. ``images`` [B, H, W, C] uint8 or float pixel values;
    ``eps[i]`` layer i's standard-normal draw [B*k, H/2, W/2, z] (rows
    image-major: image b's k samples are rows b*k .. b*k+k-1). Returns
    the training loss, per-row log p(x|z), KL and log-weights, and the
    per-layer mean KL."""
    zs, hs = c["z_size"], c["h_size"]
    x = images.to(torch.float32).permute(0, 3, 1, 2) / 256.0 - 0.5
    if k > 1:
        x = torch.repeat_interleave(x, k, dim=0)
    rows = x.shape[0]
    h = conv(P, "x_enc", x, stride=2, quant=quant)
    stats = []
    for i in range(n_layers(c)):
        p = f"blocks.{i}."
        t = conv(P, p + "up_conv1", F.elu(h), quant=quant)
        qm, qs, ctx, hid = torch.split(t, [zs, zs, hs, hs], dim=1)
        h = h + 0.1 * conv(P, p + "up_conv3", F.elu(hid), quant=quant)
        stats.append((qm, qs, ctx))
    hw = h.shape[2]
    h = P["h_top"].reshape(1, -1, 1, 1).expand(rows, hs, hw, hw)
    kl_obj, kl_cost, kl_mean = [], [], []
    for i in reversed(range(n_layers(c))):
        p = f"blocks.{i}."
        qm, qs, up_ctx = stats[i]
        t = conv(P, p + "down_conv1", F.elu(h), quant=quant)
        pm, ps, rm, rs, down_ctx, h_det = torch.split(
            t, [zs, zs, zs, zs, hs, hs], dim=1)
        mean, logsd = qm + rm, qs + rs
        z = mean + torch.exp(logsd) * eps[i].permute(0, 3, 1, 2)
        logq = gaussian_logp(z, mean, logsd)
        m, s = ar_net(c, P, M, p, z, up_ctx + down_ctx, quant)
        m, s = 0.1 * m, 0.1 * s
        z = (z - m) * torch.exp(-s)
        logq = logq + s
        kl = logq - gaussian_logp(z, pm, ps)           # [rows, z, h, w]
        per_channel = kl.sum((2, 3)).mean(0)           # [z]
        kl_obj.append(torch.clamp(per_channel, min=c["kl_min"]).sum()
                      .expand(rows))
        kl_cost.append(kl.sum((1, 2, 3)))
        kl_mean.append(kl.sum((1, 2, 3)).mean())
        h = h + 0.1 * conv(P, p + "down_conv2",
                           F.elu(torch.cat([z, h_det], dim=1)), quant=quant)
    x_out = deconv(P, "x_dec", F.elu(h), 2, quant=quant)
    log_pxz = disc_logistic_logp(x_out, P["dec_log_stdv"], x)
    kl_obj_total = torch.stack(kl_obj).sum(0)
    kl_cost_total = torch.stack(kl_cost).sum(0)
    return dict(loss=torch.mean(kl_obj_total - log_pxz),
                kl_obj=kl_obj_total.mean(), kl_cost=kl_cost_total.mean(),
                log_pxz_mean=log_pxz.mean(),
                kl_per_layer=torch.stack(kl_mean[::-1]),
                log_w=log_pxz - kl_cost_total)


# ----------------------------------------------------------- training

def adamax_polyak(P: dict, grads: dict, state: dict, o: dict) -> None:
    """One Adamax step without bias correction, then the Polyak average
    of the updated parameters, in place. ``state`` holds m, u, ema."""
    with torch.no_grad():
        for name, p in P.items():
            g = grads[name]
            m = state["m"][name].mul_(o["beta1"]).add_(g, alpha=1 - o["beta1"])
            u = state["u"][name]
            torch.maximum(u * o["beta2"], g.abs(), out=u)
            p.sub_(o["learning_rate"] * m / (u + o["adamax_eps"]))
            state["ema"][name].mul_(o["polyak_decay"]).add_(
                p, alpha=1 - o["polyak_decay"])


def train_steps(c: dict, P0: dict, batches: list, noises: list,
                quant=None, rows: slice | None = None) -> dict:
    """``len(batches)`` Adamax + Polyak steps from the parameters ``P0``
    (copied); ``noises[t]`` step t's draws per layer. ``rows`` keeps only
    those rows of each batch and draw (the half-batch fault). Returns the
    per-step loss and parts, the last step's gradients, and the
    parameters and EMA after the last step."""
    P = {k: v.detach().clone().requires_grad_() for k, v in P0.items()}
    M = masks(c, next(iter(P.values())).device)
    state = {"m": {k: torch.zeros_like(v) for k, v in P.items()},
             "u": {k: torch.zeros_like(v) for k, v in P.items()},
             "ema": {k: v.detach().clone() for k, v in P.items()}}
    out = {"loss": [], "parts": [], "grad": None}
    for t, (batch, eps) in enumerate(zip(batches, noises)):
        if rows is not None:
            batch, eps = batch[rows], [e[rows] for e in eps]
        f = forward(c, P, M, batch, eps, quant=quant)
        # the top layer's up_conv3 feeds nothing: its gradient is zero
        grads = torch.autograd.grad(f["loss"], list(P.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(P[k]) if g is None else g
                 for k, g in zip(P, grads)}
        out["loss"].append(float(f["loss"].detach()))
        out["parts"].append(parts_of(f))
        if t == len(batches) - 1:
            out["grad"] = {k: g.detach().clone() for k, g in grads.items()}
        adamax_polyak(P, grads, state, c)
    out["params"] = {k: v.detach() for k, v in P.items()}
    out["ema"] = state["ema"]
    return out


def parts_of(f: dict) -> torch.Tensor:
    """The loss's parts compared: the mean free-bits KL, the mean KL, the
    mean log p(x|z) and each layer's mean KL."""
    return torch.cat([torch.stack([f["kl_obj"], f["kl_cost"],
                                   f["log_pxz_mean"]]),
                      f["kl_per_layer"]]).detach().double().cpu()


# --------------------------------------------------------------- eval

def iw_nll(c: dict, P: dict, images: torch.Tensor, eps_rows, k: int,
           block: int, quant=None) -> torch.Tensor:
    """Each image's negative k-sample importance-weighted bound in nats:
    -(logsumexp of its k log-weights - log k), the log-weights computed
    ``block`` rows at a time. ``eps_rows(i, lo, hi)`` gives image i's
    draws of samples lo .. hi - 1 per layer."""
    M = masks(c, next(iter(P.values())).device)
    out = []
    with torch.no_grad():
        for i in range(images.shape[0]):
            log_w = []
            for lo in range(0, k, block):
                hi = min(k, lo + block)
                f = forward(c, P, M, images[i:i + 1], eps_rows(i, lo, hi),
                            k=hi - lo, quant=quant)
                log_w.append(f["log_w"].double())
            lw = torch.cat(log_w)
            out.append(-(torch.logsumexp(lw, 0) - math.log(k)))
    return torch.stack(out).cpu()


def fp8_quant(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, with a straight-through gradient."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t).detach()
