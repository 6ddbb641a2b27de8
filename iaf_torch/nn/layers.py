"""Weight-normalized layers with data-dependent init, and the masked AR
conv net (``iaf_tpu/nn/layers.py``).

Each layer is an ``nn.Module`` holding ``V``/``g``/``b`` parameters;
``ARMultiConv2d`` and ``ARMultiDense`` hold the masked AR nets of the
two model families' IAF steps.
Conv weights are stored in PyTorch's layouts (``V`` of a conv is
[out, in, kh, kw], of a deconv [in, out, kh, kw]); activations at every
public function are NHWC, as in JAX, and convs run on a channels-last
view of them. Two modes, as in the JAX ``Ctx``:

* ``init_forward`` — data-dependent init: the conv runs with the
  l2-normalized (and masked) ``V`` in f32, ``g`` and ``b`` are set from the
  activation moments of the batch, and the normalized activations return.
* ``forward`` — apply: W = V/|V| * g (* mask), conv inputs cast to the
  compute dtype with f32 accumulation, then + b.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from iaf_torch import ops
from iaf_torch.nn.masks import (get_conv_ar_mask, get_linear_ar_mask,
                                nonzero_taps)

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(name: str | None) -> torch.dtype | None:
    """The conv input dtype for a config's ``compute_dtype`` string."""
    return _DTYPES[name]


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding (before, after) for one spatial dim."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _wn_direction(V: torch.Tensor, dims: tuple[int, ...],
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """l2-normalize V over ``dims`` (per output unit), then mask."""
    v = V * torch.rsqrt(torch.sum(torch.square(V), dim=dims, keepdim=True)
                        + 1e-12)
    return v if mask is None else v * mask


def _data_dep_out(layer: nn.Module, x_init: torch.Tensor,
                  dims: tuple[int, ...], init_scale: float) -> torch.Tensor:
    """Set g, b from the moments of ``x_init`` and return the normalized
    activations; the 1e3 cap guards zero-variance channels."""
    m = torch.mean(x_init, dim=dims)
    v = torch.var(x_init, dim=dims, unbiased=False)
    scale = torch.clamp(init_scale * torch.rsqrt(v + 1e-10), max=1e3)
    with torch.no_grad():
        layer.g.copy_(scale)
        layer.b.copy_(-m * scale)
    return (x_init - m) * scale


def _conv(x: torch.Tensor, w_oihw: torch.Tensor, stride: Sequence[int],
          pads: Sequence[tuple[int, int]],
          dtype: torch.dtype | None) -> torch.Tensor:
    """NHWC conv with explicit ((top, bottom), (left, right)) padding; f32
    out. With a bf16 ``dtype`` the inputs and the output are bf16, as in
    XLA, and the output is widened to f32."""
    if dtype is not None:
        x, w_oihw = x.to(dtype), w_oihw.to(dtype)
    (pt, pb), (pl, pr) = pads
    xt = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    out = F.conv2d(xt, w_oihw, stride=tuple(stride))
    return out.float().permute(0, 2, 3, 1)


def fold_wn(V: torch.Tensor, g: torch.Tensor, dims: tuple[int, ...],
            out_dim: int) -> torch.Tensor:
    """W = V/|V| * g, the weight-norm fold (``fold_wn_tree`` per layer)."""
    shape = [1] * V.dim()
    shape[out_dim] = -1
    return _wn_direction(V, dims) * g.reshape(shape)


class WNConv2d(nn.Module):
    """Weight-normalized conv (``conv2d``), NHWC. ``mask`` (HWIO 0/1 numpy)
    makes it an AR conv; ``trim_rows`` drops the all-zero kernel rows
    below the centre and pads asymmetrically instead (same result)."""

    def __init__(self, n_in: int, n_out: int, filter_size=(3, 3),
                 stride=(1, 1), init_scale: float = 1.0,
                 mask: np.ndarray | None = None, trim_rows: bool = False,
                 device=None):
        super().__init__()
        kh, kw = filter_size
        self.filter_size, self.stride = (kh, kw), tuple(stride)
        self.init_scale = init_scale
        self.V = nn.Parameter(torch.zeros(n_out, n_in, kh, kw, device=device))
        self.g = nn.Parameter(torch.ones(n_out, device=device))
        self.b = nn.Parameter(torch.zeros(n_out, device=device))
        self.trim_row = None
        if mask is not None:
            self.register_buffer(
                "mask", torch.from_numpy(
                    np.ascontiguousarray(mask.transpose(3, 2, 0, 1))).to(device),
                persistent=False)
            nz = np.flatnonzero(mask.reshape(kh, -1).any(axis=1))
            if (trim_rows and self.stride == (1, 1) and kh % 2 == 1
                    and nz.size and nz[-1] != kh - 1):
                self.trim_row = int(nz[-1])
        else:
            self.mask = None

    def _pads(self, x: torch.Tensor):
        kh, kw = self.filter_size
        if self.trim_row is not None:
            l, m = (kh - 1) // 2, (kw - 1) // 2
            return ((l, self.trim_row - l), (m, m))
        return (same_pads(x.shape[1], kh, self.stride[0]),
                same_pads(x.shape[2], kw, self.stride[1]))

    def _run(self, x, w_oihw, dtype):
        if self.trim_row is not None:
            w_oihw = w_oihw[:, :, :self.trim_row + 1]
        return _conv(x, w_oihw, self.stride, self._pads(x), dtype)

    def weight(self) -> torch.Tensor:
        """Folded, masked weights, [out, in, kh, kw] f32."""
        W = fold_wn(self.V, self.g, (1, 2, 3), 0)
        return W if self.mask is None else W * self.mask

    def weight_hwio(self) -> torch.Tensor:
        return self.weight().permute(2, 3, 1, 0)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        return self._run(x, self.weight(), dtype) + self.b

    def init_forward(self, x: torch.Tensor) -> torch.Tensor:
        x_init = self._run(x, _wn_direction(self.V, (1, 2, 3), self.mask),
                           None)
        return _data_dep_out(self, x_init, (0, 1, 2), self.init_scale)


class WNDeconv2d(nn.Module):
    """Weight-normalized transposed conv (``deconv2d``), NHWC.

    JAX's ``lax.conv_transpose(x, k, s, "SAME")`` with the kernel not
    transposed is: dilate x by s, pad (a, b) with a = ceil((k+s-2)/2),
    b = k+s-2-a, and correlate with the unflipped kernel. PyTorch's
    ``conv_transpose2d`` correlates with the flipped kernel and pads k-1-p
    on both sides, so the same map is the flipped kernel, p = k-1-a, and a
    crop of the extra trailing rows and columns to s*H x s*W."""

    def __init__(self, n_in: int, n_out: int, filter_size=(3, 3),
                 stride=(2, 2), init_scale: float = 1.0, device=None):
        super().__init__()
        kh, kw = filter_size
        self.filter_size, self.stride = (kh, kw), tuple(stride)
        self.init_scale = init_scale
        self.V = nn.Parameter(torch.zeros(n_in, n_out, kh, kw, device=device))
        self.g = nn.Parameter(torch.ones(n_out, device=device))
        self.b = nn.Parameter(torch.zeros(n_out, device=device))
        self.padding = []
        for k, s in zip(self.filter_size, self.stride):
            pad_len = k + s - 2
            a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
            if pad_len - a > a:
                raise NotImplementedError(
                    f"deconv SAME k={k} s={s}: trailing pad exceeds leading")
            self.padding.append(k - 1 - a)

    def _run(self, x, w_iohw, dtype):
        if dtype is not None:
            x, w_iohw = x.to(dtype), w_iohw.to(dtype)
        h, w = x.shape[1], x.shape[2]
        out = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                                 torch.flip(w_iohw, (2, 3)),
                                 stride=self.stride,
                                 padding=tuple(self.padding))
        out = out[..., :h * self.stride[0], :w * self.stride[1]]
        return out.float().permute(0, 2, 3, 1)

    def weight(self) -> torch.Tensor:
        return fold_wn(self.V, self.g, (0, 2, 3), 1)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        return self._run(x, self.weight(), dtype) + self.b

    def init_forward(self, x: torch.Tensor) -> torch.Tensor:
        x_init = self._run(x, _wn_direction(self.V, (0, 2, 3)), None)
        return _data_dep_out(self, x_init, (0, 1, 2), self.init_scale)


class WNDense(nn.Module):
    """Weight-normalized dense layer over the last axis (``dense``/``nin``);
    ``V`` is [out, in] and ``mask`` ([in, out] numpy) makes it MADE."""

    def __init__(self, n_in: int, n_out: int, init_scale: float = 1.0,
                 mask: np.ndarray | None = None, device=None):
        super().__init__()
        self.init_scale = init_scale
        self.V = nn.Parameter(torch.zeros(n_out, n_in, device=device))
        self.g = nn.Parameter(torch.ones(n_out, device=device))
        self.b = nn.Parameter(torch.zeros(n_out, device=device))
        if mask is None:
            self.mask = None
        else:
            self.register_buffer("mask", torch.from_numpy(
                np.ascontiguousarray(mask.T)).to(device), persistent=False)

    def _run(self, x, w, dtype):
        """With a bf16 ``dtype`` the inputs are rounded to bf16 and the
        product is summed and returned in f32, as JAX's ``dense`` asks
        (``preferred_element_type=float32``): the products of bf16 values
        are exact in f32."""
        if dtype is not None:
            x, w = x.to(dtype).float(), w.to(dtype).float()
        return F.linear(x, w)

    def weight(self) -> torch.Tensor:
        W = fold_wn(self.V, self.g, (1,), 0)
        return W if self.mask is None else W * self.mask

    def forward(self, x, dtype=None):
        return self._run(x, self.weight(), dtype) + self.b

    def init_forward(self, x):
        x_init = self._run(x, _wn_direction(self.V, (1,), self.mask), None)
        return _data_dep_out(self, x_init, tuple(range(x_init.dim() - 1)),
                             self.init_scale)


def nin(n_in: int, n_out: int, init_scale: float = 1.0, device=None):
    """1x1 'network-in-network' conv as a dense over channels."""
    return WNDense(n_in, n_out, init_scale=init_scale, device=device)


class ARMultiConv2d(nn.Module):
    """Masked conv net computing the IAF (m, s) heads
    (``ar_multiconv2d``): hidden masked convs (the first zero-diagonal,
    context added after it, ELU after each), then the heads. With
    ``merge_heads`` the heads are one conv (``layer_out``) over the
    concatenated masks, else one conv per head (``layer_out_{i}``)."""

    def __init__(self, n_in: int, n_h: Sequence[int], n_out: Sequence[int],
                 filter_size=(3, 3), trim_rows: bool = True,
                 merge_heads: bool = True, device=None):
        super().__init__()
        kh, kw = filter_size
        self.n_out = list(n_out)
        self.merge_heads = merge_heads
        self.masks: list[np.ndarray] = []
        prev = n_in
        for i, size in enumerate(n_h):
            mask = get_conv_ar_mask(kh, kw, prev, size, zerodiagonal=(i == 0))
            self.add_module(f"layer_{i}", WNConv2d(
                prev, size, filter_size, mask=mask, trim_rows=trim_rows,
                device=device))
            self.masks.append(mask)
            prev = size
        self.n_hidden = len(n_h)
        head_masks = [get_conv_ar_mask(kh, kw, prev, size, False)
                      for size in n_out]
        if merge_heads:
            mask = np.concatenate(head_masks, axis=-1)
            self.layer_out = WNConv2d(prev, sum(n_out), filter_size,
                                      mask=mask, trim_rows=trim_rows,
                                      device=device)
        else:
            for i, (size, m) in enumerate(zip(n_out, head_masks)):
                self.add_module(f"layer_out_{i}", WNConv2d(
                    prev, size, filter_size, mask=m, trim_rows=trim_rows,
                    device=device))
        self.masks.append(np.concatenate(head_masks, axis=-1))
        self.taps = [nonzero_taps(m) for m in self.masks]
        self.fusable = (tuple(filter_size) == (3, 3) and len(n_h) >= 1
                        and len(set(n_h)) == 1)

    def hidden(self) -> list[WNConv2d]:
        return [getattr(self, f"layer_{i}") for i in range(self.n_hidden)]

    def heads(self) -> list[WNConv2d]:
        if self.merge_heads:
            return [self.layer_out]
        return [getattr(self, f"layer_out_{i}")
                for i in range(len(self.n_out))]

    def _split(self, out):
        outs, start = [], 0
        for size in self.n_out:
            outs.append(out[..., start:start + size])
            start += size
        return outs

    def folded(self, dtype: torch.dtype | None = None):
        """Per conv the folded, masked HWIO weight (in ``dtype``) and the
        f32 bias, heads concatenated last: K1's operands."""
        ws = [c.weight_hwio() for c in self.hidden()]
        bs = [c.b for c in self.hidden()]
        heads = self.heads()
        ws.append(torch.cat([c.weight_hwio() for c in heads], dim=-1))
        bs.append(torch.cat([c.b for c in heads], dim=-1))
        if dtype is not None:
            ws = [w.to(dtype) for w in ws]
        return ws, bs

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                dtype: torch.dtype | None = None) -> list[torch.Tensor]:
        """The whole chain through K1 (``ops.ar_stack``: the CUDA kernel on
        CUDA tensors, its twin on CPU tensors) where it applies (3x3,
        uniform hidden widths, and on CUDA a chain that fits one block:
        ``k1_fits``), else conv by conv through K2."""
        if not self.fusable:
            return self.forward_unfused(x, context, dtype)
        ws, bs = self.folded(dtype)
        # K1 takes NHWC-contiguous tensors; cuDNN may return a conv's
        # output in NCHW memory, which z and context then inherit
        z = (x if dtype is None else x.to(dtype)).contiguous()
        if not self.k1_fits(z, ws):
            return self.forward_unfused(x, context, dtype)
        return self._split(ops.ar_stack(z, context.contiguous(), ws, bs,
                                        self.masks))

    @staticmethod
    def k1_fits(z: torch.Tensor, ws) -> bool:
        """Whether K1 takes this chain: always on CPU tensors (its twin
        runs any depth); on CUDA where its kernel holds the chain in one
        block's shared memory (``ops.ar_stack_fits``, decided before any
        launch)."""
        if z.device.type != "cuda":
            return True
        _, _, w, cz = z.shape
        return ops.ar_stack_fits(len(ws), w, cz, ws[0].shape[-1],
                                 ws[-1].shape[-1], z.dtype)

    def _ar_conv(self, conv: WNConv2d, h: torch.Tensor, dtype,
                 taps) -> torch.Tensor:
        """One masked conv through K2 (``ops.masked_conv2d``) over the
        mask's live taps, then + b (JAX ``conv2d``'s ``pallas`` branch)."""
        w = conv.weight_hwio()
        if dtype is not None:
            h, w = h.to(dtype), w.to(dtype)
        return ops.masked_conv2d(h.contiguous(), w, taps) + conv.b

    def forward_unfused(self, x, context, dtype=None):
        """Conv by conv through K2 (the CUDA kernel on CUDA tensors, its
        twin on CPU tensors), as JAX's ``pallas_conv`` route; bias,
        context add and ELU in PyTorch."""
        h = x
        for i, conv in enumerate(self.hidden()):
            h = self._ar_conv(conv, h, dtype, self.taps[i])
            if i == 0:
                h = h + context
            h = F.elu(h)
        if self.merge_heads:
            return self._split(self._ar_conv(self.layer_out, h, dtype,
                                             self.taps[-1]))
        return [self._ar_conv(c, h, dtype, self.taps[-1])
                for c in self.heads()]

    def init_forward(self, x, context):
        h = x
        for i, conv in enumerate(self.hidden()):
            h = conv.init_forward(h)
            if i == 0:
                h = h + context
            h = F.elu(h)
        if self.merge_heads:
            return self._split(self.layer_out.init_forward(h))
        return [c.init_forward(h) for c in self.heads()]


class ARMultiDense(nn.Module):
    """Dense MADE net computing the IAF (m, s) heads of a vector latent
    (``ar_multidense``): masked ``WNDense`` hidden layers (the first
    zero-diagonal, the context added after it, ELU after each), then one
    masked head per output (``layer_out_{i}``). Plain ``F.linear``: the
    JAX package computes it in XLA, with no kernel of its own."""

    def __init__(self, n_in: int, n_h: Sequence[int], n_out: Sequence[int],
                 device=None):
        super().__init__()
        self.n_hidden, self.n_out = len(n_h), list(n_out)
        prev = n_in
        for i, size in enumerate(n_h):
            self.add_module(f"layer_{i}", WNDense(
                prev, size, mask=get_linear_ar_mask(prev, size,
                                                    zerodiagonal=(i == 0)),
                device=device))
            prev = size
        for i, size in enumerate(n_out):
            self.add_module(f"layer_out_{i}", WNDense(
                prev, size, mask=get_linear_ar_mask(prev, size, False),
                device=device))

    def _layers(self):
        hidden = [getattr(self, f"layer_{i}") for i in range(self.n_hidden)]
        heads = [getattr(self, f"layer_out_{i}")
                 for i in range(len(self.n_out))]
        return hidden, heads

    def forward(self, x: torch.Tensor, context: torch.Tensor | None,
                dtype: torch.dtype | None = None) -> list[torch.Tensor]:
        return self._run(x, context, lambda layer, h: layer(h, dtype))

    def init_forward(self, x, context):
        return self._run(x, context, lambda layer, h: layer.init_forward(h))

    def _run(self, x, context, apply):
        hidden, heads = self._layers()
        h = x
        for i, layer in enumerate(hidden):
            h = apply(layer, h)
            if i == 0 and context is not None:
                h = h + context
            h = F.elu(h)
        return [apply(layer, h) for layer in heads]
