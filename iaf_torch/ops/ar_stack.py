"""K1: the fused masked AR conv net of one IAF step (``csrc/ar_stack.cu``).

Replaces ``iaf_tpu/ops/ar_stack.py:_stack_kernel``. ``ar_stack`` launches
the CUDA kernel for CUDA tensors and runs ``ar_stack_ref``, its plain
PyTorch twin (the counterpart of ``ar_stack_xla``), for CPU tensors only.
Layouts are the JAX ones: activations NHWC, weights HWIO.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from iaf_torch.nn.masks import nonzero_taps
from iaf_torch.ops import _build

LIVE_TAPS = ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1))
_MAX_CONVS = 4
_PX = 8                     # output pixels per thread item (ar_stack.cu PX)
_SMEM_LIMIT = 232_448       # dynamic shared memory a Hopper block may use
_MMA_WARPS = 10             # tensor-core path's block size cap (launch bounds)

launches = {"ar_stack": 0}  # kernel launches since the last reset


def conv_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, padding) -> torch.Tensor:
    """Stride-1 conv, NHWC in and out, HWIO weights, explicit
    ``((top, bottom), (left, right))`` zero padding; f32 output."""
    (pt, pb), (pl, pr) = padding
    xt = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    out = F.conv2d(xt, w_hwio.permute(3, 2, 0, 1))
    return out.float().permute(0, 2, 3, 1)


def ar_stack_ref(z: torch.Tensor, context: torch.Tensor,
                 weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """The chain in plain ops on the row-trimmed weights: each 3x3 AR conv
    keeps kernel rows {0, 1} with padding ((1, 0), (1, 1)), exactly the
    SAME conv. Conv inputs run in the weights' dtype (bf16 convs round
    their output, as XLA's do); bias, context add and ELU are f32."""
    h = z
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = conv_nhwc(h.to(w.dtype), w[:2], ((1, 0), (1, 1))) + b
        if i == 0:
            h = h + context
        if i < n - 1:
            h = F.elu(h)
    return h


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, cin, cout] -> [5, cin, cout], the live taps in kernel order
    (FMA path)."""
    return torch.stack([w[dy, dx] for dy, dx in LIVE_TAPS]).contiguous()


def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, cin, cout] -> the live taps in mma.sync B-fragment order,
    [5, cout/8, cin/16, 8 (g), 4 (tig), 2 (k half), 2]: lane g*4+tig of
    the warp holds output n-tile*8+g and inputs k-step*16 + half*8 +
    tig*2 + {0, 1} (tensor-core path)."""
    cin, cout = w.shape[2], w.shape[3]
    t = torch.stack([w[dy, dx].t() for dy, dx in LIVE_TAPS])  # [5,cout,cin]
    t = t.reshape(5, cout // 8, 8, cin // 16, 2, 4, 2)
    return t.permute(0, 1, 3, 2, 5, 4, 6).contiguous()


def mma_path(dtype: torch.dtype, w: int, cz: int, ch: int, cout: int) -> bool:
    """Whether K1 runs on the tensor cores: bf16, rows of whole 16-pixel
    tiles, channel counts in whole 16-deep steps and 8-wide tiles."""
    return (dtype == torch.bfloat16 and w % 16 == 0 and cz % 16 == 0
            and ch % 16 == 0 and cout % 8 == 0)


def _check(z, context, weights, biases, masks):
    if not 2 <= len(weights) <= _MAX_CONVS:
        raise ValueError(f"ar_stack takes 2..{_MAX_CONVS} convs, "
                         f"got {len(weights)}")
    if not len(weights) == len(biases) == len(masks):
        raise ValueError("weights, biases and masks differ in length")
    if z.dim() != 4 or context.dim() != 4:
        raise ValueError("z and context must be NHWC")
    n, h, w_, cz = z.shape
    ch = weights[0].shape[-1]
    if context.shape != (n, h, w_, ch):
        raise ValueError(f"context {tuple(context.shape)} != "
                         f"{(n, h, w_, ch)}")
    prev = cz
    for i, (w, b, m) in enumerate(zip(weights, biases, masks)):
        m = np.asarray(m)
        if w.shape[:3] != (3, 3, prev) or m.shape != tuple(w.shape):
            raise ValueError(f"conv {i}: weight {tuple(w.shape)}, mask "
                             f"{m.shape}, expected [3, 3, {prev}, cout]")
        if not set(nonzero_taps(m)) <= set(LIVE_TAPS):
            raise ValueError(f"conv {i}: mask has taps outside the raster "
                             "AR pattern")
        if i < len(weights) - 1 and w.shape[-1] != ch:
            raise ValueError("hidden widths must be uniform")
        if b.shape != (w.shape[-1],) or b.dtype != torch.float32:
            raise ValueError(f"conv {i}: bias must be f32 [{w.shape[-1]}]")
        if w.dtype != z.dtype:
            raise ValueError(f"conv {i}: weight dtype {w.dtype} != z dtype "
                             f"{z.dtype}")
        prev = w.shape[-1]
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"z dtype {z.dtype} not in (float32, bfloat16)")
    if context.dtype != torch.float32:
        raise TypeError("context must be float32")


def _lib():
    lib = _build.load("ar_stack")
    if not getattr(lib, "_iaf_typed", False):
        lib.ar_stack_fwd.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        lib.ar_stack_fwd.restype = ctypes.c_int
        lib.ar_stack_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.ar_stack_smem_bytes.restype = ctypes.c_size_t
        lib._iaf_typed = True
    return lib


def ar_stack(z: torch.Tensor, context: torch.Tensor,
             weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
             masks: Sequence[np.ndarray]) -> torch.Tensor:
    """Run the masked AR chain: ``weights`` are the folded, pre-masked
    [3, 3, cin, cout] convs (hidden ones first, the merged head last) in
    z's dtype, ``biases`` f32, ``masks`` the static numpy masks (only their
    tap structure is read). Returns the heads, [N, H, W, cout] f32."""
    _check(z, context, weights, biases, masks)
    if z.device.type == "cpu":
        return ar_stack_ref(z, context, weights, biases)
    if z.device.type != "cuda":
        raise RuntimeError(f"ar_stack: no kernel for device {z.device}")
    tensors = [z, context, *weights, *biases]
    if any(t.device != z.device for t in tensors):
        raise RuntimeError("ar_stack: inputs on different devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("ar_stack: forward-only kernel; run under "
                           "torch.inference_mode()")
    if not all(t.is_contiguous() for t in (z, context, *biases)):
        raise ValueError("ar_stack: z, context and biases must be "
                         "contiguous")
    n, h, w_, cz = z.shape
    ch, cout = weights[0].shape[-1], weights[-1].shape[-1]
    mma = mma_path(z.dtype, w_, cz, ch, cout)
    packed = [pack_fragments(w) if mma else pack_weights(w) for w in weights]
    n_convs = len(weights)
    bf16 = int(z.dtype == torch.bfloat16)
    lib = _lib()
    smem = lib.ar_stack_smem_bytes(n_convs, w_, cz, ch, bf16, int(mma))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"ar_stack: {smem} B of shared memory per block "
                         f"exceeds {_SMEM_LIMIT}")
    if mma:   # a warp per pair of 8-wide output tiles, at most 10 warps
        threads = 32 * min(_MMA_WARPS, -(-max(ch, cout) // 16))
    else:     # one thread per output channel and PX-pixel group
        threads = 32 * -(-(max(ch, cout) * -(-w_ // _PX)) // 32)
    threads = min(1024, threads)
    out = torch.empty((n, h, w_, cout), device=z.device, dtype=torch.float32)
    wptr = [t.data_ptr() for t in packed] + [None] * (_MAX_CONVS - n_convs)
    bptr = [t.data_ptr() for t in biases] + [None] * (_MAX_CONVS - n_convs)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.ar_stack_fwd(z.data_ptr(), context.data_ptr(), *wptr,
                               *bptr, out.data_ptr(), n_convs, n, h, w_, cz,
                               ch, cout, bf16, int(mma), threads, stream)
    if err != 0:
        raise RuntimeError(f"ar_stack kernel launch failed: CUDA error {err}")
    launches["ar_stack"] += 1
    return out
