"""K1: the fused masked AR conv net of one IAF step (``csrc/ar_stack.cu``)
and its backward (``csrc/ar_stack_bwd.cu``).

Replaces ``iaf_tpu/ops/ar_stack.py:_stack_kernel`` and its ``_bwd``.
``ar_stack`` launches the CUDA kernel for CUDA tensors and runs
``ar_stack_ref``, its plain PyTorch twin (the counterpart of
``ar_stack_xla``), for CPU tensors only. Under autograd on CUDA it is a
``torch.autograd.Function``: the forward kernel also writes the hidden
convs' pre-activations, and ``ar_stack_bwd`` runs the dgrad and wgrad
kernels over them; on the CPU autograd differentiates the twin
(``ar_stack_bwd_ref``). Layouts are the JAX ones: activations NHWC,
weights HWIO.
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
_MAX_CONVS = 32             # the kernel arguments' pointer arrays (MAX_CONVS)
_PX = 8                     # output pixels per thread item (ar_stack.cu PX)
_SMEM_LIMIT = 232_448       # dynamic shared memory a Hopper block may use
_MMA_WARPS = 10             # tensor-core path's block size cap (launch bounds)

_WGRAD_CHUNKS = 64          # wgrad partials: pixel-row chunks per conv

launches = {"ar_stack": 0, "ar_stack_bwd": 0}  # launches since the reset


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


def ar_stack_bwd_ref(z, context, weights, biases, g):
    """The plain backward: autograd of the twin. Returns (dz, dcontext,
    [dW per conv, 3x3 HWIO], [db per conv])."""
    with torch.enable_grad():
        z_, c_ = (t.detach().requires_grad_() for t in (z, context))
        ws = [w.detach().requires_grad_() for w in weights]
        bs = [b.detach().requires_grad_() for b in biases]
        out = ar_stack_ref(z_, c_, ws, bs)
        grads = torch.autograd.grad(out, [z_, c_, *ws, *bs], g)
    n = len(weights)
    return grads[0], grads[1], list(grads[2:2 + n]), list(grads[2 + n:])


def _live_taps(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, cin, cout] -> [5, cin, cout]: the live taps are the first
    five of the nine in raster order (``LIVE_TAPS``), so this is a view of
    a contiguous ``w``."""
    return w.reshape(9, w.shape[2], w.shape[3])[:5]


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, cin, cout] -> [5, cin, cout], the live taps in kernel order
    (FMA path)."""
    return _live_taps(w).contiguous()


def tap_fragments(t: torch.Tensor) -> torch.Tensor:
    """[taps, cin, cout] -> mma.sync B-fragment order, [taps, cout/8,
    cin/16, 8 (g), 4 (tig), 2 (k half), 2]: lane g*4+tig of the warp holds
    output n-tile*8+g and inputs k-step*16 + half*8 + tig*2 + {0, 1}
    (the tensor-core paths of K1 and K2). One copy."""
    taps, cin, cout = t.shape
    t = t.transpose(1, 2).reshape(taps, cout // 8, 8, cin // 16, 2, 4, 2)
    return t.permute(0, 1, 3, 2, 5, 4, 6).contiguous()


def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, cin, cout] -> the live taps in B-fragment order (K1's
    tensor-core path)."""
    return tap_fragments(_live_taps(w))


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


def pack_weights_t(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, cin, cout] -> [5, cout, cin], the live taps transposed
    (dgrad), in one copy: dgrad's threads run over input channels, and
    this layout makes their weight loads coalesced."""
    return _live_taps(w).transpose(1, 2).contiguous()


def _lib():
    lib = _build.load("ar_stack")
    if not getattr(lib, "_iaf_typed", False):
        lib.ar_stack_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        lib.ar_stack_fwd.restype = ctypes.c_int
        lib.ar_stack_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.ar_stack_smem_bytes.restype = ctypes.c_size_t
        lib._iaf_typed = True
    return lib


def _bwd_lib():
    lib = _build.load("ar_stack_bwd")
    if not getattr(lib, "_iaf_typed", False):
        lib.ar_stack_dgrad.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.ar_stack_wgrad.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ar_stack_wreduce.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        for fn in (lib.ar_stack_dgrad, lib.ar_stack_wgrad,
                   lib.ar_stack_wreduce):
            fn.restype = ctypes.c_int
        lib._iaf_typed = True
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _ptrs(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers, for a C entry."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def ar_stack_fits(n_convs: int, w: int, cz: int, ch: int, cout: int,
                  dtype: torch.dtype, smem_bytes=None) -> bool:
    """Whether K1's kernel takes a chain of ``n_convs`` convs at width
    ``w``, input channels ``cz``, hidden ``ch`` and head ``cout`` in
    ``dtype``: its rings fit one Hopper block's shared memory. The byte
    count is the kernel's own (``ar_stack_smem_bytes``, or ``smem_bytes``
    with the same arguments); nothing is launched. ``ar_stack`` raises on
    a chain that does not fit, and ``ARMultiConv2d`` sends it conv by conv
    through K2 instead."""
    if smem_bytes is None:
        smem_bytes = _lib().ar_stack_smem_bytes
    mma = mma_path(dtype, w, cz, ch, cout)
    return smem_bytes(n_convs, w, cz, ch, int(dtype == torch.bfloat16),
                      int(mma)) <= _SMEM_LIMIT


def _check_smem(lib, n_convs, w_, cz, ch, cout, dtype) -> None:
    """Raise when the chain's rings do not fit one block's shared memory,
    naming the most convs that fit at these widths."""
    if ar_stack_fits(n_convs, w_, cz, ch, cout, dtype,
                     lib.ar_stack_smem_bytes):
        return
    bf16 = int(dtype == torch.bfloat16)
    mma = int(mma_path(dtype, w_, cz, ch, cout))
    smem = lib.ar_stack_smem_bytes(n_convs, w_, cz, ch, bf16, mma)
    fit = max([k for k in range(2, n_convs)
               if lib.ar_stack_smem_bytes(k, w_, cz, ch, bf16, mma)
               <= _SMEM_LIMIT], default=0)
    path = "tensor-core" if mma else ("bf16" if bf16 else "f32") + " FMA"
    raise ValueError(
        f"ar_stack: {n_convs} convs (depth_ar={n_convs - 1}) need {smem} B "
        f"of shared memory per block; a Hopper block has {_SMEM_LIMIT}. At "
        f"W={w_}, cz={cz}, ch={ch} the {path} path holds at most {fit} "
        f"convs (depth_ar <= {fit - 1})")


def _fwd(z, context, weights, biases, save_pre: bool):
    """Launch the forward kernel; with ``save_pre`` also return the hidden
    convs' f32 pre-activations for the backward."""
    tensors = [z, context, *weights, *biases]
    if any(t.device != z.device for t in tensors):
        raise RuntimeError("ar_stack: inputs on different devices")
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
    _check_smem(lib, n_convs, w_, cz, ch, cout, z.dtype)
    if mma:   # a warp per pair of 8-wide output tiles, at most 10 warps
        threads = 32 * min(_MMA_WARPS, -(-max(ch, cout) // 16))
    else:     # one thread per output channel and PX-pixel group
        threads = 32 * -(-(max(ch, cout) * -(-w_ // _PX)) // 32)
    threads = min(1024, threads)
    out = torch.empty((n, h, w_, cout), device=z.device, dtype=torch.float32)
    pre = [torch.empty((n, h, w_, ch), device=z.device, dtype=torch.float32)
           for _ in range(n_convs - 1)] if save_pre else []
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.ar_stack_fwd(z.data_ptr(), context.data_ptr(),
                               _ptrs(packed), _ptrs(biases), out.data_ptr(),
                               _ptrs(pre) if pre else None, n_convs, n, h,
                               w_, cz, ch, cout, bf16, int(mma), threads,
                               stream)
    _raise_on(err, "ar_stack")
    launches["ar_stack"] += 1
    return out, pre


def ar_stack_bwd(z, weights, pre, g):
    """K1's backward kernels: from the forward's input ``z``, weights and
    saved pre-activations ``pre`` and the output gradient ``g`` [N,H,W,cout]
    f32, return (dz in z's dtype, dcontext f32, [dW per conv, 3x3 HWIO in
    the weights' dtype, zero at the dead taps], [db per conv, f32]). Per
    conv, head first: the wgrad kernel's chunk partials, their in-order
    sum, then the dgrad kernel (times ELU' of the conv's input)."""
    if z.device.type != "cuda":
        raise RuntimeError(f"ar_stack_bwd: no kernel for device {z.device}")
    n, h, w_, _ = z.shape
    ch, cout = weights[0].shape[-1], weights[-1].shape[-1]
    if len(pre) != len(weights) - 1:
        raise ValueError("ar_stack_bwd: one pre-activation per hidden conv")
    for t, shape in [(g, (n, h, w_, cout))] + [(p, (n, h, w_, ch))
                                               for p in pre]:
        if t.device != z.device:
            raise RuntimeError("ar_stack_bwd: inputs on different devices")
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"ar_stack_bwd: g and pre must be contiguous "
                             f"float32 {shape}")
    if not z.is_contiguous() or any(w.dtype != z.dtype for w in weights):
        raise ValueError("ar_stack_bwd: z must be contiguous and the "
                         "weights in its dtype")
    bf16 = int(z.dtype == torch.bfloat16)
    lib = _bwd_lib()
    dev = z.device
    rows = n * h
    rows_per_chunk = -(-rows // _WGRAD_CHUNKS)
    chunks = -(-rows // rows_per_chunk)
    n_convs = len(weights)
    dws, dbs = [None] * n_convs, [None] * n_convs
    dctx = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c in reversed(range(n_convs)):
            w = weights[c]
            cin, cout = w.shape[2], w.shape[3]
            src = pre[c - 1] if c > 0 else None
            part = torch.empty((chunks, 5 * cin * cout + cout), device=dev,
                               dtype=torch.float32)
            _raise_on(lib.ar_stack_wgrad(
                None if src is not None else z.data_ptr(),
                src.data_ptr() if src is not None else None, g.data_ptr(),
                part.data_ptr(), n, h, w_, cin, cout, rows_per_chunk, bf16,
                stream), "ar_stack wgrad")
            dws[c] = torch.empty(w.shape, device=dev, dtype=w.dtype)
            dbs[c] = torch.empty((cout,), device=dev, dtype=torch.float32)
            _raise_on(lib.ar_stack_wreduce(
                part.data_ptr(), dws[c].data_ptr(), dbs[c].data_ptr(),
                chunks, cin, cout, bf16, stream), "ar_stack wreduce")
            wt = pack_weights_t(w)
            dx = torch.empty((n, h, w_, cin), device=dev,
                             dtype=torch.float32 if c > 0 else z.dtype)
            _raise_on(lib.ar_stack_dgrad(
                g.data_ptr(), wt.data_ptr(),
                src.data_ptr() if src is not None else None, dx.data_ptr(),
                n, h, w_, cin, cout, bf16, stream), "ar_stack dgrad")
            if c == 1:
                dctx = dx      # conv 0's output gradient is the context's
            g = dx
    launches["ar_stack_bwd"] += 1
    return g, dctx, dws, dbs


class _ARStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, context, n_convs, *wb):
        weights, biases = list(wb[:n_convs]), list(wb[n_convs:])
        out, pre = _fwd(z, context, weights, biases, save_pre=True)
        ctx.n_convs = n_convs
        ctx.save_for_backward(z, *weights, *pre)
        return out

    @staticmethod
    def backward(ctx, g):
        n = ctx.n_convs
        saved = ctx.saved_tensors
        z, weights, pre = saved[0], list(saved[1:1 + n]), list(saved[1 + n:])
        dz, dctx, dws, dbs = ar_stack_bwd(z, weights, pre, g.contiguous())
        return (dz, dctx, None, *dws, *dbs)


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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (z, context, *weights, *biases)):
        return _ARStack.apply(z, context, len(weights), *weights, *biases)
    return _fwd(z, context, weights, biases, save_pre=False)[0]
