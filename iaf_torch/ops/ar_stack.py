"""K1: the fused masked AR conv net of one IAF step (``csrc/ar_stack.cu``)
and its backward (``csrc/ar_stack_bwd.cu``).

Replaces ``iaf_tpu/ops/ar_stack.py:_stack_kernel`` and its ``_bwd``.
``ar_stack`` launches a CUDA kernel for CUDA tensors (the tensor-core
kernel, bf16 or f32 by 3xTF32, or the FMA one, as ``fwd_route`` decides
from the dtype and the shapes) and runs
``ar_stack_ref``, its plain PyTorch twin (the counterpart of
``ar_stack_xla``), for CPU tensors only. Under autograd on CUDA it is a
``torch.autograd.Function``: the forward kernel also writes the hidden
convs' pre-activations, and ``ar_stack_bwd`` runs the dgrad and wgrad
kernels over them (K2's tensor-core kernels, bf16 or f32 by 3xTF32, with
this file's glue, pack and reduce kernels between them); on the CPU
autograd differentiates the twin (``ar_stack_bwd_ref``). Layouts are the
JAX ones: activations NHWC, weights HWIO.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from iaf_torch.ops import _build

LIVE_TAPS = ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1))
# dgrad's taps: the transpose of the causal conv reads the mirrored ones
MIRRORED_TAPS = tuple((2 - dy, 2 - dx) for dy, dx in LIVE_TAPS)
_MAX_CONVS = 32             # the kernel arguments' pointer arrays (MAX_CONVS)
_PX = 8                     # output pixels per thread item (ar_stack.cu PX)
_SMEM_LIMIT = 232_448       # dynamic shared memory a Hopper block may use
_WGMMA_W = 16               # ar_stack.cu TW: the width the wgmma kernel tiles
_KC = 32                    # masked_conv.cuh KC: K depth of one weight slice
_KF = 8                     # ar_stack.cu KF: the same in f32 (3xTF32)
_TF32_MAX = (64, 160, 160)  # ar_stack.cu: the widest cz, ch, cout in f32
_TR = 8                     # ar_stack.cu TR: rows of one tile

_WGRAD_CHUNKS = 64          # FMA wgrad partials: pixel-row chunks per conv
_GLUE_THREADS = 512         # ar_stack_bwd.cu GL_THREADS: glue block size

launches = {"ar_stack": 0, "ar_stack_bwd": 0}  # launches since the reset


def conv_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, padding) -> torch.Tensor:
    """Stride-1 conv, NHWC in and out, HWIO weights, explicit
    ``((top, bottom), (left, right))`` zero padding; f32 output (f64 for
    f64 inputs: the twin in f64 is the f32 kernels' reference)."""
    (pt, pb), (pl, pr) = padding
    xt = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    out = F.conv2d(xt, w_hwio.permute(3, 2, 0, 1))
    if out.dtype != torch.float64:
        out = out.float()
    return out.permute(0, 2, 3, 1)


def ar_stack_ref_pre(z: torch.Tensor, context: torch.Tensor,
                     weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor]):
    """The chain in plain ops on the row-trimmed weights: each 3x3 AR conv
    keeps kernel rows {0, 1} with padding ((1, 0), (1, 1)), exactly the
    SAME conv. Conv inputs run in the weights' dtype (bf16 convs round
    their output, as XLA's do); bias, context add and ELU are f32. Returns
    (the heads, [each hidden conv's f32 pre-activation])."""
    h = z
    n = len(weights)
    pre = []
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = conv_nhwc(h.to(w.dtype), w[:2], ((1, 0), (1, 1))) + b
        if i == 0:
            h = h + context
        if i < n - 1:
            pre.append(h)
            h = F.elu(h)
    return h, pre


def ar_stack_ref(z: torch.Tensor, context: torch.Tensor,
                 weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """The twin (``ar_stack_ref_pre``'s heads)."""
    return ar_stack_ref_pre(z, context, weights, biases)[0]


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


def fwd_route(dtype: torch.dtype, w: int, cz: int, ch: int, cout: int) -> str:
    """The kernel K1's forward launches for CUDA inputs, by dtype and
    shape. At the width the tensor-core kernel's tiles cover (W = 16: a
    row a warp) with cout in whole 8-wide groups:

    - ``"wgmma"`` (``ar_stack_wgmma_kernel``, bf16 wgmma) for bf16 with cz
      and ch in whole 16-deep steps, each width at most the widest wgmma N
      (``masked_conv.WGMMA_WIDTHS``);
    - ``"3xtf32"`` (the same kernel's f32 instantiation: every product as
      three TF32 wgmma products of split operands) for f32 with cz and ch
      in whole 8-deep steps, cz at most 64 and ch and cout at most 160
      (``_TF32_MAX``: f32 buffers are twice bf16's, and wider chains leave
      no room for two weight stages).

    Every other shape takes ``"fma"`` (``ar_stack_kernel``, FP32 FMA).
    Every shape a tensor-core route takes holds a two-conv chain with two
    weight stages; how deep a chain fits is ``ar_stack_fits``'s. Needs no
    built library."""
    from iaf_torch.ops.masked_conv import WGMMA_WIDTHS
    if w != _WGMMA_W or cout % 8:
        return "fma"
    if (dtype == torch.bfloat16 and cz % 16 == 0 and ch % 16 == 0
            and max(cz, ch, cout) <= WGMMA_WIDTHS[-1]):
        return "wgmma"
    if (dtype == torch.float32 and cz % 8 == 0 and ch % 8 == 0
            and all(v <= m for v, m in zip((cz, ch, cout), _TF32_MAX))):
        return "3xtf32"
    return "fma"


class FwdPlan(NamedTuple):
    """How K1's tensor-core forward spreads over the card (``fwd_plan``):
    work items of ``band`` rows of one image (``band`` = H: whole images)
    handed to ``blocks`` blocks in turn."""
    band: int
    blocks: int


def whole_plan(n: int, h: int, sms: int) -> FwdPlan:
    """The whole-image plan: one block per SM (at most one per image), each
    walking whole images as tiles of 8 rows, top to bottom."""
    return FwdPlan(band=h, blocks=min(n, sms))


@functools.lru_cache(maxsize=None)
def fwd_plan(dtype: torch.dtype, n: int, h: int, w: int, cz: int, ch: int,
             cout: int, n_convs: int, sms: int) -> FwdPlan:
    """K1's forward launch plan for ``n`` images of ``h`` x ``w`` on a card
    of ``sms`` SMs, from the shapes alone (no built library), so a graph
    captures a fixed grid. A block's time is its tiles of 8 rows one after
    another. The whole-image plan (``whole_plan``) gives ``n`` images
    ceil(h / 8) tiles each; where images are fewer than SMs the banded plan
    cuts each image into bands of 9 - n_convs rows, one tile each with the
    rows above that the chain reaches back to computed again (n_convs - 1:
    2 at the paper's 3 convs, bands of 6 rows, 3 an image), and takes it
    where that leaves a block fewer tiles. The FMA kernel (``fwd_route``
    "fma") takes one block an image, whatever the plan."""
    if fwd_route(dtype, w, cz, ch, cout) == "fma":
        return FwdPlan(band=h, blocks=n)
    whole = whole_plan(n, h, sms)
    band = _TR + 1 - n_convs
    if 1 <= band < h:
        items = n * -(-h // band)
        if -(-items // sms) < -(-n // whole.blocks) * -(-h // _TR):
            return FwdPlan(band=band, blocks=min(items, sms))
    return whole


def _slice_depth(dtype: torch.dtype) -> int:
    """K depth of one streamed weight slice: 32 in bf16, 8 in f32."""
    return _KF if dtype == torch.float32 else _KC


def _pack_dims(weights: Sequence[torch.Tensor]):
    """Per conv (cin, cout, npad) of the forward's packed weights and the
    element offset where each starts in the buffer that holds them all:
    5 live taps x K x npad, K = cin padded to whole slices (32-deep in
    bf16, 8-deep in f32)."""
    from iaf_torch.ops.masked_conv import wgmma_width
    ks = _slice_depth(weights[0].dtype)
    dims, offsets, at = [], [], 0
    for w in weights:
        cin, cout = int(w.shape[2]), int(w.shape[3])
        npad = wgmma_width(cout)
        dims.append((cin, cout, npad))
        offsets.append(at)
        at += 5 * -(-cin // ks) * ks * npad
    return dims, offsets, at


def pack_fwd_ref(weights: Sequence[torch.Tensor]):
    """The tensor-core forward's weights in plain ops: every conv's live
    taps, their input channels zero-padded to whole slices (32-deep in
    bf16, 8-deep in f32), in ``masked_conv.wgmma_pack`` order ([5, K/16,
    npad/8, 2, 8, 8] in bf16, [5, K/8, npad/8, 2, 8, 4] in f32, with K the
    padded cin and N = cout, npad = ``wgmma_width(cout)``, zero columns
    past cout), conv after conv in one flat buffer in the weights' dtype
    (f32 as it is: the kernel splits it into tf32 parts as it lands).
    Returns (the buffer, each conv's element offset in it)."""
    from iaf_torch.ops import masked_conv as mc
    _, offsets, _ = _pack_dims(weights)
    ks = _slice_depth(weights[0].dtype)
    e = 16 // weights[0].element_size()
    flat = torch.cat([mc.wgmma_pack(
        F.pad(_live_taps(w), (0, 0, 0, -w.shape[2] % ks)),
        mc.wgmma_width(w.shape[3]), e=e).reshape(-1) for w in weights])
    return flat, offsets


def pack_fwd(weights: Sequence[torch.Tensor]):
    """``pack_fwd_ref`` for every conv in one launch of
    ``ar_pack_w_kernel`` (bf16 or f32 CUDA weights of any strides)."""
    w0 = weights[0]
    if w0.device.type != "cuda":
        raise RuntimeError(f"ar_stack pack: no kernel for device "
                           f"{w0.device}")
    if (w0.dtype not in (torch.bfloat16, torch.float32)
            or any(w.dtype != w0.dtype for w in weights)):
        raise ValueError("ar_stack pack: weights must be all bf16 or all "
                         "f32")
    dims, offsets, total = _pack_dims(weights)
    flat = torch.empty((total,), device=w0.device, dtype=w0.dtype)
    strides = [s for w in weights for s in w.stride()]
    with torch.cuda.device(w0.device):
        err = _lib().ar_stack_pack_w(
            _ptrs(weights), flat.data_ptr(),
            (ctypes.c_int * (3 * len(dims)))(*[v for d in dims for v in d]),
            (ctypes.c_longlong * len(strides))(*strides), len(weights),
            int(w0.dtype == torch.float32),
            torch.cuda.current_stream(w0.device).cuda_stream)
    _raise_on(err, "ar_stack pack")
    return flat, offsets


@dataclasses.dataclass(frozen=True)
class CheckedMasks:
    """Masks that ``check_masks`` found to hold weights at the raster AR
    taps only (``LIVE_TAPS``), as their shapes. ``ar_stack`` takes it in
    place of the masks and then checks the weights' shapes against it, with
    no scan of the dead taps (an array of masks costs one on every call,
    ~0.1 ms of host at the paper widths). It holds no array: a mask
    changed in place after the check does not change it, and that array,
    passed again, is scanned again."""
    shapes: tuple[tuple[int, ...], ...]


def check_masks(masks: Sequence[np.ndarray]) -> CheckedMasks:
    """Raise ValueError where a mask is not [3, 3, cin, cout] or has a
    nonzero weight at a tap outside the raster AR pattern (the live taps
    are the first five of the nine in raster order, so the dead ones are
    the last four: one reduction over them a mask); else return the
    masks' ``CheckedMasks``."""
    shapes = []
    for i, m in enumerate(masks):
        m = np.asarray(m)
        if m.ndim != 4 or m.shape[:2] != (3, 3):
            raise ValueError(f"conv {i}: mask {m.shape} is not [3, 3, cin, "
                             "cout]")
        if m.reshape(9, -1)[len(LIVE_TAPS):].any():
            raise ValueError(f"conv {i}: mask has taps outside the raster "
                             "AR pattern")
        shapes.append(tuple(m.shape))
    return CheckedMasks(tuple(shapes))


def _check(z, context, weights, biases, masks):
    if not 2 <= len(weights) <= _MAX_CONVS:
        raise ValueError(f"ar_stack takes 2..{_MAX_CONVS} convs, "
                         f"got {len(weights)}")
    checked = masks if isinstance(masks, CheckedMasks) else None
    shapes = (checked.shapes if checked is not None
              else [np.shape(m) for m in masks])
    if not len(weights) == len(biases) == len(shapes):
        raise ValueError("weights, biases and masks differ in length")
    if z.dim() != 4 or context.dim() != 4:
        raise ValueError("z and context must be NHWC")
    n, h, w_, cz = z.shape
    ch = weights[0].shape[-1]
    if context.shape != (n, h, w_, ch):
        raise ValueError(f"context {tuple(context.shape)} != "
                         f"{(n, h, w_, ch)}")
    prev = cz
    for i, (w, b, shape) in enumerate(zip(weights, biases, shapes)):
        if w.shape[:3] != (3, 3, prev) or tuple(shape) != tuple(w.shape):
            raise ValueError(f"conv {i}: weight {tuple(w.shape)}, mask "
                             f"{tuple(shape)}, expected [3, 3, {prev}, cout]")
        if i < len(weights) - 1 and w.shape[-1] != ch:
            raise ValueError("hidden widths must be uniform")
        if b.shape != (w.shape[-1],) or b.dtype != torch.float32:
            raise ValueError(f"conv {i}: bias must be f32 [{w.shape[-1]}]")
        if w.dtype != z.dtype:
            raise ValueError(f"conv {i}: weight dtype {w.dtype} != z dtype "
                             f"{z.dtype}")
        prev = w.shape[-1]
    if checked is None:
        check_masks(masks)
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
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
            + [ctypes.c_size_t, ctypes.c_void_p])
        lib.ar_stack_pack_w.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        for fn in (lib.ar_stack_fwd, lib.ar_stack_pack_w):
            fn.restype = ctypes.c_int
        lib.ar_stack_smem_bytes.argtypes = [ctypes.c_int] * 7
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
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] * 2
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.ar_stack_glue.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.ar_stack_pack_wt.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        for fn in (lib.ar_stack_dgrad, lib.ar_stack_wgrad,
                   lib.ar_stack_wreduce, lib.ar_stack_glue,
                   lib.ar_stack_pack_wt):
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
    ``dtype``: the shared memory that the kernel ``fwd_route`` names needs
    for it (the tensor-core kernel's buffers, halo rows and two weight
    stages, bf16 or f32; the FMA kernel's rings) fits one Hopper block.
    The byte count
    is the kernel's own (``ar_stack_smem_bytes``, or ``smem_bytes`` with
    the same arguments); nothing is launched. ``ar_stack`` raises on a
    chain that does not fit, and ``ARMultiConv2d`` sends it conv by conv
    through K2 instead."""
    if smem_bytes is None:
        smem_bytes = _lib().ar_stack_smem_bytes
    tensor_cores = fwd_route(dtype, w, cz, ch, cout) != "fma"
    return smem_bytes(n_convs, w, cz, ch, cout, int(dtype == torch.bfloat16),
                      int(tensor_cores)) <= _SMEM_LIMIT


def _check_smem(lib, n_convs, w_, cz, ch, cout, dtype) -> None:
    """Raise when the chain does not fit one block's shared memory,
    naming the most convs that fit at these widths."""
    if ar_stack_fits(n_convs, w_, cz, ch, cout, dtype,
                     lib.ar_stack_smem_bytes):
        return
    bf16 = int(dtype == torch.bfloat16)
    route = fwd_route(dtype, w_, cz, ch, cout)

    def need(k):
        return lib.ar_stack_smem_bytes(k, w_, cz, ch, cout, bf16,
                                       int(route != "fma"))
    fit = max([k for k in range(2, n_convs) if need(k) <= _SMEM_LIMIT],
              default=0)
    path = {"wgmma": "tensor-core", "3xtf32": "3xTF32 tensor-core"}.get(
        route, ("bf16" if bf16 else "f32") + " FMA")
    raise ValueError(
        f"ar_stack: {n_convs} convs (depth_ar={n_convs - 1}) need "
        f"{need(n_convs)} B of shared memory per block; a Hopper block has "
        f"{_SMEM_LIMIT}. At W={w_}, cz={cz}, ch={ch} the {path} path holds "
        f"at most {fit} convs (depth_ar <= {fit - 1})")


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fwd(z, context, weights, biases, save_pre: bool,
         plan: FwdPlan | None = None):
    """Launch the forward kernel that ``fwd_route`` names, on ``plan``
    (default ``fwd_plan``'s for these shapes and the card; the tensor-core
    kernel reads it); with ``save_pre`` also return the hidden convs' f32
    pre-activations for the backward."""
    tensors = [z, context, *weights, *biases]
    if any(t.device != z.device for t in tensors):
        raise RuntimeError("ar_stack: inputs on different devices")
    if not all(t.is_contiguous() for t in (z, context, *biases)):
        raise ValueError("ar_stack: z, context and biases must be "
                         "contiguous")
    n, h, w_, cz = z.shape
    ch, cout = weights[0].shape[-1], weights[-1].shape[-1]
    n_convs = len(weights)
    bf16 = int(z.dtype == torch.bfloat16)
    lib = _lib()
    _check_smem(lib, n_convs, w_, cz, ch, cout, z.dtype)
    tensor_cores = fwd_route(z.dtype, w_, cz, ch, cout) != "fma"
    if plan is None:
        plan = fwd_plan(z.dtype, n, h, w_, cz, ch, cout, n_convs,
                        _sms(z.device.index))
    if tensor_cores:
        if z.data_ptr() % 16:
            raise ValueError("ar_stack: the tensor-core kernel needs z "
                             "16-byte aligned")
        flat, offsets = pack_fwd(weights)
        w_ptrs = (ctypes.c_void_p * n_convs)(
            *[flat.data_ptr() + flat.element_size() * o for o in offsets])
        threads = 0      # the kernel's own: two warpgroups, a producer
                         # (and in f32 two splitter warps)
    else:
        packed = [pack_weights(w) for w in weights]
        w_ptrs = _ptrs(packed)
        # one thread per output channel and PX-pixel group
        threads = min(1024, 32 * -(-(max(ch, cout) * -(-w_ // _PX)) // 32))
    out = torch.empty((n, h, w_, cout), device=z.device, dtype=torch.float32)
    pre = [torch.empty((n, h, w_, ch), device=z.device, dtype=torch.float32)
           for _ in range(n_convs - 1)] if save_pre else []
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.ar_stack_fwd(z.data_ptr(), context.data_ptr(), w_ptrs,
                               _ptrs(biases), out.data_ptr(),
                               _ptrs(pre) if pre else None, n_convs, n, h,
                               w_, cz, ch, cout, bf16, int(tensor_cores),
                               threads, plan.band, plan.blocks,
                               _SMEM_LIMIT, stream)
    _raise_on(err, "ar_stack")
    launches["ar_stack"] += 1
    return out, pre


def bwd_wgmma_path(dtype: torch.dtype, h: int, w: int,
                   shapes: Sequence[tuple[int, int]]) -> bool:
    """Whether every conv (cin, cout) of the chain has a shape that K2's
    tensor-core kernels tile in the backward: dgrad on ``wgmma_path``
    with cin and cout swapped, wgrad on ``wgrad_wgmma_path`` (bf16, W of
    16-128 with H whole 128-pixel sub-tiles, input channels in whole
    blocks of 32). Needs no built library."""
    # imported here and below: masked_conv imports this module
    from iaf_torch.ops import masked_conv as mc
    return all(mc.wgmma_path(dtype, w, co, ci)
               and mc.wgrad_wgmma_path(dtype, h, w, ci, co)
               for ci, co in shapes)


def bwd_tf32_path(dtype: torch.dtype, h: int, w: int,
                  shapes: Sequence[tuple[int, int]]) -> bool:
    """Whether every conv (cin, cout) of the chain has a shape that K2's
    3xTF32 kernels tile in the backward: dgrad on ``tf32_path`` with cin
    and cout swapped, wgrad on ``wgrad_tf32_path`` (f32, W of 16-64 with H
    whole 64-pixel sub-tiles, input channels in whole blocks of 32, at
    most 160 outputs). Needs no built library."""
    from iaf_torch.ops import masked_conv as mc
    return all(mc.tf32_path(dtype, w, co, ci)
               and mc.wgrad_tf32_path(dtype, h, w, ci, co)
               for ci, co in shapes)


def bwd_route(z: torch.Tensor, weights: Sequence[torch.Tensor]
              ) -> tuple[tuple[str, str], ...]:
    """The kernels K1's backward launches for CUDA inputs: per conv
    (dgrad's, wgrad's), each ``"wgmma"`` (bf16 tensor cores), ``"3xtf32"``
    (f32 on the tensor cores) or ``"fma"``. The chain takes the tensor
    cores where ``bwd_wgmma_path`` (bf16) or ``bwd_tf32_path`` (f32) holds
    and every conv's kernels fit shared memory (K2's own checks,
    ``masked_conv``'s ``_route`` and ``_wgrad_route``), else FMA
    throughout. Decided from the shapes before any launch (builds K2's
    libraries on first use); a launch that fails raises."""
    _, h, w_, _ = z.shape
    return _bwd_route(z.dtype, h, w_, tuple((int(w.shape[2]), int(w.shape[3]))
                                            for w in weights))


@functools.lru_cache(maxsize=None)
def _bwd_route(dtype, h, w_, shapes):
    from iaf_torch.ops import masked_conv as mc
    for route, path in (("wgmma", bwd_wgmma_path),
                        ("3xtf32", bwd_tf32_path)):
        if path(dtype, h, w_, shapes):
            routes = tuple((mc._route(dtype, w_, co, ci, 3, MIRRORED_TAPS),
                            mc._wgrad_route(dtype, h, w_, ci, co, 3, 1))
                           for ci, co in shapes)
            if all(r == (route, route) for r in routes):
                return routes
    return (("fma", "fma"),) * len(shapes)


def glue_ref(src: torch.Tensor, pre: torch.Tensor | None = None,
             f32: bool = False):
    """The glue pass in plain ops. ``src`` [N,H,W,C] is the head's f32 G,
    or, with ``pre`` (the f32 pre-activation of a hidden conv's input),
    that conv's dX (bf16; with ``f32``, the 3xTF32 chain, f32). G =
    f32(src), times ELU'(pre) = (pre > 0 ? 1 : exp(pre)) with ``pre``, as
    autograd of the twin's ELU step computes it. Returns (G in T, G in
    wgrad's packed B order as the kernel's stores place it, G in f32,
    T(ELU(pre)) or None, db = G summed over the pixels), T bf16 with the
    packed G [1, P/16, npad/8, 2, 8, 8], or with ``f32`` T f32 and the
    3xTF32 wgrad's tf32 order [1, P/8, npad/8, 2, 8, 4]."""
    from iaf_torch.ops.masked_conv import wgmma_width
    c = src.shape[-1]
    p = src.numel() // c
    npad = wgmma_width(c)
    dtype = torch.float32 if f32 else torch.bfloat16
    e = 4 if f32 else 8         # pixels of one column a 16-byte row
    g = src.float()
    x = None
    if pre is not None:
        g = torch.where(pre > 0, g, g * torch.exp(pre))
        x = F.elu(pre).to(dtype)
    gt = g.to(dtype)
    # pixel P, channel 8 j + n -> ((((P / 2e) npad/8 + j) 2 + P / e % 2) 8
    # + n) e + P % e: the kernel's 16-byte stores of e pixels of a column
    dev = src.device
    px = torch.arange(p, device=dev)[:, None]
    j, n = torch.arange(c, device=dev) // 8, torch.arange(c, device=dev) % 8
    off = (((((px // (2 * e)) * (npad // 8) + j) * 2 + px // e % 2) * 8 + n)
           * e + px % e)
    gp = torch.zeros(p * npad, dtype=dtype, device=dev)
    gp[off.reshape(-1)] = gt.reshape(-1)
    return (gt, gp.reshape(1, p // (2 * e), npad // 8, 2, 8, e), g, x,
            g.reshape(p, c).sum(0))


def glue_blocks(pixels: int, npad: int) -> tuple[int, int]:
    """(groups of 8 pixels per block, blocks) of the glue pass: a block is
    npad channel threads x ``_GLUE_THREADS // npad`` rows of groups, one
    group a thread; a block's db sums are one row of its partials."""
    per = _GLUE_THREADS // npad
    return per, -(-(pixels // 8) // per)


def glue(src: torch.Tensor, pre: torch.Tensor | None = None,
         with_f32: bool = False, f32: bool = False):
    """The glue kernel (``ar_glue_kernel``) on CUDA tensors: as
    ``glue_ref`` (G in f32 only ``with_f32``, else None), with db as the
    per-block sums [blocks, C] f32 that the reduce adds in order. With
    ``f32`` G in T is G in f32: the head's ``src`` itself (nothing is
    copied), a hidden conv's one tensor."""
    if src.device.type != "cuda":
        raise RuntimeError(f"ar_stack glue: no kernel for device "
                           f"{src.device}")
    from iaf_torch.ops.masked_conv import wgmma_width
    c = src.shape[-1]
    p = src.numel() // c
    npad = wgmma_width(c)
    per, blocks = glue_blocks(p, npad)
    dev = src.device
    dtype = torch.float32 if f32 else torch.bfloat16
    e = 4 if f32 else 8

    def new(dtype):
        return torch.empty(src.shape, device=dev, dtype=dtype)

    gt = src if f32 and pre is None else new(dtype)
    gp = torch.empty((1, p // (2 * e), npad // 8, 2, 8, e), device=dev,
                     dtype=dtype)
    g32 = (gt if f32 else new(torch.float32)) if with_f32 else None
    x = new(dtype) if pre is not None else None
    dbp = torch.empty((blocks, c), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = _bwd_lib().ar_stack_glue(
            src.data_ptr(), None if pre is None else pre.data_ptr(),
            None if gt is src else gt.data_ptr(), gp.data_ptr(),
            None if g32 is None or f32 else g32.data_ptr(),
            None if x is None else x.data_ptr(), dbp.data_ptr(), p, c, npad,
            per, int(f32), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "ar_stack glue")
    return gt, gp, g32, x, dbp


def pack_dgrad_ref(weights: Sequence[torch.Tensor], f32: bool = False
                   ) -> list[torch.Tensor]:
    """dgrad's weights on the tensor cores, in plain ops: per conv the live
    taps transposed per tap in ``masked_conv.wgmma_pack`` order with K =
    cout and N = cin (npad = ``wgmma_width(cin)``, zero columns past cin):
    [5, cout/16, npad/8, 2, 8, 8], or with ``f32`` the 3xTF32 dgrad's tf32
    order [5, cout/8, npad/8, 2, 8, 4] (``masked_conv.dgrad_pack(w,
    LIVE_TAPS, f32=True)``)."""
    from iaf_torch.ops import masked_conv as mc
    return [mc.wgmma_pack(_live_taps(w).transpose(1, 2),
                          mc.wgmma_width(w.shape[2]), e=4 if f32 else 8)
            for w in weights]


def pack_dgrad(weights: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``pack_dgrad_ref`` for every conv in one launch of
    ``ar_pack_wt_kernel`` (bf16 CUDA weights of any strides, or f32 ones
    in the tf32 order, ``f32=True``)."""
    from iaf_torch.ops import masked_conv as mc
    w0 = weights[0]
    if w0.device.type != "cuda":
        raise RuntimeError(f"ar_stack pack: no kernel for device "
                           f"{w0.device}")
    if (w0.dtype not in (torch.bfloat16, torch.float32)
            or any(w.dtype != w0.dtype for w in weights)):
        raise ValueError("ar_stack pack: weights must be all bf16 or all "
                         "f32")
    f32 = w0.dtype == torch.float32
    e = 4 if f32 else 8
    dims, strides, out = [], [], []
    for w in weights:
        cin, cout = w.shape[2], w.shape[3]
        npad = mc.wgmma_width(cin)
        dims += [cin, cout, npad]
        strides += list(w.stride())
        out.append(torch.empty((5, cout // (2 * e), npad // 8, 2, 8, e),
                               device=w0.device, dtype=w0.dtype))
    with torch.cuda.device(w0.device):
        err = _bwd_lib().ar_stack_pack_wt(
            _ptrs(weights), _ptrs(out), (ctypes.c_int * len(dims))(*dims),
            (ctypes.c_longlong * len(strides))(*strides), len(weights),
            int(f32), torch.cuda.current_stream(w0.device).cuda_stream)
    _raise_on(err, "ar_stack pack")
    return out


def _dgrad_wgmma(z, weights, pre, g):
    """The dgrad chain on the tensor cores, head first, in z's dtype (bf16
    on ``conv_wgmma_kernel``, f32 by 3xTF32 on ``conv_tf32_kernel``):
    every conv's weights transposed and packed (``pack_dgrad``, one
    launch), the head's G through the glue kernel (cast in bf16, pack, db
    sums), then per conv dgrad (dX in z's dtype) and, for a hidden conv,
    the glue pass. Returns (dz, dcontext, per conv (its wgrad input X, its
    packed G, its G's db sums))."""
    from iaf_torch.ops import masked_conv as mc
    f32 = z.dtype == torch.float32
    klib = mc._bwd_lib()
    dgrad = (klib.masked_conv_dgrad_tf32 if f32
             else klib.masked_conv_dgrad_wgmma)
    n_convs = len(weights)
    feeds = [None] * n_convs
    packed = pack_dgrad(weights)
    gt, gp, _, _, dbp = glue(g, f32=f32)
    dctx = None
    for c in reversed(range(n_convs)):
        cin = weights[c].shape[2]
        dx = torch.empty(z.shape[:3] + (cin,), device=z.device,
                         dtype=z.dtype)
        mc._launch_wgmma(dgrad, "ar_stack dgrad", gt, packed[c], dx,
                         MIRRORED_TAPS, 3, 3, mc.TILE)
        if c == 0:
            feeds[0] = (z, gp, dbp)
            return dx, dctx, feeds
        gt_next, gp_next, g32, x, dbp_next = glue(dx, pre[c - 1], c == 1,
                                                  f32)
        feeds[c] = (x, gp, dbp)
        gt, gp, dbp = gt_next, gp_next, dbp_next
        if c == 1:
            dctx = g32      # conv 0's output gradient is the context's


def _reduce(part, pstride, chunks, dbp, dbstride, dbchunks, w):
    """dW (w's shape and dtype, zeros at the dead taps) and db from the
    partials, in order (``ar_wreduce_kernel``)."""
    dev = w.device
    cin, cout = w.shape[2], w.shape[3]
    dw = torch.empty(w.shape, device=dev, dtype=w.dtype)
    db = torch.empty((cout,), device=dev, dtype=torch.float32)
    _raise_on(_bwd_lib().ar_stack_wreduce(
        part.data_ptr(), pstride, chunks, dbp, dbstride, dbchunks,
        dw.data_ptr(), db.data_ptr(), cin, cout,
        int(w.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream), "ar_stack wreduce")
    return dw, db


def _wgrad_wgmma(weights, feeds):
    """Per conv, wgrad on the tensor cores (X and the packed G of
    ``feeds``, per-chunk partials: bf16 ``conv_wgrad_wgmma_kernel`` over
    128-pixel sub-tiles, f32 ``conv_wgrad_tf32_kernel`` over 64-pixel
    ones) and the in-order reduce of those partials and the glue's db
    sums. Returns ([dW], [db])."""
    from iaf_torch.ops import masked_conv as mc
    klib = mc._bwd_lib()
    x0 = feeds[0][0]
    dev = x0.device
    n, h, w_, _ = x0.shape
    f32 = x0.dtype == torch.float32
    wgrad = (klib.masked_conv_wgrad_tf32 if f32
             else klib.masked_conv_wgrad_wgmma)
    sub = mc._GT_PIXELS if f32 else mc._GW_PIXELS
    c_taps = mc._c_taps(LIVE_TAPS)
    dws, dbs = [], []
    for w, (x, gp, dbp) in zip(weights, feeds):
        cin, cout = w.shape[2], w.shape[3]
        mc._aligned("ar_stack wgrad", x, gp)
        per, chunks = mc.wgrad_chunks(n * h * w_ // sub,
                                      mc.wgrad_m_blocks(5, cin),
                                      mc._sm_count(dev))
        part = torch.empty((chunks, 5, cin, cout), device=dev,
                           dtype=torch.float32)
        _raise_on(wgrad(
            x.data_ptr(), gp.data_ptr(), part.data_ptr(), c_taps, 5, n, h, w_,
            cin, cout, gp.shape[-4] * 8, 3, 3, per, mc._stream(dev)),
            "ar_stack wgrad")
        dw, db = _reduce(part, 5 * cin * cout, chunks, dbp.data_ptr(), cout,
                         dbp.shape[0], w)
        dws.append(dw)
        dbs.append(db)
    return dws, dbs


def _bwd_fma(z, weights, pre, g):
    """Untiled shapes, per conv head first: the FMA wgrad kernel's
    chunk partials (db folded in), their in-order sum, then the FMA dgrad
    kernel (times ELU' of the conv's input)."""
    n, h, w_, _ = z.shape
    bf16 = int(z.dtype == torch.bfloat16)
    lib = _bwd_lib()
    dev = z.device
    rows = n * h
    rows_per_chunk = -(-rows // _WGRAD_CHUNKS)
    chunks = -(-rows // rows_per_chunk)
    n_convs = len(weights)
    dws, dbs = [None] * n_convs, [None] * n_convs
    dctx = None
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c in reversed(range(n_convs)):
        w = weights[c]
        cin, cout = w.shape[2], w.shape[3]
        src = pre[c - 1] if c > 0 else None
        live = 5 * cin * cout
        part = torch.empty((chunks, live + cout), device=dev,
                           dtype=torch.float32)
        _raise_on(lib.ar_stack_wgrad(
            None if src is not None else z.data_ptr(),
            src.data_ptr() if src is not None else None, g.data_ptr(),
            part.data_ptr(), n, h, w_, cin, cout, rows_per_chunk, bf16,
            stream), "ar_stack wgrad")
        dws[c], dbs[c] = _reduce(part, live + cout, chunks,
                                 part.data_ptr() + 4 * live, live + cout,
                                 chunks, w)
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
    return g, dctx, dws, dbs


def ar_stack_bwd(z, weights, pre, g):
    """K1's backward kernels: from the forward's input ``z``, weights and
    saved pre-activations ``pre`` and the output gradient ``g`` [N,H,W,cout]
    f32, return (dz in z's dtype, dcontext f32, [dW per conv, 3x3 HWIO in
    the weights' dtype, zero at the dead taps], [db per conv, f32]); one
    launch in the count. Replaces ``iaf_tpu/ops/ar_stack.py:251 _bwd``.
    Bound by operations: 6.7 GFLOP per call at batch 32 and the paper
    widths (dgrad and wgrad over the 5 live taps), 6.7 us on the bf16
    tensor cores, 13.6 us in f32 at one TF32 product per f32 product
    (40.7 us at 3xTF32's three).

    At shapes the tensor cores tile (``bwd_route``; the paper widths), in
    bf16 (``"wgmma"``) or f32 (``"3xtf32"``, each f32 product three TF32
    products of split operands): the dgrad chain (``_dgrad_wgmma``: K2's
    ``conv_wgmma_kernel`` or ``conv_tf32_kernel`` per conv, with the glue
    kernel between convs applying ELU' and writing G in z's dtype, in
    wgrad's packed order and the db sums, and each conv's wgrad input
    T(ELU(a)) as the forward computed it), then per conv wgrad on K2's
    ``conv_wgrad_wgmma_kernel`` or ``conv_wgrad_tf32_kernel`` and the
    in-order reduce of its partials and of the db sums (``_wgrad_wgmma``):
    13 launches for 3 convs, no atomics, so two calls give the same bits.
    Other shapes take the FMA kernels (``_bwd_fma``), deterministic the
    same way."""
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
    with torch.cuda.device(z.device):
        if bwd_route(z, weights)[0][0] != "fma":
            dz, dctx, feeds = _dgrad_wgmma(z, weights, pre, g)
            dws, dbs = _wgrad_wgmma(weights, feeds)
        else:
            dz, dctx, dws, dbs = _bwd_fma(z, weights, pre, g)
    launches["ar_stack_bwd"] += 1
    return dz, dctx, dws, dbs


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


# K1's forward as the torch op ``iaf::ar_stack`` (``ar_stack_op``): the
# kernel on CUDA tensors, the twin on CPU tensors, a fake for tracing.
# ``torch.export`` records the op, so an exported program launches the
# kernel on the card. Registered through ``torch.library.Library``: the
# dispatcher calls these functions directly, with no Python autograd or
# compile-guard layer around them (``torch.library.custom_op`` adds both,
# at 17-49 us of host time a launch on an H100's host, and its guard
# imports torch._dynamo at the first call).
_LIB = torch.library.Library("iaf", "FRAGMENT")
_LIB.define("ar_stack(Tensor z, Tensor context, Tensor[] weights, "
            "Tensor[] biases) -> Tensor")
_LIB.impl("ar_stack", ar_stack_ref, "CPU")


def _ar_stack_cuda(z, context, weights, biases):
    # an exported program keeps a ``.contiguous()`` only where the trace
    # saw a non-contiguous tensor; the kernel needs these contiguous
    return _fwd(z.contiguous(), context.contiguous(), weights,
                [b.contiguous() for b in biases], save_pre=False)[0]


_LIB.impl("ar_stack", _ar_stack_cuda, "CUDA")


@torch.library.register_fake("iaf::ar_stack", lib=_LIB)
def _ar_stack_fake(z, context, weights, biases):
    n, h, w_, _ = z.shape
    return z.new_empty((n, h, w_, weights[-1].shape[-1]),
                       dtype=torch.float32)


ar_stack_op = torch.ops.iaf.ar_stack.default


def ar_stack(z: torch.Tensor, context: torch.Tensor,
             weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
             masks: Sequence[np.ndarray] | CheckedMasks) -> torch.Tensor:
    """Run the masked AR chain: ``weights`` are the folded, pre-masked
    [3, 3, cin, cout] convs (hidden ones first, the merged head last) in
    z's dtype, ``biases`` f32, ``masks`` the static numpy masks (only their
    shapes and tap structure are read; scanned on every call) or their
    ``check_masks`` (checked once). Returns the heads, [N, H, W, cout]
    f32. Under autograd: ``_ARStack`` on CUDA, the twin on the CPU; else
    the op ``iaf::ar_stack`` (``ar_stack_op``) on either."""
    _check(z, context, weights, biases, masks)
    if z.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"ar_stack: no kernel for device {z.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (z, context, *weights, *biases)):
        if z.device.type == "cpu":
            return ar_stack_ref(z, context, weights, biases)
        return _ARStack.apply(z, context, len(weights), *weights, *biases)
    return ar_stack_op(z, context, list(weights), list(biases))
