"""K2: one masked stride-1 SAME conv over its live taps
(``csrc/masked_conv.cu``) and its backward (``csrc/masked_conv_bwd.cu``).

Replaces ``iaf_tpu/ops/masked_conv.py:_conv_kernel`` and its ``_bwd``: the
conv-by-conv route of an IAF step's AR net, taken wherever K1's fused
chain does not apply (a kernel size other than 3, or on the card a 3x3
chain deeper than K1's shared memory holds). ``masked_conv2d`` launches
a CUDA kernel for CUDA tensors (the tensor-core kernel, bf16 or f32 by
3xTF32, or the FMA one, as ``fwd_route`` decides from the shapes) and
runs ``masked_conv2d_ref``, its plain PyTorch twin (the counterpart of
``xla_conv2d_same``), for CPU tensors only. Under autograd on CUDA it is
a ``torch.autograd.Function`` whose backward, ``masked_conv2d_bwd``, runs
the dgrad and wgrad kernels (tensor cores in bf16 or by 3xTF32, or FMA,
as ``bwd_route`` decides); on the CPU autograd differentiates the twin
(``masked_conv2d_bwd_ref``).
Layouts are the JAX ones: activations NHWC, weights HWIO.

The tensor-core forward spreads over the card by ``fwd_plan``: 128-pixel
tiles, or 64-pixel ones where the 128-pixel tiles leave SMs idle (the
training step's batch 32), with the same bits.

``taps`` names the (dy, dx) kernel positions that may hold nonzero
weights; the kernels compute only those (``nonzero_taps`` of the AR mask:
13 of 25 for a 5x5 raster mask) and treat the rest as zero, and so does
the twin.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterable, NamedTuple

import torch
import torch.nn.functional as F

from iaf_torch.ops import _build
from iaf_torch.ops.ar_stack import _SMEM_LIMIT, _raise_on

Taps = tuple[tuple[int, int], ...]

_MAX_TAPS = 64          # masked_conv.cuh MAX_TAPS: taps per conv
WGMMA_WIDTHS = (32, 64, 128, 160, 256)   # the tensor-core kernels' N
_TF32_MAX_N = 160       # the 3xTF32 kernels' widest N (accumulators and
                        # f32 totals in registers)
_TK = 16                # masked_conv.cuh TK: K depth of an f32 weight slice
_FMA_ROWS = 8           # FMA path: output rows per block, at most
_FMA_THREADS = 256      # masked_conv.cuh FMA_THREADS
_WGRAD_CHUNKS = 32      # FMA wgrad partials: pixel-row chunks per conv
_GW_PIXELS = 128        # masked_conv_bwd.cu GW_PIXELS: wgrad sub-tile
_GW_CB = 32             # masked_conv_bwd.cu GW_CB: wgrad channels per block
_GW_TG = 4              # masked_conv_bwd.cu GW_TG: wgrad taps per block
_GT_PIXELS = 64         # masked_conv_bwd.cu GT_PIXELS: 3xTF32 wgrad sub-tile
TILE = 128              # masked_conv.cuh: pixels of a tensor-core conv tile
                        # (two consumer warpgroups a block)
SMALL_TILE = 64         # the forward's small tile (one warpgroup a block)

launches = {"masked_conv2d": 0, "masked_conv2d_bwd": 0}  # since the reset


def _taps(w: torch.Tensor, taps: Iterable | None) -> Taps:
    """``taps`` as a tuple of (dy, dx) int pairs, all kh*kw taps for
    None; raises on a tap outside the kernel or a repeated one."""
    kh, kw = w.shape[:2]
    if taps is None:
        return tuple((dy, dx) for dy in range(kh) for dx in range(kw))
    out = tuple((int(dy), int(dx)) for dy, dx in taps)
    if not out or len(set(out)) != len(out) or any(
            not (0 <= dy < kh and 0 <= dx < kw) for dy, dx in out):
        raise ValueError(f"taps {out} must be distinct positions of a "
                         f"{kh}x{kw} kernel")
    return out


def masked_conv2d_ref(x: torch.Tensor, w: torch.Tensor,
                      taps: Iterable | None = None) -> torch.Tensor:
    """The twin: the stride-1 SAME conv of ``x`` [N,H,W,cin] with ``w``
    [kh,kw,cin,cout] (odd kh, kw) in the weights' dtype, widened to f32
    (``xla_conv2d_same(x, w).astype(f32)``), with the weights outside
    ``taps`` taken as zero."""
    kh, kw = w.shape[:2]
    taps = _taps(w, taps)
    if len(taps) < kh * kw:
        keep = torch.zeros((kh, kw, 1, 1), dtype=w.dtype, device=w.device)
        for dy, dx in taps:
            keep[dy, dx] = 1
        w = w * keep
    out = F.conv2d(x.to(w.dtype).permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   padding=((kh - 1) // 2, (kw - 1) // 2))
    return out.float().permute(0, 2, 3, 1)


def masked_conv2d_bwd_ref(x, w, g, taps=None):
    """The plain backward: autograd of the twin. Returns (dx in x's dtype,
    dW in w's dtype, zero outside ``taps``)."""
    with torch.enable_grad():
        x_, w_ = (t.detach().requires_grad_() for t in (x, w))
        out = masked_conv2d_ref(x_, w_, taps)
        return torch.autograd.grad(out, (x_, w_), g)


def wgmma_path(dtype: torch.dtype, w: int, cin: int, cout: int) -> bool:
    """Whether a conv's shape (the forward's, or dgrad's with cin and cout
    swapped) is one the tensor-core kernel tiles: bf16, a 128-pixel tile
    of whole rows (W of 16, 32, 64 or 128), whole 16-deep channel steps
    in, and at most 256 outputs in whole 8-wide groups. The launch also
    needs two weight stages beside the staged rows in shared memory
    (``_route``)."""
    return (dtype == torch.bfloat16 and w in (16, 32, 64, 128)
            and cin % 16 == 0 and cout % 8 == 0 and cout <= WGMMA_WIDTHS[-1])


def wgrad_wgmma_path(dtype: torch.dtype, h: int, w: int, cin: int,
                     cout: int) -> bool:
    """Whether wgrad's shape is one the tensor-core wgrad tiles: bf16,
    128-pixel sub-tiles of whole rows of one image (W of 16, 32, 64 or
    128, H a multiple of 128 / W), input channels in whole blocks of 32,
    and at most 256 outputs in whole 8-wide groups. Its two stages must
    also fit one block's shared memory (``_wgrad_route``)."""
    return (dtype == torch.bfloat16 and w in (16, 32, 64, 128)
            and h % (_GW_PIXELS // w) == 0 and cin % _GW_CB == 0
            and cout % 8 == 0 and cout <= WGMMA_WIDTHS[-1])


def tf32_path(dtype: torch.dtype, w: int, cin: int, cout: int) -> bool:
    """Whether a conv's shape (the forward's, or dgrad's with cin and cout
    swapped) is one the 3xTF32 tensor-core kernel tiles: f32, the bf16
    kernel's 128-pixel tiles, whole 16-deep K slices in, and at most 160
    outputs in whole 8-wide groups. The launch also needs two weight
    stages beside one staged buffer in shared memory (``_route``)."""
    return (dtype == torch.float32 and w in (16, 32, 64, 128)
            and cin % _TK == 0 and cout % 8 == 0 and cout <= _TF32_MAX_N)


def wgrad_tf32_path(dtype: torch.dtype, h: int, w: int, cin: int,
                    cout: int) -> bool:
    """Whether wgrad's shape is one the 3xTF32 wgrad tiles: f32, 64-pixel
    sub-tiles of whole rows of one image (W of 16, 32 or 64, H a multiple
    of 64 / W), input channels in whole blocks of 32, and at most 160
    outputs in whole 8-wide groups. Its two stages must also fit one
    block's shared memory (``_wgrad_route``)."""
    return (dtype == torch.float32 and w in (16, 32, 64)
            and h % (_GT_PIXELS // w) == 0 and cin % _GW_CB == 0
            and cout % 8 == 0 and cout <= _TF32_MAX_N)


def wgmma_width(cout: int) -> int:
    """The kernel's N for ``cout`` outputs: the narrowest instantiated
    width that holds them (the packed weights' extra columns are zero)."""
    return next(n for n in WGMMA_WIDTHS if n >= cout)


def wgmma_pack(t: torch.Tensor, npad: int,
               dtype: torch.dtype | None = None, e: int = 8) -> torch.Tensor:
    """[taps, K, cout] -> the tensor-core kernels' B order, [taps, K/2e,
    npad/8, 2, 8, e] in ``dtype`` (default t's), e the K elements of a
    16-byte core-matrix row (8 in bf16; 4 in f32, the 3xTF32 kernels',
    whose tf32 k8 steps span 32 bytes as bf16 k16 steps do): element [t,
    s, j, h, n, k] is ``t[t, 2e s + e h + k, 8 j + n]`` (zero for 8 j + n
    >= cout). Each k-step is one wgmma B operand in the canonical K-major
    layout without swizzle (core matrices of 128 bytes, the two k halves
    128 bytes apart, column groups 256 bytes apart) and each (tap, K
    chunk) slice that a kernel streams is contiguous. K is cin for the
    forward's weights, cout for dgrad's (``t`` the transposed view; the
    copy transposes) and the pixels for wgrad's G (``wgrad_pack``). One
    copy (two where cout is padded). f32 is packed as it is: the kernels
    split it into tf32 parts on chip."""
    taps, k, cout = t.shape
    if npad != cout:
        t = F.pad(t, (0, npad - cout))
    t = t.reshape(taps, k // (2 * e), 2, e, npad // 8, 8)   # t s h k j n
    t = t.permute(0, 1, 4, 2, 5, 3)
    return torch.empty(t.shape, dtype=dtype or t.dtype,
                       device=t.device).copy_(t)


def fwd_pack(w: torch.Tensor, taps: Taps, f32: bool = False) -> torch.Tensor:
    """The forward's weights on the tensor cores: the live taps, [taps,
    cin, cout], in ``wgmma_pack`` order in w's dtype; with ``f32`` in the
    3xTF32 kernel's tf32 order, [taps, cin/8, npad/8, 2, 8, 4]."""
    return wgmma_pack(_live(w, taps), wgmma_width(w.shape[3]),
                      e=4 if f32 else 8)


def fwd_pack_kernel(w: torch.Tensor, taps: Taps) -> torch.Tensor:
    """``fwd_pack`` (f32 weights in the 3xTF32 order) in one launch of
    ``conv_pack_w_kernel`` (CUDA weights of any strides): the same bytes,
    where the twin's gather and packing copy take two launches."""
    if w.device.type != "cuda":
        raise RuntimeError(f"masked_conv2d pack: no kernel for device "
                           f"{w.device}")
    kh, kw, cin, cout = w.shape
    f32 = w.dtype == torch.float32
    e = 4 if f32 else 8
    npad = wgmma_width(cout)
    out = torch.empty((len(taps), cin // (2 * e), npad // 8, 2, 8, e),
                      device=w.device, dtype=w.dtype)
    with torch.cuda.device(w.device):
        err = _lib().masked_conv_pack_w(
            w.data_ptr(), out.data_ptr(), _c_taps(taps), len(taps), kh, kw,
            cin, cout, npad, (ctypes.c_longlong * 4)(*w.stride()), int(f32),
            _stream(w.device))
    _raise_on(err, "masked_conv2d pack")
    return out


def dgrad_pack(w: torch.Tensor, taps: Taps, f32: bool = False
               ) -> torch.Tensor:
    """dgrad's weights on the tensor cores: the live taps transposed per
    tap, [taps, cout, cin], in ``wgmma_pack`` order with N = cin, in w's
    dtype (with ``f32`` in the 3xTF32 kernel's tf32 order; one gather,
    then one copy that transposes and packs)."""
    return wgmma_pack(_live(w, taps).transpose(1, 2),
                      wgmma_width(w.shape[2]), e=4 if f32 else 8)


def wgrad_pack(g: torch.Tensor, f32: bool = False) -> torch.Tensor:
    """wgrad's B on the tensor cores: the output gradient g [N,H,W,cout]
    (f32) with the pixels (NHWC order) as K, in ``wgmma_pack`` order:
    rounded to bf16 as [1, N*H*W/16, npad/8, 2, 8, 8], or with ``f32``
    for the 3xTF32 wgrad as it is, [1, N*H*W/8, npad/8, 2, 8, 4] (the
    kernel splits it on chip). One copy: the pixels become contiguous,
    which wgmma's K-major tf32 B needs."""
    n, h, w_, cout = g.shape
    return wgmma_pack(g.reshape(1, n * h * w_, cout), wgmma_width(cout),
                      None if f32 else torch.bfloat16, 4 if f32 else 8)


# the tensor-core conv entries (forward and dgrad, bf16 and 3xTF32): 4
# pointers, 10 ints (the last the tile's pixels), the shared-memory limit
# and the stream
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_size_t, ctypes.c_void_p])


def _lib():
    lib = _build.load("masked_conv")
    if not getattr(lib, "_iaf_typed", False):
        lib.masked_conv_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.masked_conv_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.masked_conv_smem_bytes.restype = ctypes.c_size_t
        lib.masked_conv_wgmma_stages.argtypes = (
            [ctypes.c_int] * 6 + [ctypes.c_size_t, ctypes.c_int])
        lib.masked_conv_wgmma_stages_tile.argtypes = (
            [ctypes.c_int] * 6 + [ctypes.c_size_t] + [ctypes.c_int] * 2)
        lib.masked_conv_fwd_wgmma.argtypes = _WGMMA_ARGTYPES
        lib.masked_conv_fwd_tf32.argtypes = _WGMMA_ARGTYPES
        lib.masked_conv_pack_w.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        lib.masked_conv_fwd_grid.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
            + [ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p])
        for fn in (lib.masked_conv_fwd, lib.masked_conv_wgmma_stages,
                   lib.masked_conv_wgmma_stages_tile,
                   lib.masked_conv_fwd_wgmma, lib.masked_conv_fwd_tf32,
                   lib.masked_conv_pack_w, lib.masked_conv_fwd_grid):
            fn.restype = ctypes.c_int
        lib._iaf_typed = True
    return lib


def _bwd_lib():
    lib = _build.load("masked_conv_bwd")
    if not getattr(lib, "_iaf_typed", False):
        lib.masked_conv_dgrad.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.masked_conv_dgrad_wgmma.argtypes = _WGMMA_ARGTYPES
        lib.masked_conv_dgrad_tf32.argtypes = _WGMMA_ARGTYPES
        lib.masked_conv_wgrad.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        gemm = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        for fn in (lib.masked_conv_wgrad_wgmma_smem,
                   lib.masked_conv_wgrad_tf32_smem):
            fn.argtypes = [ctypes.c_int] * 6
            fn.restype = ctypes.c_size_t
        lib.masked_conv_wgrad_wgmma.argtypes = gemm
        lib.masked_conv_wgrad_tf32.argtypes = gemm
        lib.masked_conv_wreduce.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        for fn in (lib.masked_conv_dgrad, lib.masked_conv_dgrad_wgmma,
                   lib.masked_conv_dgrad_tf32, lib.masked_conv_wgrad,
                   lib.masked_conv_wgrad_wgmma, lib.masked_conv_wgrad_tf32,
                   lib.masked_conv_wreduce):
            fn.restype = ctypes.c_int
        lib._iaf_typed = True
    return lib


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("x must be NHWC and w HWIO")
    kh, kw, cin, _ = w.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"kernel {kh}x{kw}: SAME stride-1 needs odd sizes")
    if kh * kw > _MAX_TAPS:
        raise ValueError(f"kernel {kh}x{kw} has more than {_MAX_TAPS} taps")
    if x.shape[-1] != cin:
        raise ValueError(f"x has {x.shape[-1]} channels, w takes {cin}")
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x {x.dtype} and w {w.dtype} must share a dtype "
                        "in (float32, bfloat16)")


def _c_taps(taps: Taps) -> ctypes.Array:
    return (ctypes.c_int * (2 * len(taps)))(*[v for t in taps for v in t])


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _aligned(what: str, *ts: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: the tensor-core kernel needs its inputs "
                         "16-byte aligned")


def _launch_conv(fn, what: str, inp, packed, out, taps: Taps, kh: int,
                 kw: int) -> None:
    """Launch the FMA conv (``fn``: the forward or dgrad entry) on ``inp``
    [N,H,W,c_in] into ``out`` [N,H,W,c_out], choosing the output rows per
    block so the staged rows fit shared memory."""
    n, h, w_, c_in = inp.shape
    c_out = out.shape[-1]
    span = _span(taps)
    lib = _lib()
    tr = next((r for r in range(min(h, _FMA_ROWS), 0, -1)
               if lib.masked_conv_smem_bytes(r, w_, c_in, kw, span)
               <= _SMEM_LIMIT), 0)
    if tr == 0:
        need = lib.masked_conv_smem_bytes(1, w_, c_in, kw, span)
        raise ValueError(f"{what}: one output row stages {need} B of shared "
                         f"memory at W={w_}, cin={c_in}, kw={kw}; a Hopper "
                         f"block has {_SMEM_LIMIT}")
    bf16 = int(packed.dtype == torch.bfloat16)
    with torch.cuda.device(inp.device):
        err = fn(inp.data_ptr(), packed.data_ptr(), out.data_ptr(),
                 _c_taps(taps), len(taps), n, h, w_, c_in, c_out, kh, kw, tr,
                 bf16, _FMA_THREADS, _stream(inp.device))
    _raise_on(err, what)


def _launch_wgmma(fn, what: str, inp, packed, out, taps: Taps, kh: int,
                  kw: int, tile_pixels: int) -> None:
    """Launch the tensor-core conv (``fn``: the forward or dgrad entry,
    bf16 or 3xTF32) on ``inp`` [N,H,W,c_in] with ``packed``
    (``wgmma_pack`` order) into ``out`` [N,H,W,c_out], on tiles of
    ``tile_pixels`` (``TILE`` or ``SMALL_TILE``)."""
    n, h, w_, c_in = inp.shape
    c_out = out.shape[-1]
    _aligned(what, inp, packed)
    with torch.cuda.device(inp.device):
        err = fn(inp.data_ptr(), packed.data_ptr(), out.data_ptr(),
                 _c_taps(taps), len(taps), n, h, w_, c_in, c_out,
                 packed.shape[-4] * 8, kh, kw, tile_pixels, _SMEM_LIMIT,
                 _stream(inp.device))
    _raise_on(err, what)


@functools.lru_cache(maxsize=None)
def _tap_index(taps: Taps, kw: int, device: torch.device) -> torch.Tensor:
    return torch.tensor([dy * kw + dx for dy, dx in taps], device=device)


@functools.lru_cache(maxsize=None)
def _slot_index(taps: Taps, kh: int, kw: int,
                device: torch.device) -> torch.Tensor:
    """Each kernel position's live tap (its index in ``taps``), -1 where
    it is dead: the reduce's map, int32 on ``device``."""
    slot = [-1] * (kh * kw)
    for t, (dy, dx) in enumerate(taps):
        slot[dy * kw + dx] = t
    return torch.tensor(slot, dtype=torch.int32, device=device)


def _live(w: torch.Tensor, taps: Taps) -> torch.Tensor:
    """[kh, kw, cin, cout] -> [taps, cin, cout], the taps in order (one
    gather)."""
    kh, kw, cin, cout = w.shape
    return w.reshape(kh * kw, cin, cout).index_select(
        0, _tap_index(taps, kw, w.device))


def _span(taps: Taps) -> int:
    dys = [dy for dy, _ in taps]
    return max(dys) - min(dys)


def _mirrored(taps: Taps, kh: int, kw: int) -> Taps:
    return tuple((kh - 1 - dy, kw - 1 - dx) for dy, dx in taps)


def fwd_route(x: torch.Tensor, w: torch.Tensor, taps: Iterable | None
              = None) -> str:
    """The kernel the forward launches for CUDA inputs ``x``, ``w``:
    ``"wgmma"`` (bf16 tensor cores) where ``wgmma_path`` holds,
    ``"3xtf32"`` (f32 on the tensor cores, three TF32 products per f32
    product) where ``tf32_path`` holds, each where its staged rows and two
    weight stages fit one block's shared memory, else ``"fma"``. Decided
    from the shapes before any launch (builds the library on first
    use)."""
    return _route(x.dtype, x.shape[2], x.shape[3], w.shape[3], w.shape[1],
                  _taps(w, taps))


def bwd_route(x: torch.Tensor, w: torch.Tensor, taps: Iterable | None
              = None) -> tuple[str, str]:
    """The kernels the backward launches for CUDA inputs ``x``, ``w``:
    (dgrad's, wgrad's), each ``"wgmma"`` (bf16 tensor cores),
    ``"3xtf32"`` (f32 on the tensor cores) or ``"fma"``. dgrad is the conv
    of g (cout channels in, cin out) over the mirrored taps, routed as the
    forward's; wgrad takes the tensor cores where ``wgrad_wgmma_path``
    (bf16) or ``wgrad_tf32_path`` (f32) holds and its two stages fit one
    block's shared memory. Decided from the shapes before any launch."""
    taps = _taps(w, taps)
    kh, kw, cin, cout = w.shape
    _, h, w_, _ = x.shape
    return (_route(x.dtype, w_, cout, cin, kw, _mirrored(taps, kh, kw)),
            _wgrad_route(x.dtype, h, w_, cin, cout, kw, _span(taps)))


@functools.lru_cache(maxsize=None)
def _route(dtype: torch.dtype, w_: int, cin: int, cout: int, kw: int,
           taps: Taps) -> str:
    """The conv's kernel: the tensor cores where ``wgmma_path`` (bf16) or
    ``tf32_path`` (f32, 3xTF32) holds and the staged rows and two weight
    stages fit one block's shared memory (the kernel's own count), else
    FMA."""
    for route, path, f32 in (("wgmma", wgmma_path, 0),
                             ("3xtf32", tf32_path, 1)):
        if path(dtype, w_, cin, cout) and _lib().masked_conv_wgmma_stages(
                w_, cin, kw, _span(taps), wgmma_width(cout), len(taps),
                _SMEM_LIMIT, f32) >= 2:
            return route
    return "fma"


class FwdPlan(NamedTuple):
    """How K2's tensor-core forward spreads over the card (``fwd_plan``):
    tiles of ``tile_pixels`` output pixels (``TILE``: two consumer
    warpgroups a block; ``SMALL_TILE``: one) walked by ``blocks``
    persistent blocks, at most one an SM. ``FwdPlan(0, 0)``: no plan (a
    shape no tensor-core kernel tiles)."""
    tile_pixels: int
    blocks: int


def _tiles(n: int, h: int, w: int, tile_pixels: int) -> int:
    """Tiles of ``tile_pixels`` (``tile_pixels`` / w whole rows, the last
    of an image cut at its bottom) in ``n`` images of ``h`` x ``w``."""
    return n * -(-h // (tile_pixels // w))


def tile_plan(n: int, h: int, w: int, tile_pixels: int, sms: int
              ) -> FwdPlan:
    """The plan on tiles of ``tile_pixels`` for ``n`` images of ``h`` x
    ``w``: one block per tile, at most ``sms``."""
    return FwdPlan(tile_pixels, min(_tiles(n, h, w, tile_pixels), sms))


@functools.lru_cache(maxsize=None)
def fwd_plan(dtype: torch.dtype, n: int, h: int, w: int, cin: int,
             cout: int, sms: int) -> FwdPlan:
    """K2's forward launch plan for ``n`` images of ``h`` x ``w`` on a card
    of ``sms`` SMs, from the shapes alone (no built library), so a CUDA
    graph captures a fixed grid. The rule:

    - 128-pixel tiles (``TILE``) wherever n*h*w / 128 >= ``sms`` (every
      SM has a tile: the eval chunk's N = 1024, 2048 tiles) or the width
      gives no whole 64-pixel tile (W = 128);
    - else 64-pixel tiles (``SMALL_TILE``, one warpgroup a block) where
      each block then walks one tile (tiles64 <= ``sms``): the training
      step's batch 32 at W = 16 has 64 tiles of 128 for 132 SMs, 128 of
      64 (N = 1, 2 and 16 too); else 128-pixel tiles.

    That is where it leaves a block less tile time, as measured on an
    H100 80GB HBM3 at 700 W (``chip_smoke.py --k2-plans``): a block's
    time is its tiles' chains of dependent wgmmas, whatever the number of
    blocks (N = 1 and batch 32 alike), and one 64-pixel tile takes
    0.79-0.93x one 128-pixel tile: at batch 32 the 64-pixel plan's kernel
    is 0.86-0.93x the 128-pixel plan's on the three 5x5 AR convs in bf16
    (160->160 included: its doubled weight stream from L2, 85 MB, does
    not limit it) and 0.79-0.83x in f32; two 64-pixel tiles a block lose
    (N = 1024: 1.45-1.65x).

    Both plans give the same bits. A shape whose 128-pixel tile fits
    shared memory (``_route``) fits at 64 (fewer staged rows). Shapes no
    tensor-core kernel tiles (``wgmma_path``, ``tf32_path``; the FMA
    kernel reads no plan) get ``FwdPlan(0, 0)``."""
    if not (wgmma_path(dtype, w, cin, cout) or tf32_path(dtype, w, cin,
                                                          cout)):
        return FwdPlan(0, 0)
    if w <= SMALL_TILE and _tiles(n, h, w, SMALL_TILE) <= sms:
        return tile_plan(n, h, w, SMALL_TILE, sms)
    return tile_plan(n, h, w, TILE, sms)


@functools.lru_cache(maxsize=None)
def _wgrad_route(dtype: torch.dtype, h: int, w_: int, cin: int, cout: int,
                 kw: int, span: int) -> str:
    lib = _bwd_lib()
    for route, path, smem in (
            ("wgmma", wgrad_wgmma_path, lib.masked_conv_wgrad_wgmma_smem),
            ("3xtf32", wgrad_tf32_path, lib.masked_conv_wgrad_tf32_smem)):
        if path(dtype, h, w_, cin, cout) and 0 < smem(
                h, w_, cin, kw, span, wgmma_width(cout)) <= _SMEM_LIMIT:
            return route
    return "fma"


def _fwd(x: torch.Tensor, w: torch.Tensor, taps: Taps,
         plan: FwdPlan | None = None) -> torch.Tensor:
    """Launch the forward on the kernel ``fwd_route`` names; the
    tensor-core kernels on ``plan`` (default ``fwd_plan``'s for these
    shapes and the card)."""
    if w.device != x.device:
        raise RuntimeError("masked_conv2d: x and w on different devices")
    if not x.is_contiguous():
        raise ValueError("masked_conv2d: x must be contiguous")
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    lib = _lib()
    out = torch.empty((n, h, w_, cout), device=x.device, dtype=torch.float32)
    route = _route(x.dtype, w_, cin, cout, kw, taps)
    if route != "fma":
        if plan is None:
            plan = fwd_plan(x.dtype, n, h, w_, cin, cout,
                            _sm_count(x.device))
        _launch_wgmma(lib.masked_conv_fwd_wgmma if route == "wgmma"
                      else lib.masked_conv_fwd_tf32, "masked_conv2d", x,
                      fwd_pack_kernel(w, taps), out, taps, kh, kw,
                      plan.tile_pixels)
    else:
        _launch_conv(lib.masked_conv_fwd, "masked_conv2d", x, _live(w, taps),
                     out, taps, kh, kw)
    launches["masked_conv2d"] += 1
    return out


def fwd_grid(x: torch.Tensor, w: torch.Tensor, taps: Iterable | None,
             plan: FwdPlan) -> tuple[int, int]:
    """(blocks, blocks resident on one SM) of the tensor-core forward's
    launch on ``plan`` for CUDA inputs ``x``, ``w``, from the CUDA
    occupancy calculator; launches nothing. One block an SM means no two
    blocks of the grid share one."""
    taps = _taps(w, taps)
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    route = _route(x.dtype, w_, cin, cout, kw, taps)
    if route == "fma":
        raise ValueError("fwd_grid: the shape takes the FMA kernel")
    grid = (ctypes.c_int * 2)()
    with torch.cuda.device(x.device):
        err = _lib().masked_conv_fwd_grid(
            x.data_ptr(), w.data_ptr(), _c_taps(taps), len(taps), n, h, w_,
            cin, cout, wgmma_width(cout), kh, kw, plan.tile_pixels,
            _SMEM_LIMIT, int(route == "3xtf32"), grid)
    _raise_on(err, "masked_conv2d grid")
    return grid[0], grid[1]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def wgrad_m_blocks(ntaps: int, cin: int) -> int:
    """The tensor-core wgrad's blocks over M: 32-channel blocks x groups
    of 4 taps."""
    return cin // _GW_CB * -(-ntaps // _GW_TG)


def wgrad_chunks(n_sub: int, m_blocks: int, sms: int) -> tuple[int, int]:
    """(sub-tiles per chunk, chunks) for the tensor-core wgrad: about one
    block per SM over chunks x ``m_blocks`` blocks, every chunk holding
    at least one of the ``n_sub`` 128-pixel sub-tiles."""
    per = -(-n_sub // max(1, sms // m_blocks))
    return per, -(-n_sub // per)


def _dgrad(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
           taps: Taps) -> torch.Tensor:
    """dx in x's dtype: the conv of ``g`` (f32) with the mirrored taps and
    the weights transposed per tap, on the kernel ``bwd_route`` names
    (the bf16 tensor cores take g rounded to bf16 once, as the twin does;
    3xTF32 takes it as it is)."""
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    mirrored = _mirrored(taps, kh, kw)
    dx = torch.empty(x.shape, device=x.device, dtype=x.dtype)
    lib = _bwd_lib()
    route = _route(x.dtype, w_, cout, cin, kw, mirrored)
    if route == "wgmma":
        _launch_wgmma(lib.masked_conv_dgrad_wgmma, "masked_conv2d dgrad",
                      g.to(torch.bfloat16), dgrad_pack(w, taps), dx, mirrored,
                      kh, kw, TILE)
    elif route == "3xtf32":
        _launch_wgmma(lib.masked_conv_dgrad_tf32, "masked_conv2d dgrad", g,
                      dgrad_pack(w, taps, f32=True), dx, mirrored, kh, kw,
                      TILE)
    else:
        _launch_conv(lib.masked_conv_dgrad, "masked_conv2d dgrad", g,
                     _live(w, taps).transpose(1, 2).contiguous(), dx,
                     mirrored, kh, kw)
    return dx


def _wgrad(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
           taps: Taps) -> torch.Tensor:
    """dW [kh,kw,cin,cout] in w's dtype, zero outside ``taps``: per-chunk
    f32 partials on the kernel ``bwd_route`` names, then their sum in
    chunk order (deterministic)."""
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    dev = x.device
    lib = _bwd_lib()
    c_taps = _c_taps(taps)
    route = _wgrad_route(x.dtype, h, w_, cin, cout, kw, _span(taps))
    with torch.cuda.device(dev):
        if route != "fma":
            f32 = route == "3xtf32"
            gp = wgrad_pack(g, f32)
            _aligned("masked_conv2d wgrad", x, gp)
            per, chunks = wgrad_chunks(
                n * h * w_ // (_GT_PIXELS if f32 else _GW_PIXELS),
                wgrad_m_blocks(len(taps), cin), _sm_count(dev))
            part = torch.empty((chunks, len(taps), cin, cout), device=dev,
                               dtype=torch.float32)
            fn = (lib.masked_conv_wgrad_tf32 if f32
                  else lib.masked_conv_wgrad_wgmma)
            err = fn(x.data_ptr(), gp.data_ptr(), part.data_ptr(), c_taps,
                     len(taps), n, h, w_, cin, cout, gp.shape[-4] * 8, kh,
                     kw, per, _stream(dev))
        else:
            rows = n * h
            per = -(-rows // _WGRAD_CHUNKS)
            chunks = -(-rows // per)
            part = torch.empty((chunks, len(taps), cin, cout), device=dev,
                               dtype=torch.float32)
            err = lib.masked_conv_wgrad(
                x.data_ptr(), g.data_ptr(), part.data_ptr(), c_taps,
                len(taps), n, h, w_, cin, cout, kh, kw, per,
                int(x.dtype == torch.bfloat16), _stream(dev))
        _raise_on(err, "masked_conv2d wgrad")
        dw = torch.empty((kh, kw, cin, cout), device=dev, dtype=w.dtype)
        _raise_on(lib.masked_conv_wreduce(
            part.data_ptr(), dw.data_ptr(),
            _slot_index(taps, kh, kw, dev).data_ptr(), len(taps), chunks,
            cin, cout, kh * kw, int(w.dtype == torch.bfloat16), _stream(dev)),
            "masked_conv2d wreduce")
    return dw


def masked_conv2d_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                      taps: Iterable | None = None):
    """K2's backward kernels: from the forward's input ``x`` and weights
    ``w`` and the output gradient ``g`` [N,H,W,cout] f32, return (dx in
    x's dtype, dW [kh,kw,cin,cout] in w's dtype, zero outside ``taps``).
    dgrad, then wgrad's chunk partials and their in-order sum, each on the
    kernels ``bwd_route`` names: one launch in the count."""
    if x.device.type != "cuda":
        raise RuntimeError(f"masked_conv2d_bwd: no kernel for device "
                           f"{x.device}")
    _check(x, w)
    taps = _taps(w, taps)
    n, h, w_, _ = x.shape
    cout = w.shape[3]
    if any(t.device != x.device for t in (w, g)):
        raise RuntimeError("masked_conv2d_bwd: inputs on different devices")
    if (g.dtype != torch.float32 or not g.is_contiguous()
            or tuple(g.shape) != (n, h, w_, cout)):
        raise ValueError(f"masked_conv2d_bwd: g must be contiguous float32 "
                         f"{(n, h, w_, cout)}")
    if not x.is_contiguous():
        raise ValueError("masked_conv2d_bwd: x must be contiguous")
    dx = _dgrad(x, w, g, taps)
    dw = _wgrad(x, w, g, taps)
    launches["masked_conv2d_bwd"] += 1
    return dx, dw


class _MaskedConv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, taps):
        ctx.taps = taps
        ctx.save_for_backward(x, w)
        return _fwd(x, w, taps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = masked_conv2d_bwd(x, w, g.contiguous(), ctx.taps)
        return dx, dw, None


def _pairs(flat: list[int]) -> Taps:
    return tuple(zip(flat[0::2], flat[1::2]))


# K2's forward as the torch op ``iaf::masked_conv2d`` (``masked_conv2d_op``),
# ``taps`` flattened (dy0, dx0, dy1, dx1, ...): the kernel on CUDA tensors,
# the twin on CPU tensors, a fake for tracing; registered as K1's is
# (``ops/ar_stack.py``), so an exported program launches the kernel.
_LIB = torch.library.Library("iaf", "FRAGMENT")
_LIB.define("masked_conv2d(Tensor x, Tensor w, int[] taps) -> Tensor")
_LIB.impl("masked_conv2d",
          lambda x, w, taps: masked_conv2d_ref(x, w, _pairs(taps)), "CPU")
# as K1's: an exported program may hand over a non-contiguous x
_LIB.impl("masked_conv2d",
          lambda x, w, taps: _fwd(x.contiguous(), w, _pairs(taps)), "CUDA")


@torch.library.register_fake("iaf::masked_conv2d", lib=_LIB)
def _masked_conv2d_fake(x, w, taps):
    n, h, w_, _ = x.shape
    return x.new_empty((n, h, w_, w.shape[3]), dtype=torch.float32)


masked_conv2d_op = torch.ops.iaf.masked_conv2d.default


def masked_conv2d(x: torch.Tensor, w: torch.Tensor,
                  taps: Iterable | None = None) -> torch.Tensor:
    """The stride-1 SAME conv of ``x`` [N,H,W,cin] with the folded, masked
    weights ``w`` [kh,kw,cin,cout] (odd kh, kw; x's dtype) over ``taps``
    (default: every tap), as unrounded f32 [N,H,W,cout]. Under autograd:
    ``_MaskedConv2d`` on CUDA, the twin on the CPU; else the op
    ``iaf::masked_conv2d`` (``masked_conv2d_op``) on either."""
    _check(x, w)
    taps = _taps(w, taps)
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"masked_conv2d: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if x.device.type == "cpu":
            return masked_conv2d_ref(x, w, taps)
        return _MaskedConv2d.apply(x, w, taps)
    return masked_conv2d_op(x, w, [v for tap in taps for v in tap])
