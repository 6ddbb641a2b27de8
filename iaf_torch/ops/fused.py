"""K3 (IAF update) as a Triton kernel and K4 (discretized-logistic
log-likelihood) as a CUDA C++ kernel, forward and backward, each with its
plain PyTorch twin.

K3 replaces ``iaf_tpu/ops/fused.py:_iaf_kernel``: z' = (z - m) * exp(-s)
and logqs' = logqs + s, elementwise, both outputs written in one pass. At
the eval shape (4 x [1024, 16, 16, 32] f32 in, 2 out) it moves ~201 MB and
does ~5 operations per element, so it is bound by bytes (~60 us at
3.35 TB/s); the design is one flat masked pass with 16-byte-per-thread
loads and nothing else, so each byte moves once. Its backward (the
analytic ``_iaf_bwd``: dz = g_z * exp(-s), dm = -dz, ds = -g_z * z' + g_lq,
dlogqs = g_lq) is the same kind of pass: it reads g_z, z' and s and writes
dz, dm and ds (g_lq passes through untouched), 6 x 4 bytes per element.

K4 replaces ``iaf_tpu/ops/fused.py:_dl_kernel`` and its backward
``_dl_bwd``: per example, the sum over H*W*C of log(sigmoid(x + b/s) -
sigmoid(x) + 1e-7) with x = (floor(sample / b) * b - mean) / s. Its kernels
are ``csrc/disc_logistic.cu`` (the design and its bound are described
there): each row is split over a thread-block cluster of ``dl_plan(rows,
row_len)`` blocks, the sums are taken in a fixed order, and the backward
writes dmean and sums dlogscale over all rows in the same launch (a grid
ticket on an int32 counter that the wrapper allocates once per device and
the kernel sets back to 0). ``logscale`` is read from a one-element device
tensor (the Pallas kernel's SMEM scalar operand), so the host never waits
on the device for it. The terms follow the twin's arithmetic step for
step, with correctly rounded divisions and no contraction into FMAs; for a
bin size that is a power of two (``_pow2_binsize``) the kernel takes
sample * (1/b) for sample / b, the same float. With D = sigmoid(x + b/s) -
sigmoid(x) + 1e-7 and sigmoid' = sigmoid * (1 - sigmoid), dmean = g *
(sigmoid'(lo) - sigmoid'(hi)) / (D * s) and dlogscale = sum g *
(sigmoid'(lo) * x - sigmoid'(hi) * (x + b/s)) / D; the floor has no
gradient.

Under autograd the wrappers are ``torch.autograd.Function``s whose
backward launches the backward kernel; on CPU tensors they are the twins,
which autograd differentiates. On a CUDA tensor a wrapper launches its
kernel or raises; nothing falls back.

Triton is imported, and the CUDA library built, inside the launching
functions: the package imports (and the CPU tests run the twins) where
neither Triton nor nvcc is present.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch

from iaf_torch.distributions import discretized_logistic
from iaf_torch.ops import _build
from iaf_torch.ops.ar_stack import _raise_on

launches = {"iaf_update": 0, "disc_logistic_logp": 0,
            "iaf_update_bwd": 0, "disc_logistic_logp_bwd": 0}

_IAF_BLOCK = 1024
_DL_THREADS = 256       # disc_logistic.cu DL_THREADS: threads a block
_DL_MAX_SPLITS = 8      # blocks a row's cluster may have (the portable most)
_DL_MIN_PER_BLOCK = 2 * _DL_THREADS  # elements a block takes at least
_SMS = 132              # streaming multiprocessors of an H100 SXM


def iaf_update_ref(z, m, s, logqs):
    return (z - m) * torch.exp(-s), logqs + s


def disc_logistic_ref(mean, logscale, sample, binsize: float = 1.0 / 256.0):
    return discretized_logistic(mean, logscale, sample, binsize)


def iaf_update_bwd_ref(z, m, s, logqs, g_z, g_lq):
    """The plain backward: autograd of the twin. Returns (dz, dm, ds,
    dlogqs)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (z, m, s, logqs)]
        outs = iaf_update_ref(*ins)
        return torch.autograd.grad(outs, ins, (g_z, g_lq))


def disc_logistic_bwd_ref(mean, logscale, sample, g,
                          binsize: float = 1.0 / 256.0):
    """The plain backward: autograd of the twin. Returns (dmean,
    dlogscale)."""
    with torch.enable_grad():
        mean_, ls_ = (t.detach().requires_grad_() for t in (mean, logscale))
        out = disc_logistic_ref(mean_, ls_, sample, binsize)
        return torch.autograd.grad(out, (mean_, ls_), g)


@functools.cache
def _kernels():
    # Triton's compile cache goes under the checkout's build directory,
    # beside the CUDA library, not under $HOME
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl
    try:
        from triton.language.extra import libdevice
    except ImportError:  # older layout of the Triton package
        from triton.language.extra.cuda import libdevice

    @triton.jit
    def iaf_kernel(z_ptr, m_ptr, s_ptr, lq_ptr, zo_ptr, lqo_ptr, n,
                   BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        msk = offs < n
        z = tl.load(z_ptr + offs, mask=msk)
        m = tl.load(m_ptr + offs, mask=msk)
        s = tl.load(s_ptr + offs, mask=msk)
        lq = tl.load(lq_ptr + offs, mask=msk)
        tl.store(zo_ptr + offs, (z - m) * libdevice.exp(-s), mask=msk)
        tl.store(lqo_ptr + offs, lq + s, mask=msk)

    @triton.jit
    def iaf_bwd_kernel(gz_ptr, glq_ptr, zo_ptr, s_ptr, dz_ptr, dm_ptr, ds_ptr,
                       n, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        msk = offs < n
        gz = tl.load(gz_ptr + offs, mask=msk)
        glq = tl.load(glq_ptr + offs, mask=msk)
        zo = tl.load(zo_ptr + offs, mask=msk)
        s = tl.load(s_ptr + offs, mask=msk)
        dz = gz * libdevice.exp(-s)
        tl.store(dz_ptr + offs, dz, mask=msk)
        tl.store(dm_ptr + offs, -dz, mask=msk)
        tl.store(ds_ptr + offs, glq - gz * zo, mask=msk)

    return iaf_kernel, iaf_bwd_kernel


def _cuda_inputs(name, *ts):
    dev = ts[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    for t in ts:
        if t.device != dev:
            raise RuntimeError(f"{name}: inputs on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: inputs must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _iaf_fwd(z, m, s, logqs):
    _cuda_inputs("iaf_update", z, m, s, logqs)
    iaf_kernel = _kernels()[0]
    n = z.numel()
    z_out, lq_out = torch.empty_like(z), torch.empty_like(logqs)
    with torch.cuda.device(z.device):
        iaf_kernel[(-(-n // _IAF_BLOCK),)](z, m, s, logqs, z_out, lq_out, n,
                                          BLOCK=_IAF_BLOCK, num_warps=4)
    launches["iaf_update"] += 1
    return z_out, lq_out


def iaf_update_bwd(z_new, s, g_z, g_lq):
    """K3's backward kernel: (dz, dm, ds, dlogqs) from the saved output
    z' and s and the upstream gradients (dlogqs is ``g_lq`` itself)."""
    _cuda_inputs("iaf_update_bwd", z_new, s, g_z, g_lq)
    iaf_bwd_kernel = _kernels()[1]
    n = z_new.numel()
    dz, dm, ds = (torch.empty_like(z_new) for _ in range(3))
    with torch.cuda.device(z_new.device):
        iaf_bwd_kernel[(-(-n // _IAF_BLOCK),)](g_z, g_lq, z_new, s, dz, dm,
                                              ds, n, BLOCK=_IAF_BLOCK,
                                              num_warps=4)
    launches["iaf_update_bwd"] += 1
    return dz, dm, ds, g_lq


class _IAFUpdate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, m, s, logqs):
        z_out, lq_out = _iaf_fwd(z, m, s, logqs)
        ctx.save_for_backward(z_out, s)
        return z_out, lq_out

    @staticmethod
    def backward(ctx, g_z, g_lq):
        z_out, s = ctx.saved_tensors
        return iaf_update_bwd(z_out, s, g_z.contiguous(), g_lq.contiguous())


# K3's and K4's forwards as the torch ops ``iaf::iaf_update``
# (``iaf_update_op``; both outputs new tensors) and
# ``iaf::disc_logistic_logp`` (``disc_logistic_op``): the kernel on CUDA
# tensors, the twin on CPU tensors, a fake for tracing; registered as K1's
# is (``ops/ar_stack.py``), so an exported program launches the kernels.
# An exported program keeps a ``.contiguous()`` only where the trace saw a
# non-contiguous tensor; the kernels need their inputs contiguous.
_LIB = torch.library.Library("iaf", "FRAGMENT")
_LIB.define("iaf_update(Tensor z, Tensor m, Tensor s, Tensor logqs) "
            "-> (Tensor, Tensor)")
_LIB.impl("iaf_update", iaf_update_ref, "CPU")
_LIB.impl("iaf_update", lambda z, m, s, logqs: _iaf_fwd(
    *(t.contiguous() for t in (z, m, s, logqs))), "CUDA")


@torch.library.register_fake("iaf::iaf_update", lib=_LIB)
def _iaf_update_fake(z, m, s, logqs):
    return torch.empty_like(z), torch.empty_like(logqs)


iaf_update_op = torch.ops.iaf.iaf_update.default


def iaf_update(z, m, s, logqs):
    """IAF division update with the elementwise running log-det-J:
    returns ((z - m) * exp(-s), logqs + s). Under autograd: ``_IAFUpdate``
    on CUDA, the twin on the CPU; else the op ``iaf::iaf_update``
    (``iaf_update_op``) on either."""
    if not z.shape == m.shape == s.shape == logqs.shape:
        raise ValueError("iaf_update: shapes differ")
    if z.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"iaf_update: no kernel for device {z.device}")
    if _needs_grad(z, m, s, logqs):
        if z.device.type == "cpu":
            return iaf_update_ref(z, m, s, logqs)
        return _IAFUpdate.apply(z, m, s, logqs)
    return iaf_update_op(z, m, s, logqs)


def _dl_chunk(row_len: int, splits: int) -> int:
    """Elements of a row that each block of a ``splits``-block cluster
    takes (disc_logistic.cu ``dl_chunk``): a multiple of 4, so that every
    block's slice of an aligned row is aligned."""
    return (-(-row_len // splits) + 3) // 4 * 4


def dl_plan(rows: int, row_len: int) -> int:
    """Blocks S (1, 2, 4 or 8: one thread-block cluster) over which K4
    splits each of ``rows`` rows of ``row_len`` elements: the fewest that
    give the card two blocks per SM, at most 8, and fewer where a block
    would take under ``_DL_MIN_PER_BLOCK`` elements or none."""
    splits = 1
    while splits < _DL_MAX_SPLITS and rows * splits < 2 * _SMS:
        splits *= 2
    while splits > 1 and (row_len < splits * _DL_MIN_PER_BLOCK or (
            splits - 1) * _dl_chunk(row_len, splits) >= row_len):
        splits //= 2
    return splits


def _pow2_binsize(binsize: float) -> bool:
    """Whether ``binsize`` is a power of two whose reciprocal, like
    itself, is a normal float32: then sample / b and sample * (1/b) are
    the same float for every sample (both exact scalings)."""
    mant, exp = math.frexp(binsize)
    return mant == 0.5 and -126 <= exp - 1 <= 126


@functools.cache
def _dl_lib() -> ctypes.CDLL:
    lib = _build.load("disc_logistic")
    lib.dl_fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.dl_bwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.dl_launch_floor.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    for fn in (lib.dl_fwd, lib.dl_bwd, lib.dl_launch_floor):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _dl_counter(index: int) -> torch.Tensor:
    """The backward's grid ticket on card ``index``: one int32, zeroed once
    here and set back to 0 by every launch that used it."""
    return torch.zeros((1,), dtype=torch.int32,
                       device=torch.device("cuda", index))


def _dl_shape(name, mean, sample, logscale, splits):
    """(rows, row_len, splits) of a K4 call; ``splits`` None takes
    ``dl_plan``'s."""
    if mean.shape != sample.shape or logscale.numel() != 1:
        raise ValueError(f"{name}: mean {tuple(mean.shape)} and sample "
                         f"{tuple(sample.shape)} must match, logscale hold "
                         "one value")
    rows = mean.shape[0] if mean.dim() else 0
    row_len = mean.numel() // rows if rows else 0
    if row_len == 0 or row_len >= 2**31:
        raise ValueError(f"{name}: rows of {tuple(mean.shape[1:])} elements")
    if splits is None:
        splits = dl_plan(rows, row_len)
    if splits not in (1, 2, 4, 8) or rows * splits >= 2**31:
        raise ValueError(f"{name}: {rows} rows in {splits} splits each")
    return rows, row_len, splits


def _dl_fwd(mean, logscale, sample, binsize, splits=None):
    _cuda_inputs("disc_logistic_logp", mean, sample, logscale)
    rows, row_len, splits = _dl_shape("disc_logistic_logp", mean, sample,
                                      logscale, splits)
    out = torch.empty((rows,), device=mean.device, dtype=torch.float32)
    with torch.cuda.device(mean.device):
        err = _dl_lib().dl_fwd(
            mean.data_ptr(), sample.data_ptr(), logscale.data_ptr(),
            out.data_ptr(), rows, row_len, splits, float(binsize),
            int(_pow2_binsize(binsize)),
            torch.cuda.current_stream(mean.device).cuda_stream)
    _raise_on(err, "disc_logistic_logp")
    launches["disc_logistic_logp"] += 1
    return out


def disc_logistic_bwd(mean, logscale, sample, g,
                      binsize: float = 1.0 / 256.0, splits=None):
    """K4's backward kernel: (dmean, dlogscale) for the upstream gradient
    ``g`` [N]; ``logscale`` is a one-element tensor and dlogscale has its
    shape. One launch: the rows' shares of dlogscale are summed in it.
    ``splits`` forces the blocks a row is split over (``dl_plan``'s if
    None)."""
    _cuda_inputs("disc_logistic_logp_bwd", mean, sample, logscale, g)
    rows, row_len, splits = _dl_shape("disc_logistic_logp_bwd", mean,
                                      sample, logscale, splits)
    if g.numel() != rows:
        raise ValueError("disc_logistic_bwd: g must hold one value a row")
    dmean = torch.empty_like(mean)
    dls = torch.empty(logscale.shape, device=mean.device, dtype=torch.float32)
    part = torch.empty((rows,), device=mean.device, dtype=torch.float32)
    with torch.cuda.device(mean.device):
        err = _dl_lib().dl_bwd(
            mean.data_ptr(), sample.data_ptr(), logscale.data_ptr(),
            g.data_ptr(), dmean.data_ptr(), part.data_ptr(), dls.data_ptr(),
            _dl_counter(mean.device.index).data_ptr(), rows, row_len, splits,
            float(binsize), int(_pow2_binsize(binsize)),
            torch.cuda.current_stream(mean.device).cuda_stream)
    _raise_on(err, "disc_logistic_logp_bwd")
    launches["disc_logistic_logp_bwd"] += 1
    return dmean, dls


class _DiscLogistic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mean, logscale, sample, binsize):
        ctx.save_for_backward(mean, logscale, sample)
        ctx.binsize = binsize
        return _dl_fwd(mean, logscale, sample, binsize)

    @staticmethod
    def backward(ctx, g):
        mean, logscale, sample = ctx.saved_tensors
        dmean, dls = disc_logistic_bwd(mean, logscale, sample, g.contiguous(),
                                       ctx.binsize)
        return dmean, dls, None, None


_LIB.define("disc_logistic_logp(Tensor mean, Tensor logscale, "
            "Tensor sample, float binsize) -> Tensor")
_LIB.impl("disc_logistic_logp", disc_logistic_ref, "CPU")
_LIB.impl("disc_logistic_logp", lambda mean, logscale, sample, binsize:
          _dl_fwd(mean.contiguous(), logscale.reshape(1).contiguous(),
                  sample.contiguous(), binsize), "CUDA")


@torch.library.register_fake("iaf::disc_logistic_logp", lib=_LIB)
def _disc_logistic_fake(mean, logscale, sample, binsize):
    return mean.new_empty((mean.shape[0],), dtype=torch.float32)


disc_logistic_op = torch.ops.iaf.disc_logistic_logp.default


def disc_logistic_logp(mean, logscale, sample, binsize: float = 1.0 / 256.0):
    """Discretized-logistic log p(sample | mean, exp(logscale)) summed over
    all but the batch dim; ``logscale`` is a one-element tensor. ``sample``
    carries no gradient. Under autograd: ``_DiscLogistic`` on CUDA, the
    twin on the CPU; else the op ``iaf::disc_logistic_logp``
    (``disc_logistic_op``) on either."""
    if mean.shape != sample.shape:
        raise ValueError("disc_logistic_logp: mean and sample shapes differ")
    if mean.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"disc_logistic_logp: no kernel for device "
                           f"{mean.device}")
    if _needs_grad(mean, logscale, sample):
        if mean.device.type == "cpu":
            return disc_logistic_ref(mean, logscale, sample, binsize)
        if sample.requires_grad:
            raise ValueError("disc_logistic_logp: sample carries no "
                             "gradient")
        return _DiscLogistic.apply(mean, logscale.reshape(1), sample,
                                   binsize)
    return disc_logistic_op(mean, logscale, sample, float(binsize))
