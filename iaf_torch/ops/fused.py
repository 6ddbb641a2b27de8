"""K3 (IAF update) and K4 (discretized-logistic log-likelihood) as Triton
kernels, each with its plain PyTorch twin.

K3 replaces ``iaf_tpu/ops/fused.py:_iaf_kernel``: z' = (z - m) * exp(-s)
and logqs' = logqs + s, elementwise, both outputs written in one pass. At
the eval shape (4 x [1024, 16, 16, 32] f32 in, 2 out) it moves ~201 MB and
does ~5 operations per element, so it is bound by bytes (~60 us at
3.35 TB/s); the design is one flat masked pass with 16-byte-per-thread
loads and nothing else, so each byte moves once.

K4 replaces ``iaf_tpu/ops/fused.py:_dl_kernel``: per example, the sum over
H*W*C of log(sigmoid(x + b/s) - sigmoid(x) + 1e-7) with
x = (floor(sample / b) * b - mean) / s. At the eval shape (2 x [1024, 3072]
f32 in, [1024] out) it moves ~25 MB (~7.5 us at 3.35 TB/s) and does ~30
operations per element, so it too is bound by bytes. One program per
example loops over its row in power-of-two blocks and keeps the partial
sums in registers, so the row is read once and only the sum is written.
``logscale`` is read from a one-element device tensor (the Pallas kernel's
SMEM scalar operand) so the host never waits on the device for it, and
``binsize`` is a scalar argument. The division before the floor is
correctly rounded (``div_rn``): a sample on a bin edge must snap to that
bin, as in the twin.

Triton is imported inside the launching functions: the package imports
(and the CPU tests run the twins) where Triton is absent.
"""

from __future__ import annotations

import functools
import os

import torch

from iaf_torch.distributions import discretized_logistic
from iaf_torch.ops import _build

launches = {"iaf_update": 0, "disc_logistic_logp": 0}

_IAF_BLOCK = 1024
_DL_BLOCK = 1024


def iaf_update_ref(z, m, s, logqs):
    return (z - m) * torch.exp(-s), logqs + s


def disc_logistic_ref(mean, logscale, sample, binsize: float = 1.0 / 256.0):
    return discretized_logistic(mean, logscale, sample, binsize)


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
    def dl_kernel(mean_ptr, sample_ptr, logscale_ptr, out_ptr, row_len,
                  binsize, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        inv_scale = libdevice.exp(-tl.load(logscale_ptr))
        step = binsize * inv_scale
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        base = row * row_len
        for start in range(0, row_len, BLOCK):
            offs = start + tl.arange(0, BLOCK)
            msk = offs < row_len
            mean = tl.load(mean_ptr + base + offs, mask=msk, other=0.0)
            smp = tl.load(sample_ptr + base + offs, mask=msk, other=0.0)
            x = (libdevice.floor(libdevice.div_rn(smp, binsize)) * binsize
                 - mean) * inv_scale
            hi = 1.0 / (1.0 + libdevice.exp(-(x + step)))
            lo = 1.0 / (1.0 + libdevice.exp(-x))
            logp = libdevice.log(hi - lo + 1e-7)
            acc += tl.where(msk, logp, 0.0)
        tl.store(out_ptr + row, tl.sum(acc, axis=0))

    return iaf_kernel, dl_kernel


def _cuda_inputs(name, *ts):
    dev = ts[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    for t in ts:
        if t.device != dev:
            raise RuntimeError(f"{name}: inputs on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: inputs must be float32, got {t.dtype}")
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(f"{name}: forward-only kernel; run under "
                               "torch.inference_mode()")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def iaf_update(z, m, s, logqs):
    """IAF division update with the elementwise running log-det-J:
    returns ((z - m) * exp(-s), logqs + s)."""
    if not z.shape == m.shape == s.shape == logqs.shape:
        raise ValueError("iaf_update: shapes differ")
    if z.device.type == "cpu":
        return iaf_update_ref(z, m, s, logqs)
    _cuda_inputs("iaf_update", z, m, s, logqs)
    iaf_kernel, _ = _kernels()
    n = z.numel()
    z_out, lq_out = torch.empty_like(z), torch.empty_like(logqs)
    with torch.cuda.device(z.device):
        iaf_kernel[(-(-n // _IAF_BLOCK),)](z, m, s, logqs, z_out, lq_out, n,
                                          BLOCK=_IAF_BLOCK, num_warps=4)
    launches["iaf_update"] += 1
    return z_out, lq_out


def disc_logistic_logp(mean, logscale, sample, binsize: float = 1.0 / 256.0):
    """Discretized-logistic log p(sample | mean, exp(logscale)) summed over
    all but the batch dim; ``logscale`` is a one-element tensor."""
    if mean.shape != sample.shape:
        raise ValueError("disc_logistic_logp: mean and sample shapes differ")
    if mean.device.type == "cpu":
        return disc_logistic_ref(mean, logscale, sample, binsize)
    logscale = logscale.reshape(1)
    _cuda_inputs("disc_logistic_logp", mean, sample, logscale)
    _, dl_kernel = _kernels()
    n = mean.shape[0]
    out = torch.empty((n,), device=mean.device, dtype=torch.float32)
    with torch.cuda.device(mean.device):
        dl_kernel[(n,)](mean, sample, logscale, out, mean[0].numel(),
                        float(binsize), BLOCK=_DL_BLOCK, num_warps=4)
    launches["disc_logistic_logp"] += 1
    return out
