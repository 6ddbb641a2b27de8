"""K3 (IAF update) and K4 (discretized-logistic log-likelihood) as Triton
kernels, forward and backward, each with its plain PyTorch twin.

K3 replaces ``iaf_tpu/ops/fused.py:_iaf_kernel``: z' = (z - m) * exp(-s)
and logqs' = logqs + s, elementwise, both outputs written in one pass. At
the eval shape (4 x [1024, 16, 16, 32] f32 in, 2 out) it moves ~201 MB and
does ~5 operations per element, so it is bound by bytes (~60 us at
3.35 TB/s); the design is one flat masked pass with 16-byte-per-thread
loads and nothing else, so each byte moves once. Its backward (the
analytic ``_iaf_bwd``: dz = g_z * exp(-s), dm = -dz, ds = -g_z * z' + g_lq,
dlogqs = g_lq) is the same kind of pass: it reads g_z, z' and s and writes
dz, dm and ds (g_lq passes through untouched), 6 x 4 bytes per element.

K4 replaces ``iaf_tpu/ops/fused.py:_dl_kernel``: per example, the sum over
H*W*C of log(sigmoid(x + b/s) - sigmoid(x) + 1e-7) with
x = (floor(sample / b) * b - mean) / s. At the eval shape (2 x [1024, 3072]
f32 in, [1024] out) it moves ~25 MB (~7.5 us at 3.35 TB/s) and does ~30
operations per element, so it too is bound by bytes. One program per
example loops over its row in power-of-two blocks and keeps the partial
sums in registers, so the row is read once and only the sum is written.
``logscale`` is read from a one-element device tensor (the Pallas kernel's
SMEM scalar operand) so the host never waits on the device for it, and
``binsize`` is a scalar argument. The terms follow the twin's arithmetic
step for step, with correctly rounded divisions (``div_rn``) and no
contraction into FMAs: a sample on a bin edge must snap to that bin, and
sigmoid(x + b/s) - sigmoid(x) cancels, so an ulp of difference would be
amplified. Its backward (``_dl_bwd``, the twin's VJP) is one program per
example row too: it reads mean and sample once, writes dmean,
and keeps the row's share of dlogscale in registers; the [N] row partials
are then summed. With D = sigmoid(x + b/s) - sigmoid(x) + 1e-7 and
sigmoid' = sigmoid * (1 - sigmoid), dmean = g * (sigmoid'(lo) -
sigmoid'(hi)) / (D * s) and dlogscale = sum g * (sigmoid'(lo) * x -
sigmoid'(hi) * (x + b/s)) / D; the floor has no gradient.

Under autograd the wrappers are ``torch.autograd.Function``s whose
backward launches the backward kernel; on CPU tensors they are the twins,
which autograd differentiates.

Triton is imported inside the launching functions: the package imports
(and the CPU tests run the twins) where Triton is absent.
"""

from __future__ import annotations

import functools
import os

import torch

from iaf_torch.distributions import discretized_logistic
from iaf_torch.ops import _build

launches = {"iaf_update": 0, "disc_logistic_logp": 0,
            "iaf_update_bwd": 0, "disc_logistic_logp_bwd": 0}

_IAF_BLOCK = 1024
_DL_BLOCK = 1024


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

    @triton.jit
    def _dl_terms(mean, smp, scale, step, binsize):
        # the twin's arithmetic, operation for operation: x and the upper
        # edge divide by the scale, and sigmoid is 1 / (1 + exp(-v)) with
        # correctly rounded divisions. D = sigmoid(hi) - sigmoid(lo)
        # cancels (b/s = 1/256 at logscale 0), so an ulp of difference in
        # x or a sigmoid would come out ~250 times larger.
        x = libdevice.div_rn(
            libdevice.floor(libdevice.div_rn(smp, binsize)) * binsize - mean,
            scale)
        hi = libdevice.div_rn(1.0, 1.0 + libdevice.exp(-(x + step)))
        lo = libdevice.div_rn(1.0, 1.0 + libdevice.exp(-x))
        return x, hi, lo

    @triton.jit
    def dl_kernel(mean_ptr, sample_ptr, logscale_ptr, out_ptr, row_len,
                  binsize, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        scale = libdevice.exp(tl.load(logscale_ptr))
        step = libdevice.div_rn(binsize, scale)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        base = row * row_len
        for start in range(0, row_len, BLOCK):
            offs = start + tl.arange(0, BLOCK)
            msk = offs < row_len
            mean = tl.load(mean_ptr + base + offs, mask=msk, other=0.0)
            smp = tl.load(sample_ptr + base + offs, mask=msk, other=0.0)
            x, hi, lo = _dl_terms(mean, smp, scale, step, binsize)
            logp = libdevice.log(hi - lo + 1e-7)
            acc += tl.where(msk, logp, 0.0)
        tl.store(out_ptr + row, tl.sum(acc, axis=0))

    @triton.jit
    def dl_bwd_kernel(mean_ptr, sample_ptr, logscale_ptr, g_ptr, dmean_ptr,
                      part_ptr, row_len, binsize, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        scale = libdevice.exp(tl.load(logscale_ptr))
        step = libdevice.div_rn(binsize, scale)
        g = tl.load(g_ptr + row)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        base = row * row_len
        for start in range(0, row_len, BLOCK):
            offs = start + tl.arange(0, BLOCK)
            msk = offs < row_len
            mean = tl.load(mean_ptr + base + offs, mask=msk, other=0.0)
            smp = tl.load(sample_ptr + base + offs, mask=msk, other=0.0)
            x, hi, lo = _dl_terms(mean, smp, scale, step, binsize)
            gd = libdevice.div_rn(tl.zeros([BLOCK], tl.float32) + g,
                                  hi - lo + 1e-7)
            # sigmoid' as autograd takes it, (g * (1 - y)) * y
            d_hi = (gd * (1.0 - hi)) * hi        # d/d(x + b/s)
            d_lo = (-gd * (1.0 - lo)) * lo       # d/dx
            dx = d_hi + d_lo
            tl.store(dmean_ptr + base + offs, -libdevice.div_rn(dx, scale),
                     mask=msk)
            # d(x)/d(logscale) = -x, d(x + b/s)/d(logscale) = -(x + b/s)
            acc += tl.where(msk, -(dx * x + d_hi * step), 0.0)
        tl.store(part_ptr + row, tl.sum(acc, axis=0))

    return iaf_kernel, iaf_bwd_kernel, dl_kernel, dl_bwd_kernel


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


def iaf_update(z, m, s, logqs):
    """IAF division update with the elementwise running log-det-J:
    returns ((z - m) * exp(-s), logqs + s)."""
    if not z.shape == m.shape == s.shape == logqs.shape:
        raise ValueError("iaf_update: shapes differ")
    if z.device.type == "cpu":
        return iaf_update_ref(z, m, s, logqs)
    if _needs_grad(z, m, s, logqs):
        return _IAFUpdate.apply(z, m, s, logqs)
    return _iaf_fwd(z, m, s, logqs)


def _dl_fwd(mean, logscale, sample, binsize):
    _cuda_inputs("disc_logistic_logp", mean, sample, logscale)
    dl_kernel = _kernels()[2]
    n = mean.shape[0]
    out = torch.empty((n,), device=mean.device, dtype=torch.float32)
    with torch.cuda.device(mean.device):
        dl_kernel[(n,)](mean, sample, logscale, out, mean[0].numel(),
                        float(binsize), BLOCK=_DL_BLOCK, num_warps=4,
                        enable_fp_fusion=False)
    launches["disc_logistic_logp"] += 1
    return out


def disc_logistic_bwd(mean, logscale, sample, g,
                      binsize: float = 1.0 / 256.0):
    """K4's backward kernel: (dmean, dlogscale) for the upstream gradient
    ``g`` [N]; ``logscale`` is a one-element tensor and dlogscale has its
    shape. The [N] per-row partials of dlogscale are summed in a second
    pass."""
    _cuda_inputs("disc_logistic_logp_bwd", mean, sample, logscale, g)
    dl_bwd_kernel = _kernels()[3]
    n = mean.shape[0]
    dmean = torch.empty_like(mean)
    part = torch.empty((n,), device=mean.device, dtype=torch.float32)
    with torch.cuda.device(mean.device):
        dl_bwd_kernel[(n,)](mean, sample, logscale, g, dmean, part,
                            mean[0].numel(), float(binsize), BLOCK=_DL_BLOCK,
                            num_warps=4, enable_fp_fusion=False)
    launches["disc_logistic_logp_bwd"] += 1
    return dmean, part.sum().reshape(logscale.shape)


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


def disc_logistic_logp(mean, logscale, sample, binsize: float = 1.0 / 256.0):
    """Discretized-logistic log p(sample | mean, exp(logscale)) summed over
    all but the batch dim; ``logscale`` is a one-element tensor. ``sample``
    carries no gradient."""
    if mean.shape != sample.shape:
        raise ValueError("disc_logistic_logp: mean and sample shapes differ")
    if mean.device.type == "cpu":
        return disc_logistic_ref(mean, logscale, sample, binsize)
    logscale = logscale.reshape(1)
    if sample.requires_grad:
        raise ValueError("disc_logistic_logp: sample carries no gradient")
    if _needs_grad(mean, logscale):
        return _DiscLogistic.apply(mean, logscale, sample, binsize)
    return _dl_fwd(mean, logscale, sample, binsize)
