"""The IAF layer's inference glue around cuDNN's trunk convs as five
Triton passes, each with its plain PyTorch twin.

No TPU kernel is replaced: the JAX package leaves this glue to XLA, which
fuses it into the convs' neighbours. Run as PyTorch's own passes it was
three quarters of an eval chunk on the H100 (110 of 147 ms at 1024 rows):
around every bf16 trunk conv a cast, a pad, layout copies, the f32
widening and the bias add, then ELU, the 0.1 residual, the Gaussian
sample and log-densities, the context sum, the KL and the ``cat`` before
``down_conv2``, each a pass over device memory. Each pass here reads a
conv's raw bf16 output (NHWC, bias not added) once and writes, once, the
next conv's bf16 input and the f32 state that later code needs. A conv
input is written with the conv's SAME zero border of ``pad`` pixels
around every image ([N, H + 2 pad, W + 2 pad, C], NHWC), so that the conv
runs unpadded on it (``WNConv2d.raw``), on the algorithm cuDNN picks for
the plain route's ``F.pad``-ed input, with no pad copy (with its padding
inside the conv, cuDNN's pick for the 384- and 448-channel convs at 1024
rows took 0.469 ms a layer more on an H100):

- ``elu_bf16(h, pad)``: bf16 ELU(h), the first conv's input after the
  stem and from ``h_top`` (a channel vector broadcast over the rows);
- ``residual_elu(h, out, b, pad)`` (after ``up_conv3`` and
  ``down_conv2``): h' = h + 0.1 * (out + b) in f32 and bf16 ELU(h'), the
  next conv's input (the deconv's, unpadded, after the last layer);
- ``up_stats(out, b, hs, pad)`` (after ``up_conv1``): bf16 ELU(hidden +
  b) of the last ``hs`` channels, ``up_conv3``'s input; the posterior's
  statistics stay in the raw bf16 output, read with their bias later;
- ``posterior(down, db, up, ub, eps)`` (after ``down_conv1``): the
  posterior sample z (f32, and bf16 for K1), its log-density and K1's
  f32 context, up_context + down_context;
- ``kl_join(z, logqs, down, db, pad)`` (after K3): per row and channel
  the spatial sums of logqs - log p_prior(z) (and each row's total), and
  bf16 ELU(cat[z, h_det + b]), ``down_conv2``'s input, with no ``cat``
  buffer.

The arithmetic is the twins' (the model's formulas): bf16 -> f32 is
exact, the bias adds, the 0.1 residual and the Gaussians' terms are the
same f32 operations in the same order, compiled with
``enable_fp_fusion=False`` (no FMA contraction), ELU and the log-densities
take libdevice's ``expm1f``/``expf`` (no fast-math), and bf16 rounds to
nearest even. The KL sums of a row are taken by one program in a fixed
order, so two calls give the same bits. All five are bound by bytes: at
the eval's 1024 rows (z 32, h 160, 16x16) a layer's passes move ~2.1 GB.
A program of ``residual_elu`` takes one row of an image with its border
(the row of h inside it is W x C contiguous elements); one of the others
a block of pixels, walking the channels in slices of ``_group`` (16-byte
loads of bf16 at the paper's widths); ``kl_join``'s grid is a program a
row for the KL sums and the z half of the join, beside programs over
pixel blocks for the h_det half.

Each is a torch op in the ``iaf`` namespace (the kernel on CUDA tensors,
the twin on CPU tensors, a fake for tracing), so ``torch.export`` records
it, and counts its launches (``launches``). The passes have no backward:
the model takes them only where autograd does not record
(``models/cvae.py — fused_route``); a wrapper called under autograd
raises. Triton is imported inside the launching functions, as in
``fused.py``.
"""

from __future__ import annotations

import functools
import math
import os

import torch
import torch.nn.functional as F

from iaf_torch.distributions import DiagonalGaussian
from iaf_torch.ops import _build

launches = {"elu_bf16": 0, "residual_elu": 0, "up_stats": 0,
            "posterior": 0, "kl_join": 0}

RESIDUAL_SCALE = 0.1
_LOG2PI = math.log(2.0 * math.pi)
_BP = 32                # pixels a program of the sliced passes takes
_ROW_BLOCK = 1024       # elements of an image row the residual loads at once
_WARPS = 4
# the kernels index elements with 32-bit offsets; every input and output
# holds fewer elements than this, which leaves room for a masked lane's
# offset past a tensor's end
_MAX_NUMEL = 2**30


# ---------------------------------------------------------------------------
# the twins: the model's formulas (``models/cvae.py``, ``nn/layers.py``)

def _split(x, sizes):
    out, start = [], 0
    for s in sizes:
        out.append(x[..., start:start + s])
        start += s
    return out


def _widths(down: torch.Tensor, zs: int) -> int:
    """``hs`` from ``down_conv1``'s 4 zs + 2 hs channels."""
    extra = down.shape[-1] - 4 * zs
    hs = extra // 2
    if extra % 2 or hs <= 0:
        raise ValueError(f"down_conv1's {down.shape[-1]} channels are not "
                         f"4 * {zs} + 2 * hs")
    return hs


def padded(a: torch.Tensor, pad: int) -> torch.Tensor:
    """NHWC ``a`` with a zero border of ``pad`` pixels, NHWC-contiguous:
    the plain route's ``F.pad`` of a conv's input (``nn/layers.py —
    _conv``)."""
    if not pad:
        return a
    return F.pad(a.permute(0, 3, 1, 2), (pad,) * 4).permute(
        0, 2, 3, 1).contiguous()


def elu_bf16_ref(h, pad: int):
    return padded(F.elu(h).to(torch.bfloat16), pad)


def residual_elu_ref(h, out, b, pad: int):
    h = h + RESIDUAL_SCALE * (out.float() + b)
    return h, padded(F.elu(h).to(torch.bfloat16), pad)


def up_stats_ref(out, b, hs: int, pad: int):
    x = out.float() + b
    return padded(F.elu(x[..., x.shape[-1] - hs:]).to(torch.bfloat16), pad)


def posterior_ref(down, db, up, ub, eps):
    zs = eps.shape[-1]
    hs = _widths(down, zs)
    qz_mean, qz_logsd, up_context, _ = _split(up.float() + ub,
                                              [zs, zs, hs, hs])
    _, _, rz_mean, rz_logsd, down_context, _ = _split(
        down.float() + db, [zs, zs, zs, zs, hs, hs])
    posterior = DiagonalGaussian(qz_mean + rz_mean,
                                 2.0 * (qz_logsd + rz_logsd))
    z = posterior.sample(eps)
    return (z, z.to(torch.bfloat16), posterior.logps(z),
            up_context + down_context)


def kl_join_ref(z, logqs, down, db, pad: int):
    zs = z.shape[-1]
    hs = _widths(down, zs)
    pz_mean, pz_logsd, _, _, _, h_det = _split(down.float() + db,
                                               [zs, zs, zs, zs, hs, hs])
    kl = logqs - DiagonalGaussian(pz_mean, 2.0 * pz_logsd).logps(z)
    joined = F.elu(torch.cat([z, h_det], dim=-1)).to(torch.bfloat16)
    return (torch.sum(kl, dim=(1, 2)), torch.sum(kl, dim=(1, 2, 3)),
            padded(joined, pad))


# ---------------------------------------------------------------------------
# the kernels

@functools.cache
def _kernels():
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl
    try:
        from triton.language.extra import libdevice
    except ImportError:  # older layout of the Triton package
        from triton.language.extra.cuda import libdevice

    @triton.jit
    def _elu(x):
        return tl.where(x > 0, x, libdevice.expm1(x))

    @triton.jit
    def _logps(x, mean, logvar, log2pi):
        # DiagonalGaussian.logps, term by term
        d = x - mean
        return -0.5 * ((logvar + log2pi) + d * d * libdevice.exp(-logvar))

    @triton.jit
    def _source(p, H, W, PAD):
        # pixel p of [N, H + 2 PAD, W + 2 PAD] -> (its pixel of [N, H, W],
        # whether it lies inside the zero border); H, W, PAD constexpr
        if PAD == 0:
            src = p
            inside = p >= 0
        else:
            xp = p % (W + 2 * PAD)
            yp = (p // (W + 2 * PAD)) % (H + 2 * PAD)
            inside = ((yp >= PAD) & (yp < H + PAD) & (xp >= PAD)
                      & (xp < W + PAD))
            img = p // ((W + 2 * PAD) * (H + 2 * PAD))
            src = (img * H + yp - PAD) * W + xp - PAD
        return src, inside

    @triton.jit
    def glue_residual_elu_kernel(h_ptr, o_ptr, b_ptr, ho_ptr, a_ptr, scale,
                                 C: tl.constexpr, H: tl.constexpr,
                                 W: tl.constexpr, PAD: tl.constexpr,
                                 RES: tl.constexpr, BCAST: tl.constexpr,
                                 BLOCK: tl.constexpr):
        # program (image, row of a): the row with its border; inside the
        # border a row of h, W * C contiguous elements
        WP: tl.constexpr = W + 2 * PAD
        row = tl.program_id(1)
        arow = a_ptr + (tl.program_id(0) * (H + 2 * PAD) + row) * WP * C
        k = tl.arange(0, BLOCK)
        zero = tl.zeros([BLOCK], tl.bfloat16)
        if (row < PAD) | (row >= H + PAD):
            for off in range(0, WP * C, BLOCK):
                tl.store(arow + off + k, zero, mask=off + k < WP * C)
        else:
            src = (tl.program_id(0) * H + row - PAD) * W * C
            for off in range(0, W * C, BLOCK):
                e = off + k
                m = e < W * C
                c = e % C
                if BCAST:   # h: one channel vector broadcast over pixels
                    h = tl.load(h_ptr + c, mask=m)
                else:
                    h = tl.load(h_ptr + src + e, mask=m)
                if RES:
                    hid = (tl.load(o_ptr + src + e, mask=m).to(tl.float32)
                           + tl.load(b_ptr + c, mask=m))
                    h = h + scale * hid
                    tl.store(ho_ptr + src + e, h, mask=m)
                tl.store(arow + PAD * C + e, _elu(h).to(tl.bfloat16),
                         mask=m)
            for off in range(0, PAD * C, BLOCK):
                m = off + k < PAD * C
                tl.store(arow + off + k, zero, mask=m)
                tl.store(arow + (W + PAD) * C + off + k, zero, mask=m)

    @triton.jit
    def glue_up_stats_kernel(o_ptr, b_ptr, a_ptr, P, CT: tl.constexpr,
                             CH: tl.constexpr, H: tl.constexpr,
                             W: tl.constexpr, PAD: tl.constexpr,
                             G: tl.constexpr, BP: tl.constexpr):
        p = (tl.program_id(0) * BP + tl.arange(0, BP))[:, None]
        pm = p < P
        src, inside = _source(p, H, W, PAD)
        g = tl.arange(0, G)[None, :]
        for j in tl.static_range(CH // G):
            c = CT - CH + j * G + g
            x = (tl.load(o_ptr + src * CT + c, mask=pm & inside).to(
                tl.float32) + tl.load(b_ptr + c))
            a = tl.where(inside, _elu(x), 0.0)
            tl.store(a_ptr + p * CH + j * G + g, a.to(tl.bfloat16), mask=pm)

    @triton.jit
    def glue_posterior_kernel(d_ptr, db_ptr, u_ptr, ub_ptr, e_ptr, z_ptr,
                              zb_ptr, lq_ptr, ctx_ptr, P, log2pi,
                              ZS: tl.constexpr, HS: tl.constexpr,
                              G: tl.constexpr, BP: tl.constexpr):
        CD: tl.constexpr = 4 * ZS + 2 * HS
        CU: tl.constexpr = 2 * ZS + 2 * HS
        p = (tl.program_id(0) * BP + tl.arange(0, BP))[:, None]
        pm = p < P
        g = tl.arange(0, G)[None, :]
        for j in tl.static_range(ZS // G):
            c = j * G + g
            qm = (tl.load(u_ptr + p * CU + c, mask=pm).to(tl.float32)
                  + tl.load(ub_ptr + c))
            ql = (tl.load(u_ptr + p * CU + ZS + c, mask=pm).to(tl.float32)
                  + tl.load(ub_ptr + ZS + c))
            rm = (tl.load(d_ptr + p * CD + 2 * ZS + c,
                          mask=pm).to(tl.float32)
                  + tl.load(db_ptr + 2 * ZS + c))
            rl = (tl.load(d_ptr + p * CD + 3 * ZS + c,
                          mask=pm).to(tl.float32)
                  + tl.load(db_ptr + 3 * ZS + c))
            eps = tl.load(e_ptr + p * ZS + c, mask=pm)
            mean = qm + rm
            logvar = 2.0 * (ql + rl)
            z = mean + libdevice.exp(0.5 * logvar) * eps
            tl.store(z_ptr + p * ZS + c, z, mask=pm)
            tl.store(zb_ptr + p * ZS + c, z.to(tl.bfloat16), mask=pm)
            tl.store(lq_ptr + p * ZS + c, _logps(z, mean, logvar, log2pi),
                     mask=pm)
        for j in tl.static_range(HS // G):
            c = j * G + g
            uc = (tl.load(u_ptr + p * CU + 2 * ZS + c,
                          mask=pm).to(tl.float32)
                  + tl.load(ub_ptr + 2 * ZS + c))
            dc = (tl.load(d_ptr + p * CD + 4 * ZS + c,
                          mask=pm).to(tl.float32)
                  + tl.load(db_ptr + 4 * ZS + c))
            tl.store(ctx_ptr + p * HS + c, uc + dc, mask=pm)

    @triton.jit
    def glue_kl_join_kernel(z_ptr, lq_ptr, d_ptr, db_ptr, s_ptr, t_ptr,
                            j_ptr, log2pi, H: tl.constexpr, W: tl.constexpr,
                            PAD: tl.constexpr, ZS: tl.constexpr,
                            HS: tl.constexpr, G: tl.constexpr,
                            BP: tl.constexpr):
        # program (row, 0): the row's KL sums, in a fixed order, and the z
        # half of its join; (row, 1 + t): the h_det half and the zero
        # border of pixel block t of the padded row
        CD: tl.constexpr = 4 * ZS + 2 * HS
        CJ: tl.constexpr = ZS + HS
        HW: tl.constexpr = H * W
        PIX: tl.constexpr = (H + 2 * PAD) * (W + 2 * PAD)
        row = tl.program_id(0)
        part = tl.program_id(1)
        g = tl.arange(0, G)[None, :]
        if part == 0:
            total = tl.zeros([G], tl.float32)
            for j in tl.static_range(ZS // G):
                c = j * G + g
                acc = tl.zeros([BP, G], tl.float32)
                for t in range(0, HW, BP):
                    q = (t + tl.arange(0, BP))[:, None]
                    qm = q < HW
                    p = row * HW + q
                    z = tl.load(z_ptr + p * ZS + c, mask=qm, other=0.0)
                    lq = tl.load(lq_ptr + p * ZS + c, mask=qm, other=0.0)
                    pmean = (tl.load(d_ptr + p * CD + c, mask=qm,
                                     other=0.0).to(tl.float32)
                             + tl.load(db_ptr + c))
                    plogsd = (tl.load(d_ptr + p * CD + ZS + c, mask=qm,
                                      other=0.0).to(tl.float32)
                              + tl.load(db_ptr + ZS + c))
                    kl = lq - _logps(z, pmean, 2.0 * plogsd, log2pi)
                    acc += tl.where(qm, kl, 0.0)
                    jp = (row * PIX + (q // W + PAD) * (W + 2 * PAD)
                          + q % W + PAD)
                    tl.store(j_ptr + jp * CJ + c, _elu(z).to(tl.bfloat16),
                             mask=qm)
                sums = tl.sum(acc, axis=0)
                tl.store(s_ptr + row * ZS + j * G + tl.arange(0, G), sums)
                total += sums
            tl.store(t_ptr + row, tl.sum(total, axis=0))
        else:
            q = ((part - 1) * BP + tl.arange(0, BP))[:, None]
            qm = q < PIX
            p = row * PIX + q
            src, inside = _source(p, H, W, PAD)
            for j in tl.static_range(ZS // G):
                c = j * G + g
                tl.store(j_ptr + p * CJ + c,
                         tl.zeros([BP, G], tl.bfloat16), mask=qm & ~inside)
            for j in tl.static_range(HS // G):
                c = j * G + g
                x = (tl.load(d_ptr + src * CD + 4 * ZS + HS + c,
                             mask=qm & inside).to(tl.float32)
                     + tl.load(db_ptr + 4 * ZS + HS + c))
                a = tl.where(inside, _elu(x), 0.0)
                tl.store(j_ptr + p * CJ + ZS + c, a.to(tl.bfloat16),
                         mask=qm)

    return {"residual_elu": glue_residual_elu_kernel,
            "up_stats": glue_up_stats_kernel,
            "posterior": glue_posterior_kernel,
            "kl_join": glue_kl_join_kernel}


def _group(*widths: int) -> int:
    """The channel slice the passes load at once: the widest power of two,
    at most 32, that divides every width (32 at the paper's z 32, h 160:
    16-byte loads of bf16)."""
    g = 32
    while any(w % g for w in widths):
        g //= 2
    return g


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _check_cuda(name: str, dtypes, *ts) -> None:
    dev = ts[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    for t, dtype in zip(ts, dtypes, strict=True):
        if t.device != dev:
            raise RuntimeError(f"{name}: inputs on different devices")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {dtype} expected, got {t.dtype}")
    _check_size(name, *(t.shape for t in ts))


def _check_size(name: str, *shapes) -> None:
    """Inputs' and outputs' shapes within the kernels' 32-bit offsets."""
    if max(math.prod(s) for s in shapes) >= _MAX_NUMEL:
        raise ValueError(f"{name}: {[tuple(s) for s in shapes]} too large "
                         "for 32-bit offsets")


def _channel_vector(h: torch.Tensor) -> bool:
    """Whether ``h`` is one channel vector broadcast over N, H and W (the
    model's ``h_top.expand``)."""
    return h.dim() == 4 and h.stride()[:3] == (0, 0, 0) and h.stride(3) == 1


def _launch(name, grid, *args, **meta):
    with torch.cuda.device(args[0].device):
        _kernels()[name][grid](*args, num_warps=_WARPS,
                               enable_fp_fusion=False, **meta)


def _padded_shape(shape, pad: int):
    n, h, w, c = shape
    return (n, h + 2 * pad, w + 2 * pad, c)


def _residual_cuda(h, out, b, pad: int, res: bool):
    name = "residual_elu" if res else "elu_bf16"
    bcast = _channel_vector(h)
    if not bcast:
        h = h.contiguous()
    ins = (h, out.contiguous(), b.contiguous()) if res else (h,)
    _check_cuda(name, (torch.float32, torch.bfloat16, torch.float32)[
        :len(ins)], *ins)
    shape, c = tuple(h.shape), h.shape[-1]
    if len(shape) != 4 or pad < 0 or res and (
            tuple(out.shape) != shape or b.shape != (c,)):
        raise ValueError(f"{name}: h {shape}, pad {pad}"
                         + (f", out {tuple(out.shape)}, b {tuple(b.shape)}"
                            if res else ""))
    _check_size(name, _padded_shape(shape, pad))
    a = h.new_empty(_padded_shape(shape, pad), dtype=torch.bfloat16)
    h_out = torch.empty(shape, device=h.device) if res else a
    o, bb = (ins[1], ins[2]) if res else (a, a)
    _launch("residual_elu", (shape[0], a.shape[1]), h, o, bb, h_out, a,
            RESIDUAL_SCALE, C=c, H=shape[1], W=shape[2], PAD=pad, RES=res,
            BCAST=bcast, BLOCK=min(_ROW_BLOCK, _pow2(shape[2] * c)))
    launches[name] += 1
    return (h_out, a) if res else a


def _up_stats_cuda(out, b, hs, pad):
    out, b = out.contiguous(), b.contiguous()
    _check_cuda("up_stats", (torch.bfloat16, torch.float32), out, b)
    ct = out.shape[-1]
    if out.dim() != 4 or not 0 < hs <= ct or b.shape != (ct,) or pad < 0:
        raise ValueError(f"up_stats: {hs} of {ct} channels, b "
                         f"{tuple(b.shape)}, pad {pad}")
    _check_size("up_stats", _padded_shape((*out.shape[:-1], hs), pad))
    a = out.new_empty(_padded_shape((*out.shape[:-1], hs), pad))
    pixels = a.numel() // hs
    _launch("up_stats", (-(-pixels // _BP),), out, b, a, pixels, CT=ct,
            CH=hs, H=out.shape[1], W=out.shape[2], PAD=pad,
            G=_group(ct, hs), BP=_BP)
    launches["up_stats"] += 1
    return a


def _posterior_cuda(down, db, up, ub, eps):
    down, db, up, ub, eps = (t.contiguous() for t in (down, db, up, ub, eps))
    _check_cuda("posterior", (torch.bfloat16, torch.float32) * 2
                + (torch.float32,), down, db, up, ub, eps)
    zs = eps.shape[-1]
    hs = _widths(down, zs)
    pix = eps.shape[:-1]
    if (up.shape != (*pix, 2 * zs + 2 * hs) or down.shape[:-1] != pix
            or db.shape != down.shape[-1:] or ub.shape != up.shape[-1:]):
        raise ValueError(f"posterior: down {tuple(down.shape)}, up "
                         f"{tuple(up.shape)}, eps {tuple(eps.shape)}")
    z, lq = torch.empty_like(eps), torch.empty_like(eps)
    zb = torch.empty_like(eps, dtype=torch.bfloat16)
    ctx = eps.new_empty((*pix, hs))
    pixels = eps.numel() // zs
    _launch("posterior", (-(-pixels // _BP),), down, db, up, ub, eps, z, zb,
            lq, ctx, pixels, _LOG2PI, ZS=zs, HS=hs, G=_group(zs, hs),
            BP=_BP)
    launches["posterior"] += 1
    return z, zb, lq, ctx


def _kl_join_cuda(z, logqs, down, db, pad):
    z, logqs, down, db = (t.contiguous() for t in (z, logqs, down, db))
    _check_cuda("kl_join", (torch.float32, torch.float32, torch.bfloat16,
                            torch.float32), z, logqs, down, db)
    zs = z.shape[-1]
    hs = _widths(down, zs)
    if (z.dim() != 4 or logqs.shape != z.shape or pad < 0
            or down.shape[:-1] != z.shape[:-1]
            or db.shape != down.shape[-1:]):
        raise ValueError(f"kl_join: z {tuple(z.shape)}, logqs "
                         f"{tuple(logqs.shape)}, down {tuple(down.shape)}, "
                         f"pad {pad}")
    rows, h, w = z.shape[:3]
    sums = z.new_empty((rows, zs))
    total = z.new_empty((rows,))
    _check_size("kl_join", _padded_shape((rows, h, w, zs + hs), pad))
    joined = z.new_empty(_padded_shape((rows, h, w, zs + hs), pad),
                         dtype=torch.bfloat16)
    bp = min(_BP, _pow2(h * w))
    blocks = -(-joined[0, ..., 0].numel() // bp)
    _launch("kl_join", (rows, 1 + blocks), z, logqs, down, db, sums, total,
            joined, _LOG2PI, H=h, W=w, PAD=pad, ZS=zs, HS=hs,
            G=_group(zs, hs), BP=bp)
    launches["kl_join"] += 1
    return sums, total, joined


# ---------------------------------------------------------------------------
# the torch ops (registered as K1's are, ``ops/ar_stack.py``)

_LIB = torch.library.Library("iaf", "FRAGMENT")
_LIB.define("elu_bf16(Tensor h, int pad) -> Tensor")
_LIB.define("residual_elu(Tensor h, Tensor out, Tensor b, int pad) "
            "-> (Tensor, Tensor)")
_LIB.define("up_stats(Tensor out, Tensor b, int hs, int pad) -> Tensor")
_LIB.define("posterior(Tensor down, Tensor db, Tensor up, Tensor ub, "
            "Tensor eps) -> (Tensor, Tensor, Tensor, Tensor)")
_LIB.define("kl_join(Tensor z, Tensor logqs, Tensor down, Tensor db, "
            "int pad) -> (Tensor, Tensor, Tensor)")
for _name, _ref, _cuda in (
        ("elu_bf16", elu_bf16_ref,
         lambda h, pad: _residual_cuda(h, None, None, pad, res=False)),
        ("residual_elu", residual_elu_ref,
         lambda h, out, b, pad: _residual_cuda(h, out, b, pad, res=True)),
        ("up_stats", up_stats_ref, _up_stats_cuda),
        ("posterior", posterior_ref, _posterior_cuda),
        ("kl_join", kl_join_ref, _kl_join_cuda)):
    _LIB.impl(_name, _ref, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")


def _bf16(t, shape):
    return t.new_empty(shape, dtype=torch.bfloat16)


@torch.library.register_fake("iaf::elu_bf16", lib=_LIB)
def _elu_bf16_fake(h, pad):
    return _bf16(h, _padded_shape(h.shape, pad))


@torch.library.register_fake("iaf::residual_elu", lib=_LIB)
def _residual_elu_fake(h, out, b, pad):
    return h.new_empty(out.shape), _bf16(h, _padded_shape(out.shape, pad))


@torch.library.register_fake("iaf::up_stats", lib=_LIB)
def _up_stats_fake(out, b, hs, pad):
    return _bf16(out, _padded_shape((*out.shape[:-1], hs), pad))


@torch.library.register_fake("iaf::posterior", lib=_LIB)
def _posterior_fake(down, db, up, ub, eps):
    hs = _widths(down, eps.shape[-1])
    return (eps.new_empty(eps.shape), _bf16(eps, eps.shape),
            eps.new_empty(eps.shape), eps.new_empty((*eps.shape[:-1], hs)))


@torch.library.register_fake("iaf::kl_join", lib=_LIB)
def _kl_join_fake(z, logqs, down, db, pad):
    zs = z.shape[-1]
    hs = _widths(down, zs)
    return (z.new_empty((z.shape[0], zs)), z.new_empty((z.shape[0],)),
            _bf16(z, _padded_shape((*z.shape[:-1], zs + hs), pad)))


elu_bf16_op = torch.ops.iaf.elu_bf16.default
residual_elu_op = torch.ops.iaf.residual_elu.default
up_stats_op = torch.ops.iaf.up_stats.default
posterior_op = torch.ops.iaf.posterior.default
kl_join_op = torch.ops.iaf.kl_join.default


def _inference_only(name: str, *ts) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name}: an inference pass, with no backward; "
                           "autograd is recording")


def elu_bf16(h, pad: int = 0):
    """bf16 ELU(h) of f32 ``h`` [N, H, W, C] (contiguous, or a channel
    vector expanded over N, H and W), with a zero border of ``pad``
    pixels: [N, H + 2 pad, W + 2 pad, C]."""
    _inference_only("elu_bf16", h)
    return elu_bf16_op(h, pad)


def residual_elu(h, out, b, pad: int = 0):
    """(h + 0.1 * (out + b), bf16 ELU of it with a zero border of ``pad``
    pixels): ``out`` a conv's raw bf16 output, NHWC, ``b`` its f32 bias,
    ``h`` f32 (or ``h_top`` expanded)."""
    _inference_only("residual_elu", h, out, b)
    return residual_elu_op(h, out, b, pad)


def up_stats(out, b, hs: int, pad: int = 0):
    """bf16 ELU(out + b) of the last ``hs`` channels of ``up_conv1``'s raw
    bf16 output ``out`` (NHWC) and its bias ``b``, with a zero border of
    ``pad`` pixels."""
    _inference_only("up_stats", out, b)
    return up_stats_op(out, b, hs, pad)


def posterior(down, db, up, ub, eps):
    """(z f32, z bf16, log q(z) f32, context f32) of one down pass from
    ``down_conv1``'s and ``up_conv1``'s raw bf16 outputs (NHWC; channels
    [pz_mean, pz_logsd, rz_mean, rz_logsd, down_context, h_det] and
    [qz_mean, qz_logsd, up_context, hidden]), their f32 biases and the
    standard-normal ``eps`` [N, H, W, z]."""
    _inference_only("posterior", down, db, up, ub, eps)
    return posterior_op(down, db, up, ub, eps)


def kl_join(z, logqs, down, db, pad: int = 0):
    """(KL sums [N, z] over H and W, their total [N], bf16 ELU(cat[z,
    h_det + b]) with a zero border of ``pad`` pixels): the KL of the
    flowed ``z`` and ``logqs`` against the prior in ``down_conv1``'s raw
    output ``down`` with bias ``db``, and ``down_conv2``'s input."""
    _inference_only("kl_join", z, logqs, down, db)
    return kl_join_op(z, logqs, down, db, pad)
