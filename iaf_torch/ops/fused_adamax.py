"""K5: the fused Adamax + Polyak update as one Triton launch over every
parameter leaf, with its plain PyTorch twin.

Replaces ``iaf_tpu/ops/fused_adamax.py:_kernel`` (one ``pallas_call`` per
leaf). Per element, in one pass and in place:

    g  <- g * scale                      (only with grad clipping)
    m' = b1 * m + (1 - b1) * g
    u' = max(b2 * u, |g|)
    p' = p - (lr_t * m') / (u' + eps)
    e' = d * e + (1 - d) * p'

At the paper config it reads p, g, m, u, e and writes p, m, u, e for
~41.5 M f32 elements: ~1.49 GB, ~0.45 ms at 3.35 TB/s against ~10
operations per element, so it is bound by bytes. The design moves each
byte once and launches once per step for all leaves (428 at the paper
config): the kernel reads a table of leaf pointers (params, m, u, ema,
size) and a table of gradient pointers, each copied to the card once per
set of pointers (the training step keeps its gradients in fixed buffers,
so a captured CUDA graph of the step reads the tables it was captured
with), and a block map (leaf, offset) per program,
so no leaf is copied into a flat buffer and nothing but the
update touches device memory. The params are updated where they lie, so
the model sees the new values with no copy back.

It must be bit-exact against the twin on the card, so the kernel keeps
the twin's order of operations and constants (f32 b1, 1 - b1, b2, eps, d
and 1 - d as the twin's Python scalars round), divides with ``div_rn``
(Triton's default f32 division is approximate) and is compiled with
``enable_fp_fusion=False`` (Triton would contract a * b + c into one FMA,
which rounds once where the twin rounds twice). ``lr_t`` and the clip
scale come from one-element device tensors, so the host never waits on
the card for them.

Triton is imported inside the launching function, as in ``fused.py``.
"""

from __future__ import annotations

import functools
import os
from typing import Sequence

import numpy as np
import torch

from iaf_torch.ops import _build

launches = {"adamax_polyak": 0}

# Elements per program and its warps: 8 per thread. 16 per thread (4096
# over 8 warps) takes 247 registers a thread against 80, and an A/B on the
# card did not show it faster (PERF.md, section 6).
_BLOCK = 1024
_WARPS = 4


def adamax_polyak_ref(p, g, m, u, e, lr_t, *, beta1: float, beta2: float,
                      eps: float, polyak_decay: float, scale=None):
    """The twin: returns (p', m', u', ema') for one leaf."""
    if scale is not None:
        g = g * scale
    m_t = beta1 * m + (1.0 - beta1) * g
    u_t = torch.maximum(beta2 * u, torch.abs(g))
    p_t = p - lr_t * m_t / (u_t + eps)
    e_t = polyak_decay * e + (1.0 - polyak_decay) * p_t
    return p_t, m_t, u_t, e_t


@functools.cache
def _kernel():
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl
    try:
        from triton.language.extra import libdevice
    except ImportError:  # older layout of the Triton package
        from triton.language.extra.cuda import libdevice

    @triton.jit
    def adamax_kernel(tab_ptr, gtab_ptr, blk_leaf_ptr, blk_off_ptr, lr_ptr,
                      scale_ptr, b1, c1, b2, eps, d, cd,
                      HAS_SCALE: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        leaf = tl.load(blk_leaf_ptr + pid).to(tl.int64)
        start = tl.load(blk_off_ptr + pid)
        row = tab_ptr + leaf * 5
        p_ptr = tl.load(row).to(tl.pointer_type(tl.float32))
        m_ptr = tl.load(row + 1).to(tl.pointer_type(tl.float32))
        u_ptr = tl.load(row + 2).to(tl.pointer_type(tl.float32))
        e_ptr = tl.load(row + 3).to(tl.pointer_type(tl.float32))
        n = tl.load(row + 4)
        g_ptr = tl.load(gtab_ptr + leaf).to(tl.pointer_type(tl.float32))
        offs = start + tl.arange(0, BLOCK).to(tl.int64)
        msk = offs < n
        lr = tl.load(lr_ptr)
        g = tl.load(g_ptr + offs, mask=msk, other=0.0)
        if HAS_SCALE:
            g = g * tl.load(scale_ptr)
        m = tl.load(m_ptr + offs, mask=msk, other=0.0)
        u = tl.load(u_ptr + offs, mask=msk, other=0.0)
        p = tl.load(p_ptr + offs, mask=msk, other=0.0)
        e = tl.load(e_ptr + offs, mask=msk, other=0.0)
        m_t = b1 * m + c1 * g
        u_t = tl.maximum(b2 * u, tl.abs(g))
        p_t = p - libdevice.div_rn(lr * m_t, u_t + eps)
        e_t = d * e + cd * p_t
        tl.store(m_ptr + offs, m_t, mask=msk)
        tl.store(u_ptr + offs, u_t, mask=msk)
        tl.store(p_ptr + offs, p_t, mask=msk)
        tl.store(e_ptr + offs, e_t, mask=msk)

    return adamax_kernel


@functools.lru_cache(maxsize=8)
def _block_map(sizes: tuple[int, ...], device: torch.device):
    """Per program: the leaf it updates and the first element, for blocks
    of ``_BLOCK`` elements over every leaf."""
    per = [-(-n // _BLOCK) for n in sizes]
    leaf = np.repeat(np.arange(len(sizes), dtype=np.int32), per)
    off = np.concatenate([np.arange(k, dtype=np.int64) * _BLOCK
                          for k in per])
    return (torch.from_numpy(leaf).to(device),
            torch.from_numpy(off).to(device))


@functools.lru_cache(maxsize=16)
def _table(values: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A pointer table on the card: the (params, m, u, ema, size) rows or
    the gradient pointers. Those tensors live as long as the training
    state and its gradient buffers, so each table is copied once, not once
    per step; a call under CUDA graph capture must find its tables here
    (the copy from the host cannot be captured)."""
    host = torch.tensor(values, dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True)


def adamax_polyak(params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor], m: Sequence[torch.Tensor],
                  u: Sequence[torch.Tensor], ema: Sequence[torch.Tensor],
                  lr_t: torch.Tensor, *, beta1: float, beta2: float,
                  eps: float, polyak_decay: float,
                  scale: torch.Tensor | None = None) -> None:
    """Update every leaf's params, m, u and ema in place: one kernel
    launch for all leaves on CUDA, the twin leaf by leaf on the CPU.
    ``lr_t`` and ``scale`` (the grad-clip factor, or None) are
    one-element f32 tensors on the leaves' device."""
    if not len(params) == len(grads) == len(m) == len(u) == len(ema):
        raise ValueError("adamax_polyak: leaf lists differ in length")
    dev = params[0].device
    hyper = dict(beta1=beta1, beta2=beta2, eps=eps, polyak_decay=polyak_decay)
    if dev.type == "cpu":
        with torch.no_grad():
            for leaf in zip(params, grads, m, u, ema):
                new = adamax_polyak_ref(*leaf, lr_t, scale=scale, **hyper)
                for dst, src in zip((leaf[0], *leaf[2:]), new):
                    dst.copy_(src)
        return
    if dev.type != "cuda":
        raise RuntimeError(f"adamax_polyak: no kernel for device {dev}")
    scalars = [lr_t] if scale is None else [lr_t, scale]
    for group in (params, grads, m, u, ema, scalars):
        for t in group:
            if t.device != dev:
                raise RuntimeError("adamax_polyak: leaves on different "
                                   "devices")
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError("adamax_polyak: leaves must be contiguous "
                                 "float32")
    sizes = tuple(p.numel() for p in params)
    for group in (grads, m, u, ema):
        if tuple(t.numel() for t in group) != sizes:
            raise ValueError("adamax_polyak: leaf sizes differ")
    tab = _table(tuple(
        v for p, m_, u_, e in zip(params, m, u, ema)
        for v in (p.data_ptr(), m_.data_ptr(), u_.data_ptr(), e.data_ptr(),
                  p.numel())), dev)
    gtab = _table(tuple(g.data_ptr() for g in grads), dev)
    blk_leaf, blk_off = _block_map(sizes, dev)
    kernel = _kernel()
    with torch.cuda.device(dev):
        kernel[(blk_leaf.numel(),)](
            tab, gtab, blk_leaf, blk_off, lr_t,
            lr_t if scale is None else scale, beta1, 1.0 - beta1, beta2,
            eps, polyak_decay, 1.0 - polyak_decay,
            HAS_SCALE=scale is not None, BLOCK=_BLOCK, num_warps=_WARPS,
            enable_fp_fusion=False)
    launches["adamax_polyak"] += 1
