#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``iaf_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. Device and build: the card's name and power limit, then the CUDA kernel
   (K1, nvcc for sm_90a) and the Triton kernels (K3, K4) are built from the
   sources beside this script, with their build seconds.
2. The main path's config: the CIFAR paper config (``--hpconfig
   depth=1,num_blocks=20,kl_min=0.25,learning_rate=0.002,batch_size=32``:
   z=32, h=160, 20 IAF layers, depth_ar=2, bf16 convs) with random weights
   from a data-dependent init on 32 synthetic images.
3. Kernel vs plain twin on the card: K1's, K3's and K4's inputs are
   captured from the first launches of one real eval chunk (16 images x 64
   samples); each kernel is held to its twin on them (K1 in bf16 and in f32
   with TF32 off) and timed beside its twin, K1 also beside three cuDNN
   convs (its yardstick), and each bound is computed from the shapes.
   One chunk is then profiled (device time by kernel name).
4. Port vs plain on a small input: one f32 eval forward on the card
   (kernels) against the same forward on the CPU (twins), same noise.
5. Main path: ``iaf_torch.train_lib.evaluate`` over 2 test batches of 16
   at k=256 (4 chunks of 64); the launch counters are zeroed just before
   and read just after, and must be K1 = K3 = 160, K4 = 8. One more batch
   through the eval step alone gives the steady seconds per batch.

The second-last line of standard output is the ``kernels`` JSON, the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PAPER = "depth=1,num_blocks=20,kl_min=0.25,learning_rate=0.002,batch_size=32"
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
EVAL_BATCH, EVAL_K, EVAL_CHUNK, EVAL_BATCHES = 16, 256, 64, 2


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, dtype: str, nbytes: float):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def capture_inputs(ops, fn):
    """Run ``fn`` with spies on the three wrappers; return each wrapper's
    first call's arguments (cloned)."""
    import torch
    names = ("ar_stack", "iaf_update", "disc_logistic_logp")
    originals = {n: getattr(ops, n) for n in names}
    seen: dict[str, tuple] = {}

    def clone(a):
        if torch.is_tensor(a):
            return a.clone()
        if isinstance(a, (list, tuple)):
            return type(a)(clone(x) for x in a)
        return a

    def spy(name):
        def wrapped(*args):
            if name not in seen:
                seen[name] = clone(args)
            return originals[name](*args)
        return wrapped

    for n in names:
        setattr(ops, n, spy(n))
    try:
        fn()
    finally:
        for n in names:
            setattr(ops, n, originals[n])
    check(set(seen) == set(names), f"captured only {sorted(seen)}")
    return seen


def k1_yardstick(z, ctx, ws, bs):
    """Three full 3x3 masked cuDNN convs + bias + context + ELU on the same
    folded weights, channels-last (never called by the port)."""
    import torch.nn.functional as F
    h = z.permute(0, 3, 1, 2)
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = F.conv2d(h.to(w.dtype), w.permute(3, 2, 0, 1), padding=1).float()
        h = h + b[:, None, None]
        if i == 0:
            h = h + ctx.permute(0, 3, 1, 2)
        if i < len(ws) - 1:
            h = F.elu(h)
    return h


def kernel_phase(ops, cap, device) -> list[dict]:
    import torch
    rows = []

    # K1: the AR chain of the first IAF step of the chunk (bf16 inputs)
    z, ctx, ws, bs, masks = cap["ar_stack"]
    with torch.inference_mode():
        got = ops.ar_stack(z, ctx, ws, bs, masks)
        ref = ops.ar_stack_ref(z, ctx, ws, bs)
        err_bf16 = float((got - ref).abs().max())
        rel_bf16 = err_bf16 / float(ref.abs().max())
        z32, ws32 = z.float(), [w.float() for w in ws]
        got32 = ops.ar_stack(z32, ctx, ws32, bs, masks)
        ref32 = ops.ar_stack_ref(z32, ctx, ws32, bs)
        err_f32 = float((got32 - ref32).abs().max())
        scale32 = max(1.0, float(ref32.abs().max()))
        print(f"[K1] ar_stack z{tuple(z.shape)} ctx{tuple(ctx.shape)} -> "
              f"{tuple(got.shape)}: bf16 max abs err {err_bf16:.3e} "
              f"(rel {rel_bf16:.3e}); f32 max abs err {err_f32:.3e}")
        check(rel_bf16 <= 2e-2, f"K1 bf16 rel err {rel_bf16} > 2e-2")
        check(err_f32 <= 1e-4 * scale32, f"K1 f32 err {err_f32} > 1e-4")
        ms = cuda_ms(lambda: ops.ar_stack(z, ctx, ws, bs, masks))
        plain = cuda_ms(lambda: ops.ar_stack_ref(z, ctx, ws, bs))
        lib = cuda_ms(lambda: k1_yardstick(z, ctx, ws, bs))
        ms32 = cuda_ms(lambda: ops.ar_stack(z32, ctx, ws32, bs, masks))
    n, hh, ww, _ = z.shape
    flops = 2 * n * hh * ww * 5 * sum(w.shape[2] * w.shape[3] for w in ws)
    moved = nbytes(z, ctx, got, *bs) + sum(5 * w[0, 0].numel() *
                                           w.element_size() for w in ws)
    b_ms, b_by = bound_ms(flops, "bfloat16", moved)
    rows.append(dict(
        name="ar_stack", route="cuda", source="iaf_torch/ops/csrc/ar_stack.cu",
        replaces="iaf_tpu/ops/ar_stack.py:115", max_abs_err=err_bf16,
        max_abs_err_f32=err_f32, ms=ms, ms_f32=ms32, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        gflop=flops / 1e9, mbytes=moved / 1e6))

    # K3: the division update of the same IAF step
    a = cap["iaf_update"]
    with torch.inference_mode():
        got = ops.iaf_update(*a)
        ref = ops.iaf_update_ref(*a)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        ok = all(bool(((g - r).abs() <= 1e-6 * (1 + r.abs())).all())
                 for g, r in zip(got, ref))
        print(f"[K3] iaf_update {tuple(a[0].shape)}: max abs err {err:.3e}")
        check(ok, f"K3 err {err} beyond 1e-6 * (1 + |ref|)")
        ms = cuda_ms(lambda: ops.iaf_update(*a))
        plain = cuda_ms(lambda: ops.iaf_update_ref(*a))
    b_ms, b_by = bound_ms(4 * a[0].numel(), "float32", nbytes(*a, *got))
    rows.append(dict(
        name="iaf_update", route="triton", source="iaf_torch/ops/fused.py",
        replaces="iaf_tpu/ops/fused.py:43", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        mbytes=nbytes(*a, *got) / 1e6))

    # K4: the chunk's likelihood
    mean, logscale, sample = cap["disc_logistic_logp"]
    with torch.inference_mode():
        got = ops.disc_logistic_logp(mean, logscale, sample)
        ref = ops.disc_logistic_ref(mean, logscale, sample)
        err = float((got - ref).abs().max())
        rel = float(((got - ref).abs() / ref.abs()).max())
        print(f"[K4] disc_logistic_logp {tuple(mean.shape)}: max abs err "
              f"{err:.3e} (rel {rel:.3e})")
        check(rel <= 1e-5, f"K4 rel err {rel} > 1e-5")
        ms = cuda_ms(lambda: ops.disc_logistic_logp(mean, logscale, sample))
        plain = cuda_ms(lambda: ops.disc_logistic_ref(mean, logscale, sample))
    moved = nbytes(mean, sample, got, logscale)
    b_ms, b_by = bound_ms(15 * mean.numel(), "float32", moved)
    rows.append(dict(
        name="disc_logistic_logp", route="triton",
        source="iaf_torch/ops/fused.py", replaces="iaf_tpu/ops/fused.py:103",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, mbytes=moved / 1e6))
    for r in rows:
        print(f"[time] {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def profile_phase(one_chunk) -> None:
    """Where one eval chunk's device time goes: torch.profiler's self
    device time per kernel name, top 12, and the device-busy share of the
    chunk's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    one_chunk()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_chunk()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_events = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = [(e.key, getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)), e.count)
           for e in kernel_events]
    dev = [d for d in dev if d[1] > 0]
    busy = sum(t for _, t, _ in dev) / 1e6
    print(f"[profile] one chunk (16 images x {EVAL_CHUNK} samples): wall "
          f"{wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
          f"({100 * busy / wall:.1f} %)")
    for key, t, count in sorted(dev, key=lambda d: -d[1])[:12]:
        print(f"[profile] {t / 1e3:9.2f} ms {100 * t / 1e6 / busy:5.1f} % "
              f"x{count:<5d} {key[:90]}")


def reference_phase(device) -> None:
    """One f32 eval forward of the paper config on the card (kernels)
    against the same forward on the CPU (plain twins), same noise."""
    import torch
    from iaf_torch.core.config import Config
    from iaf_torch.data.datasets import synthetic_dataset
    from iaf_torch.models import cvae
    cfg = Config().parse(PAPER + ",compute_dtype=float32")
    x = synthetic_dataset(32, 3, n_train=8, n_test=2, seed=5).test_x
    gpu = cvae.init_params(cfg, x, rng=17, device=device)
    cpu = cvae.CVAE(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    k = 4
    g = torch.Generator().manual_seed(3)
    noise = {f"{n}/z_post": torch.randn((2 * k, 16, 16, 32), generator=g)
             for n in cvae.layer_names(cfg)}
    with torch.inference_mode():
        a = cvae.apply_fn(cfg, gpu, 0, x, mode="eval", k=k,
                          noise={n: t.to(device) for n, t in noise.items()})
        b = cvae.apply_fn(cfg, cpu, 0, x, mode="eval", k=k, noise=noise)
    lw_a, lw_b = a.log_w.cpu(), b.log_w
    rel = float(((lw_a - lw_b).abs() / lw_b.abs()).max())
    print(f"[reference] f32 eval forward, card vs CPU twins: log_w "
          f"{lw_b.tolist()}, max rel err {rel:.3e}")
    check(bool(torch.isfinite(lw_a).all()), "non-finite log_w on the card")
    check(rel <= 1e-5, f"card vs CPU log_w rel err {rel} > 1e-5")


def run() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    try:
        import iaf_torch
    except ImportError as e:
        raise SmokeFailure(f"iaf_torch is not beside this script: {e}")
    if os.path.dirname(os.path.dirname(os.path.abspath(iaf_torch.__file__))) \
            != HERE:
        raise SmokeFailure(f"iaf_torch imported from {iaf_torch.__file__}, "
                           f"not from {HERE}")
    from iaf_torch import ops, train_lib
    from iaf_torch.core.config import Config
    from iaf_torch.data.datasets import synthetic_dataset
    from iaf_torch.models import cvae
    from iaf_torch.ops import _build
    from iaf_torch.parallel.eval_step import make_eval_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # phase 1: build
    t0 = time.perf_counter()
    _build.load("ar_stack")
    print(f"[build] nvcc ar_stack.cu {_build.build_seconds.get('ar_stack', 0):.1f} s")
    for line in _build.build_log.get("ar_stack", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    with torch.inference_mode():
        t1 = time.perf_counter()
        a = torch.randn(4, 8, device=device)
        ops.iaf_update(a, a, a, a)
        ops.disc_logistic_logp(a, torch.zeros((), device=device), a)
        torch.cuda.synchronize()
    print(f"[build] triton K3+K4 first launch {time.perf_counter() - t1:.1f} s;"
          f" all builds {time.perf_counter() - t0:.1f} s")

    # phase 2: the paper config, data-dependent init (plain convs)
    cfg = Config().parse(PAPER + f",dataset=synthetic,eval_batch_size="
                         f"{EVAL_BATCH},eval_k_chunk={EVAL_CHUNK}")
    ds = synthetic_dataset(cfg.image_size, cfg.channels)
    t0 = time.perf_counter()
    model = cvae.init_params(cfg, ds.train_x[:32], rng=cfg.seed,
                             device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[init] paper config: {len(model.blocks)} IAF layers, h="
          f"{cfg.h_size}, z={cfg.z_size}, {n_params} params, "
          f"compute_dtype={cfg.compute_dtype}, "
          f"{time.perf_counter() - t0:.1f} s")

    # phase 3: kernels against their twins on one real chunk's inputs
    def one_chunk():
        with torch.inference_mode():
            cvae.apply_fn(cfg, model, 1, ds.test_x[:EVAL_BATCH], mode="eval",
                          k=EVAL_CHUNK)
    rows = kernel_phase(ops, capture_inputs(ops, one_chunk), device)
    profile_phase(one_chunk)

    # phase 4: the port against the plain twins on a small input
    reference_phase(device)

    # phase 5: the main path, counted
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    bpd = train_lib.evaluate(cfg, "eval_test", params=model, k=EVAL_K,
                             max_batches=EVAL_BATCHES, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_chunks = EVAL_K // EVAL_CHUNK * EVAL_BATCHES
    want = {"ar_stack": len(model.blocks) * n_chunks,
            "iaf_update": len(model.blocks) * n_chunks,
            "disc_logistic_logp": n_chunks}
    print(f"[main] evaluate k={EVAL_K}: bits/dim {bpd!r}, "
          f"{secs:.4f} s with the data set-up, launches {counts}")
    check(math.isfinite(bpd), f"bits/dim {bpd} is not finite")
    check(counts == want, f"launch counts {counts} != {want}")
    # steady state: the eval step alone on one batch, timed after the
    # counted run (set-up excluded)
    step = make_eval_step(cfg, device, k=EVAL_K)
    batch = ds.test_x[:EVAL_BATCH]
    step(model, 7, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(model, 7, batch)
    torch.cuda.synchronize()
    per_batch = time.perf_counter() - t0
    print(f"[main] steady eval step: {per_batch:.4f} s/batch, "
          f"{EVAL_BATCH * EVAL_K / per_batch:.1f} importance samples/s")
    for r in rows:
        r["launches"] = counts[r["name"]]
    print(json.dumps({"main": {
        "bits_per_dim": bpd, "evaluate_seconds": secs,
        "seconds_per_batch": per_batch,
        "importance_samples_per_s": EVAL_BATCH * EVAL_K / per_batch,
        "k": EVAL_K, "eval_batch_size": EVAL_BATCH,
        "batches": EVAL_BATCHES}}))
    print(json.dumps({"kernels": rows}))
    return {"ok": True, "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    try:
        result = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
