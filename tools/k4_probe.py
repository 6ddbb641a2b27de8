#!/usr/bin/env python3
"""Where K4's forward time goes on one NVIDIA card (iaf_torch, CUDA).

    python3 tools/k4_probe.py

Builds two probes from ``iaf_torch/ops/csrc/disc_logistic.cu`` beside the
kernel itself, and times all three by device time (torch.profiler, as
``chip_smoke.device_ms``) at the eval shape (N = 1024) and at batch 32,
rows of a 32x32x3 image, each at the split ``dl_plan`` takes:

- ``loads``: each element's term is mean + sample, so the kernel moves the
  same bytes with next to no arithmetic;
- ``arith``: every row's loads point at row 0, so every load after the
  first row's hits L2 and the arithmetic is what is left;
- ``kernel``: the source as it is.

It also counts the SASS instructions of the forward kernel's float4
instantiation for a power-of-two bin size (``cuobjdump -sass``), by opcode.
Prints one JSON line last. Needs a card, nvcc and cuobjdump.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBES = {
    "loads": ("  float x, hi, lo;\n  dl_terms<POW2, MARK>(mean, smp, c, x, hi,"
              " lo);\n  return logf(",
              "  return __fadd_rn(mean, smp);\n"),
    "arith": ("  const size_t base = sl.row * row_len + sl.c0;\n"
              "  const int n = (sl.c1 - sl.c0) / LANES;\n"
              "  const DlConsts c = dl_consts(logscale, binsize, inv_bin);\n"
              "  const float acc =",
              "  const size_t base = sl.c0;\n"),
}


def _probe_source(src: str, probe: str) -> str:
    """The kernel source with the probe's line put in before the anchor
    (the first occurrence: the forward kernel's)."""
    anchor, line = PROBES[probe]
    if anchor not in src:
        raise SystemExit(f"k4_probe: the {probe} anchor is not in the source")
    if probe == "arith":
        return src.replace(anchor, anchor.replace(
            "  const size_t base = sl.row * row_len + sl.c0;\n", line), 1)
    return src.replace(anchor, line + anchor, 1)


def _sass_counts(lib: str) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    name = "_Z13dl_fwd_kernelILb1ELb1E"
    start = sass.find("Function : " + name)
    end = sass.find("Function : ", start + 10)
    body = sass[start:end if end > 0 else None]
    ops = [m.split(".")[0] for m in re.findall(
        r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)]
    return {"instructions": len(ops),
            "by_opcode": dict(collections.Counter(ops).most_common(24))}


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("k4_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from iaf_torch import ops
    from iaf_torch.ops import _build, fused
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    src = open(os.path.join(_build.CSRC, "disc_logistic.cu")).read()
    out_dir = os.path.join(ROOT, "build", "k4_probe")
    os.makedirs(out_dir, exist_ok=True)
    libs = {"kernel": fused._dl_lib()}
    for probe in PROBES:
        cu = os.path.join(out_dir, f"{probe}.cu")
        with open(cu, "w") as f:
            f.write(_probe_source(src, probe))
        so = os.path.join(out_dir, f"lib{probe}.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        f"-I{_build.CSRC}", "-o", so, cu], check=True,
                       stdout=subprocess.DEVNULL)
        lib = ctypes.CDLL(so)
        lib.dl_fwd.argtypes = libs["kernel"].dl_fwd.argtypes
        libs[probe] = lib
    result = {"sass": _sass_counts(str(_build._lib_path("disc_logistic")))}
    print(f"[k4_probe] SASS of dl_fwd_kernel<true, true>: "
          f"{result['sass']['instructions']} instructions, "
          f"{result['sass']['by_opcode']}")
    stream = torch.cuda.current_stream().cuda_stream
    for n in (1024, 32):
        mean, ls, sample, _ = cs._k4_inputs(n, 3)
        splits = ops.dl_plan(n, mean[0].numel())
        out = torch.empty(n, device="cuda")
        times = {}
        for name, lib in libs.items():
            def call(lib=lib):
                err = lib.dl_fwd(mean.data_ptr(), sample.data_ptr(),
                                 ls.data_ptr(), out.data_ptr(), n,
                                 mean[0].numel(), splits, 1.0 / 256.0, 1,
                                 stream)
                if err:
                    raise RuntimeError(f"k4_probe: CUDA error {err}")
            times[name] = cs.device_ms(call)
        print(f"[k4_probe] N={n}, S={splits}: device ms " + ", ".join(
            f"{k} {v:.4f}" for k, v in times.items()))
        result[f"n{n}"] = {"splits": splits, "device_ms": times}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
