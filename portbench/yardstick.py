"""The benchmark's arithmetic: the card's published peaks, a kernel's
least time from its operations and bytes, and the model's operations
from its configuration. Frozen here so that a change to the program
cannot move the yardstick.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s bf16, 495
TFLOP/s TF32, 67 TFLOP/s FP32 on the CUDA cores, 3.35 TB/s of HBM3.
They assume the full power limit of 700 W; each run prints the card's.

A kernel's bound is the larger of its operations over the peak and its
bytes over the bandwidth. Bytes count each input once and each output
once; AR convs count only the live taps of their causal masks (5 of 9
at 3x3, 13 of 25 at 5x5), in operations and in weight bytes.
"""

from __future__ import annotations

from portbench import reference as ref

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
BYTES = {"bfloat16": 2, "float32": 4}


def bound_ms(flops: float, dtype: str, nbytes: float) -> tuple[float, str]:
    """(least ms, "operations" or "bytes")."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def f32_bounds(flops: float, moved: float) -> dict:
    """For f32 operands: the bound at one TF32 product per f32 product
    (495 TFLOP/s), the 3xTF32 design floor (three), the FP32 CUDA-core
    floor (67 TFLOP/s)."""
    b_ms, b_by = bound_ms(flops, "tf32", moved)
    return dict(bound_ms=b_ms, bound_by=b_by,
                design_bound_ms=bound_ms(3 * flops, "tf32", moved)[0],
                fp32_floor_ms=bound_ms(flops, "float32", moved)[0])


def _dtype(c: dict) -> str:
    return "bfloat16" if c["compute_dtype"] == "bfloat16" else "float32"


def peak_dtype(c: dict) -> str:
    return "bfloat16" if c["compute_dtype"] == "bfloat16" else "tf32"


def _px(c: dict, n: int) -> int:
    hw = c["image_size"] // 2
    return n * hw * hw


def _ar_sum(c: dict) -> int:
    """Sum over one AR net's convs of cin * cout."""
    return sum(ci * co for ci, co in ref.ar_widths(c))


def k1_fwd(c: dict, n: int, save_pre: bool) -> tuple[float, float]:
    """K1's forward over n images (one AR net, all its convs): (FLOP,
    bytes). In: z in the compute dtype, the f32 context, the f32 biases,
    the live weight taps in the compute dtype; out: the f32 heads and,
    under autograd, each hidden conv's f32 pre-activation."""
    xb = BYTES[_dtype(c)]
    z, ch = c["z_size"], c["ar_hidden_size"] or c["h_size"]
    widths = ref.ar_widths(c)
    taps = ref.live_taps(c["kernel_size"], c["kernel_size"])
    px = _px(c, n)
    flops = 2 * px * taps * _ar_sum(c)
    per_px = z * xb + ch * 4 + widths[-1][1] * 4
    if save_pre:
        per_px += (len(widths) - 1) * ch * 4
    moved = px * per_px + sum(4 * co + taps * ci * co * xb
                              for ci, co in widths)
    return flops, moved


def k1_bwd(c: dict, n: int) -> tuple[float, float]:
    """K1's backward (dgrad and wgrad of every conv of the chain): in z,
    the f32 output gradient, the f32 pre-activations, the weights; out
    dz, the f32 context gradient, the weight and bias gradients."""
    xb = BYTES[_dtype(c)]
    z, ch = c["z_size"], c["ar_hidden_size"] or c["h_size"]
    widths = ref.ar_widths(c)
    taps = ref.live_taps(c["kernel_size"], c["kernel_size"])
    px = _px(c, n)
    flops = 2 * 2 * px * taps * _ar_sum(c)
    per_px = (2 * z * xb + widths[-1][1] * 4 + (len(widths) - 1) * ch * 4
              + ch * 4)
    moved = px * per_px + sum(4 * co + 2 * taps * ci * co * xb
                              for ci, co in widths)
    return flops, moved


def k2_fwd(c: dict, n: int) -> tuple[float, float]:
    """K2's forward over all convs of one AR net, conv by conv: in x in
    the compute dtype and the live weight taps, out f32."""
    xb = BYTES[_dtype(c)]
    taps = ref.live_taps(c["kernel_size"], c["kernel_size"])
    px = _px(c, n)
    flops = sum(2 * px * taps * ci * co for ci, co in ref.ar_widths(c))
    moved = sum(px * (ci * xb + co * 4) + taps * ci * co * xb
                for ci, co in ref.ar_widths(c))
    return flops, moved


def k2_bwd(c: dict, n: int) -> tuple[float, float]:
    """K2's backward over all convs of one AR net: dgrad and wgrad; in x,
    the f32 output gradient and the weights, out dx and dw."""
    xb = BYTES[_dtype(c)]
    taps = ref.live_taps(c["kernel_size"], c["kernel_size"])
    px = _px(c, n)
    flops = sum(2 * 2 * px * taps * ci * co for ci, co in ref.ar_widths(c))
    moved = sum(px * (2 * ci * xb + co * 4) + 2 * taps * ci * co * xb
                for ci, co in ref.ar_widths(c))
    return flops, moved


def kernel_bound_ms(c: dict, parts: list[tuple[float, float]]) -> float:
    """The sum of each part's bound in the configuration's precision."""
    return sum(bound_ms(f, peak_dtype(c), b)[0] for f, b in parts)


def conv_flops(c: dict, n: int, live: bool = True) -> list[tuple[str, float]]:
    """(name, forward FLOP) of every conv and the deconv over n images
    (rows): 2 per multiply-add. AR convs over their live taps, or over
    every tap with ``live=False`` (what a dense conv would compute)."""
    hw = c["image_size"] // 2
    out = []
    for name, ci, co, k, _, masked in ref.conv_specs(c):
        taps = ref.live_taps(k, k) if masked and live else k * k
        out.append((name, 2.0 * n * hw * hw * taps * ci * co))
    sk = c["stem_kernel_size"]
    out.append(("x_dec", 2.0 * n * hw * hw * sk * sk * c["h_size"]
                * c["channels"]))
    return out


def model_flops(c: dict, n: int, train: bool, live: bool = True) -> float:
    """The model's conv FLOP over n rows: the forward, and for a training
    step also the backward: the weight and input gradients of every conv,
    but the stem's input gradient (its input is the images) and both of
    the top layer's ``up_conv3`` (its output reaches nothing, so autograd
    skips it). No recompute; elementwise work not counted."""
    convs = dict(conv_flops(c, n, live))
    fwd = sum(convs.values())
    if not train:
        return fwd
    top = convs[f"blocks.{ref.n_layers(c) - 1}.up_conv3"]
    return fwd + 2 * fwd - convs["x_enc"] - 2 * top
