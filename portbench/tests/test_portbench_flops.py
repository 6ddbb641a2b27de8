"""The yardstick's counts: the model's FLOP against PyTorch's own count
of the reference's convs, and the kernels' counts against each other."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import inputs
from portbench import reference as ref
from portbench import yardstick as y
from portbench.tests import tiny


@pytest.mark.parametrize("ks", [3, 5])
def test_model_flops_match_a_count_of_the_reference(ks):
    c = tiny.config(kernel_size=ks, compute_dtype="float32", image_size=16)
    P = {k: v.requires_grad_() for k, v in inputs.weights(c, 2, "cpu").items()}
    x = torch.from_numpy(inputs.images(2, 3, 16, 3))
    eps = [torch.randn(3, 8, 8, c["z_size"]) for _ in range(2)]
    with FlopCounterMode(display=False) as fwd:
        f = ref.forward(c, P, ref.masks(c, "cpu"), x, eps)
    # a dense conv computes every tap, where the yardstick counts live
    # taps; the reference's deconv convolves the input dilated by 2, four
    # times the products of the transposed conv the yardstick counts
    dec = dict(y.conv_flops(c, 3))["x_dec"]
    assert fwd.get_total_flops() == y.model_flops(c, 3, False,
                                                  live=False) + 3 * dec
    with FlopCounterMode(display=False) as both:
        f = ref.forward(c, P, ref.masks(c, "cpu"), x, eps)
        torch.autograd.grad(f["loss"], list(P.values()), allow_unused=True)
    assert both.get_total_flops() == y.model_flops(c, 3, True,
                                                   live=False) + 9 * dec


def test_live_taps_count_the_masked_convs():
    c = tiny.config()
    dense = y.model_flops(c, 2, False, live=False)
    live = y.model_flops(c, 2, False)
    hw = c["image_size"] // 2
    ar = sum(ci * co for ci, co in ref.ar_widths(c)) * ref.n_layers(c)
    assert dense - live == 2 * 2 * hw * hw * (9 - 5) * ar


@pytest.mark.parametrize("ks", [3, 5])
def test_kernel_counts(ks):
    import json
    from portbench import spec
    c = dict(json.loads((spec.HERE / "configs" / "iaf-paper.json")
                        .read_text())["config"], kernel_size=ks)
    f1, _ = y.k1_fwd(c, 32, True)
    f2, _ = y.k2_fwd(c, 32)
    assert f1 == f2                       # the same convs, two kernels
    assert y.k1_bwd(c, 32)[0] == 2 * f1 == y.k2_bwd(c, 32)[0]
    # the paper step: 1.88 TFLOP; the AR convs' share of the forward
    step = y.model_flops(c, 32, True)
    assert 1.5e12 < step < 6e12
    assert y.bound_ms(989e9, "bfloat16", 0)[0] == pytest.approx(1.0)
    assert y.bound_ms(0, "bfloat16", 3.35e9)[1] == "bytes"
    f32 = y.f32_bounds(495e9, 0)
    assert f32["bound_ms"] == pytest.approx(1.0)
    assert f32["design_bound_ms"] == pytest.approx(3.0)
    assert f32["fp32_floor_ms"] == pytest.approx(495 / 67)
