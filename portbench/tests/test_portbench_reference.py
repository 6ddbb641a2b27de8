"""The plain reference against the port's CPU path (its kernels' twins),
at a tiny size in f32: the training forward and its gradients, three
Adamax + Polyak steps, and the IW eval."""

import pytest
import torch

from portbench import inputs, judge, program
from portbench import reference as ref
from portbench.tests import tiny


@pytest.fixture(params=[3, 5], ids=["iaf-paper", "kernel_size-5"])
def c(request):
    """The paper's 3x3 AR nets (K1's path) and 5x5 ones, which the port
    runs conv by conv (K2's path)."""
    return tiny.config(kernel_size=request.param, compute_dtype="float32")


def _grads(P, loss):
    g = torch.autograd.grad(loss, list(P.values()), allow_unused=True)
    return {k: torch.zeros_like(P[k]) if x is None else x
            for k, x in zip(P, g)}


def test_forward_and_gradients(c):
    from iaf_torch.models import cvae
    cfg = program.config(c, tiny.traffic("train-b32"))
    P = inputs.weights(c, 3, "cpu")
    model = program.model(cfg, P, "cpu")
    imgs = inputs.images(3, 4, 8, 3)
    eps = [v.clone() for v in
           inputs.NoiseStream(c, 3, "train", 4, "cpu").draw(0)]
    out = cvae.cvae_forward(cfg, model, imgs, 0, mode="train",
                            noise=dict(zip(program.sites(cfg, 4), eps)))
    Pg = {k: v.clone().requires_grad_() for k, v in P.items()}
    f = ref.forward(c, Pg, ref.masks(c, "cpu"), torch.from_numpy(imgs), eps)
    assert float(f["loss"].detach()) == pytest.approx(float(out.loss.detach()),
                                                  rel=1e-6)
    torch.testing.assert_close(f["kl_per_layer"], out.kl_per_layer.detach(),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f["log_w"], out.log_w.detach(), rtol=1e-6,
                               atol=1e-3)
    out.loss.backward()
    want = _grads(Pg, f["loss"])
    for n, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        scale = float(want[n].abs().max()) + 1e-12
        assert float((got - want[n]).abs().max()) <= 1e-3 * scale, n


def test_three_steps_match_the_program(c):
    t = tiny.traffic("train-b32")
    r = tiny.run(c, t, seed=4)
    from portbench import cells
    s = cells.TrainSetup(r, builds=False)
    got = s.readings
    s.prog.close()
    want = cells.train_reference(c, 4, s.batches, 3, torch.device("cpu"))
    n = judge.train_numbers(got, want)
    assert n["loss"] < 1e-6 and n["parts"] < 1e-4
    # the Polyak average's change is 1e-3 of the parameters': f32 rounds
    # it to about 1e-3 of itself on either side
    assert n["grad"] < 1e-4 and n["change"] < 1e-3 and n["ema"] < 1e-2


def test_iw_eval_matches_the_program(c):
    from portbench import cells
    t = tiny.traffic("iw-eval-k4096")
    s = cells.EvalSetup(tiny.run(c, t, seed=5), builds=False)
    got = s.batch(1)
    picks = [(1, 0), (1, 1)]
    want = cells.eval_reference(c, 5, picks, [s.batch_images(1)[i]
                                              for _, i in picks],
                                2, 16, 4, 8, torch.device("cpu"))
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-2)


def test_masks_are_causal():
    m = ref.conv_ar_mask(5, 5, 4, 8, True)
    assert m.shape == (8, 4, 5, 5)
    assert not m[:, :, 3:].any() and not m[:, :, 2, 3:].any()
    assert ref.live_taps(3, 3) == 5 and ref.live_taps(5, 5) == 13
    # zero diagonal: output group i never sees input i at the centre
    assert not m[0, 0, 2, 2] and m[2, 0, 2, 2]


def test_fp8_rounds_and_passes_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    q = ref.fp8_quant(x)
    assert 0 < float((q - x).detach().abs().max()) < 0.13
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
