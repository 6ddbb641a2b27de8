"""The check that decides ``correct``, driven as a run drives it on the
CPU (the look for a card skipped) at a tiny size, with the cells' own
limits: a sound run is correct, and the timed path broken underneath
makes it not correct, once for each fault the cell can have; the
precision control reads far above the program."""

import pytest
import torch

from portbench import cells, judge
from portbench import reference as ref
from portbench.tests import tiny


def _train(monkeypatch=None, **kw):
    c = tiny.config(compute_dtype=kw.pop("dtype", "float32"))
    r = tiny.run(c, tiny.traffic("train-b32"), seed=kw.pop("seed", 21))
    out = cells.run_train(r)
    ok, checks = judge.verdict(out.numbers, judge.limits("paper-train-b32"))
    return ok and out.failed == 0, out


def _eval(seed=22, model=None, **kw):
    c = tiny.config(compute_dtype="float32", **(model or {}))
    r = tiny.run(c, tiny.traffic("iw-eval-k4096", **kw), seed=seed)
    out = cells.run_eval(r)
    ok, checks = judge.verdict(out.numbers, judge.limits("paper-eval-k4096"))
    return ok and out.failed == 0, out


def test_sound_training_run_is_correct():
    ok, out = _train()
    assert ok, out.numbers
    assert out.attempted >= 1 and out.e2e["train_examples_per_s"] > 0


def test_state_left_unchanged_is_not_correct(monkeypatch):
    from iaf_torch.parallel import train_step
    monkeypatch.setattr(train_step, "_apply_updates",
                        lambda cfg, state, grads: None)
    ok, out = _train()
    assert not ok
    assert out.numbers["change"] == pytest.approx(1.0)


def test_half_the_batch_is_not_correct(monkeypatch):
    from iaf_torch.parallel import train_step
    real = train_step.loss_fn

    def half(cfg, params, rng, batch, noise=None):
        n = batch.shape[0] // 2
        noise = {k: v[:n] for k, v in noise.items()}
        return real(cfg, params, rng, batch[:n], noise)

    monkeypatch.setattr(train_step, "loss_fn", half)
    ok, out = _train()
    assert not ok, out.numbers


def test_sound_eval_run_is_correct():
    ok, out = _eval()
    assert ok, out.numbers
    assert out.attempted >= 2 and out.e2e["iw_samples_per_s"] > 0


def test_eval_state_left_unchanged_is_not_correct(monkeypatch):
    from iaf_torch.parallel import eval_step
    monkeypatch.setattr(eval_step, "_running_update",
                        lambda m, s, log_w: (m, s))
    ok, out = _eval()
    assert not ok


def test_altered_answer_is_not_correct(monkeypatch):
    from iaf_torch.parallel import eval_step
    real = eval_step._bound
    monkeypatch.setattr(eval_step, "_bound",
                        lambda m, s, k, g: real(m, s, k, g) * 1.01)
    ok, out = _eval()
    assert not ok, out.numbers


@pytest.mark.parametrize("seed", [23, 31, 47])
def test_half_the_eval_batch_is_not_correct(monkeypatch, seed):
    """Half of each batch left out, the mean of the rest's bounds given
    for it: the cell's own picks (one answer from each half of every
    batch) and limits fail it on every seed. Images of the cell's 32x32
    size and a model of 4 layers, whose bounds differ from image to image
    by some nats, as they do on the card (by tens); at 8x8 with 2 layers
    they can differ by less than the limit."""
    from iaf_torch.parallel import eval_step
    real = eval_step._bound

    def half(m, s, k, g):
        b = real(m, s, k, g)
        n = b.shape[0] // 2
        return torch.cat([b[:n], b[:n].mean().expand(b.shape[0] - n)])

    monkeypatch.setattr(eval_step, "_bound", half)
    ok, out = _eval(seed=seed, batch_size=4,
                    model=dict(image_size=32, h_size=32, num_blocks=4))
    assert not ok, out.numbers


@pytest.mark.parametrize("seed", [23, 31])
def test_eval_picks_cover_each_half_of_every_batch(seed):
    t = tiny.traffic("iw-eval-k4096")
    picks = cells.pick(seed, [1, 2, 3], 16, t["check_per_half"])
    assert len(picks) == 6
    halves = {(b, i >= 8) for b, i in picks}
    assert halves == {(b, h) for b in (1, 2, 3) for h in (False, True)}


def test_fp8_control_is_not_correct():
    """The reference in float8 put in the program's place fails the
    cell's limits (its gradient and parts), and reads far above the bf16
    program at the same size."""
    c = tiny.config()
    t = tiny.traffic("train-b32")
    s = cells.TrainSetup(tiny.run(c, t, seed=24), builds=False)
    prog, batches = s.readings, s.batches
    s.prog.close()
    cpu = torch.device("cpu")
    base = cells.train_reference(c, 24, batches, 3, cpu)
    ctl = cells.train_reference(c, 24, batches, 3, cpu, quant=ref.fp8_quant)
    n_prog = judge.train_numbers(prog, base)
    n_ctl = judge.train_numbers(ctl, base)
    ok, _ = judge.verdict(n_ctl, judge.limits("paper-train-b32"))
    assert not ok
    assert n_ctl["loss"] > 3 * n_prog["loss"]
