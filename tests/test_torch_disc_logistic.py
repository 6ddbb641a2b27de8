"""K4, the discretized-logistic log-likelihood (``ops/fused.py``,
``ops/csrc/disc_logistic.cu``).

On the CPU: the host plan ``dl_plan`` (the blocks of a cluster that each
row is split over), the power-of-two shortcut the kernel takes for
sample / b, and the twins (forward, and the backward as autograd of the
forward) against ``iaf_tpu``'s XLA twin, its Pallas kernel in interpret mode
and the Pallas kernel's ``jax.vjp``, on the same numpy inputs with samples
on bin edges, odd row lengths and log-scales 0, -1.3 and 0.7: row sums at
rtol 1e-5; dmean within 1e-5 of its max and dlogscale at rtol 1e-5 where
f32 carries that many digits, else no further from the twin in f64 than
JAX's own f32 result (``_held``).

On the card (``cuda``, skipped elsewhere): the kernels against the twin at
N in {1, 32, 1024} and row lengths 3072 (a CIFAR image), 12288 (64x64x3)
and 7 (scalar loads), for every split; two calls give the same bits; the
backward is one device kernel a call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu.ops.fused import disc_logistic_logp as j_dl, disc_logistic_xla
from iaf_torch import ops
from iaf_torch.ops import fused

ROWS = (1, 32, 1024)
ROW_LENS = (3072, 12288, 7)
SPLITS = (1, 2, 4, 8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(shape, seed=0):
    """Samples on bin edges (images / 256 - 0.5, as the model feeds K4) and
    means near them, f32."""
    rs = np.random.RandomState(seed)
    sample = (rs.randint(0, 256, shape) / 256.0 - 0.5).astype(np.float32)
    mean = (sample + 0.05 * rs.randn(*shape)).astype(np.float32)
    g = rs.randn(shape[0]).astype(np.float32)
    return mean, sample, g


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("row_len", ROW_LENS)
def test_dl_plan(rows, row_len):
    """S is a power of two up to 8, every block of a row's cluster gets
    elements, and a split block takes at least two a thread."""
    s = ops.dl_plan(rows, row_len)
    chunk = fused._dl_chunk(row_len, s)
    assert s in SPLITS
    assert chunk % 4 == 0 and s * chunk >= row_len
    assert (s - 1) * chunk < row_len          # the last block is not empty
    assert s == 1 or row_len >= s * fused._DL_MIN_PER_BLOCK
    if s < fused._DL_MAX_SPLITS and row_len >= 2 * s * \
            fused._DL_MIN_PER_BLOCK:           # splits stop once the card
        assert rows * s >= 2 * fused._SMS     # has two blocks an SM


def test_pow2_binsize_division_is_exact():
    """For b = 1/256, sample / b and sample * 256 are the same float32 for
    every bin edge and for 1e5 seeded samples, and a sample on a bin edge
    snaps to that bin."""
    b, inv = np.float32(1 / 256), np.float32(256)
    rs = np.random.RandomState(7)
    edges = np.concatenate([np.arange(256) / 256.0,
                            np.arange(256) / 256.0 - 0.5]).astype(np.float32)
    xs = np.concatenate([
        edges, rs.uniform(-0.5, 0.5, 10**5).astype(np.float32),
        (100 * rs.randn(10**5)).astype(np.float32)])
    np.testing.assert_array_equal((xs / b).view(np.int32),
                                  (xs * inv).view(np.int32))
    np.testing.assert_array_equal(np.floor(edges / b) * b, edges)


@pytest.mark.parametrize("binsize,pow2", [
    (1 / 256, True), (1 / 128, True), (2.0, True), (2.0**-126, True),
    (0.003, False), (1 / 255, False), (2.0**-127, False), (2.0**127, False)])
def test_host_picks_division_unless_pow2(binsize, pow2):
    """The kernel multiplies by 1/b only where both b and 1/b are normal
    powers of two; at b = 0.003 it divides, because the product with the
    rounded reciprocal is another float for some samples."""
    assert fused._pow2_binsize(binsize) is pow2
    if binsize == 0.003:
        xs = np.random.RandomState(8).uniform(-0.5, 0.5, 10**5).astype(
            np.float32)
        b = np.float32(binsize)
        assert np.any(xs / b != xs * (np.float32(1) / b))


SHAPES = [(3, 5, 7, 3), (2, 1, 1, 7), (4, 3, 3, 3)]   # rows of 105, 7, 27
LOGSCALES = [0.0, -1.3, 0.7]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ls", LOGSCALES)
def test_twin_matches_xla_and_pallas(shape, ls):
    mean, sample, _ = _inputs(shape, seed=len(SHAPES) * shape[0] + 1)
    got = ops.disc_logistic_ref(_t(mean), torch.tensor(np.float32(ls)),
                                _t(sample)).numpy()
    for want in (disc_logistic_xla(jnp.asarray(mean), jnp.float32(ls),
                                   jnp.asarray(sample)),
                 j_dl(jnp.asarray(mean), jnp.float32(ls),
                      jnp.asarray(sample))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=0)


def _held(got, want, ref64, tol=1e-5):
    """``got`` (the twin in f32) within ``tol`` of ``want`` (JAX in f32),
    over the f64 twin's largest magnitude. Where f32 itself cannot carry
    ``tol`` (JAX further than tol/2 from the f64 twin: sigmoid(x + b/s) -
    sigmoid(x) cancels at small b/s, and each ulp of a sigmoid comes out
    250-2000 times larger in dmean), the twin must be no further from the
    f64 twin than JAX is, within 1.5x, plus ``tol``."""
    got, want, ref64 = (np.asarray(a, np.float64) for a in (got, want,
                                                            ref64))
    scale = np.abs(ref64).max()
    pair = np.abs(got - want).max() / scale
    e_got = np.abs(got - ref64).max() / scale
    e_want = np.abs(want - ref64).max() / scale
    if e_want <= tol / 2:
        assert pair <= tol, (pair, e_got, e_want)
    else:
        assert e_got <= 1.5 * e_want + tol, (pair, e_got, e_want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ls", [*LOGSCALES, -3.0])
def test_bwd_twin_matches_pallas_vjp(shape, ls):
    """dmean and dlogscale of the twin against the Pallas kernel's VJP, each
    held as ``_held`` says; at logscale -3 (b/s = 0.078) both are within
    3e-6 of the f64 twin, at 0, -1.3 and 0.7 both are 3e-5 to 3e-3 of
    dmean's max from it, and dlogscale up to 4.5e-5."""
    mean, sample, g = _inputs(shape, seed=len(SHAPES) * shape[0] + 2)
    _, vjp = jax.vjp(lambda m_, l_: j_dl(m_, l_, jnp.asarray(sample)),
                     jnp.asarray(mean), jnp.float32(ls))
    want = vjp(jnp.asarray(g))
    got = ops.disc_logistic_bwd_ref(
        _t(mean), torch.tensor(np.float32(ls)), _t(sample), _t(g))
    ref64 = ops.disc_logistic_bwd_ref(
        _t(mean).double(), torch.tensor(float(np.float32(ls))),
        _t(sample).double(), _t(g).double())
    for a, b, r in zip(got, want, ref64):
        _held(a.numpy(), b, r.numpy())


def test_bwd_never_takes_the_twin_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card (meta stands in
    for a device without a kernel) raises; it does not take the twin."""
    m = torch.empty((3, 4), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.disc_logistic_bwd(m, torch.empty((1,), device="meta"), m,
                              torch.empty((3,), device="meta"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return torch.device("cuda")


def _card_inputs(rows, row_len, dev, ls=-1.3, seed=3):
    mean, sample, g = _inputs((rows, row_len), seed)
    return (_t(mean).to(dev), torch.tensor([ls], device=dev),
            _t(sample).to(dev), _t(g).to(dev))


def _check(got, ref, dgot, dref):
    rel = ((got - ref).abs() / ref.abs()).max()
    assert rel <= 1e-5, rel
    err = (dgot[0] - dref[0]).abs().max()
    assert err <= 1e-5 * dref[0].abs().max(), err
    torch.testing.assert_close(dgot[1], dref[1], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("row_len", ROW_LENS)
def test_kernels_match_twin_on_card(cuda, rows, row_len):
    """Forward and backward against the twin on the card, with the plan's
    split and with each split forced."""
    mean, ls, sample, g = _card_inputs(rows, row_len, cuda)
    ref = ops.disc_logistic_ref(mean, ls, sample)
    dref = ops.disc_logistic_bwd_ref(mean, ls, sample, g)
    for s in (None, *SPLITS):
        with torch.inference_mode():
            got = fused._dl_fwd(mean, ls, sample, 1 / 256, splits=s)
            dgot = ops.disc_logistic_bwd(mean, ls, sample, g, splits=s)
        _check(got, ref, dgot, dref)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,row_len,offset", [
    (32, 3072, 0), (1024, 3072, 0), (32, 3072, 1), (5, 12, 2)])
def test_two_calls_bitwise_equal_on_card(cuda, rows, row_len, offset):
    """Every sum is taken in a fixed order, so two calls give the same
    bits, forward and backward (dlogscale too, whichever row finishes
    last); ``offset`` floats into a buffer take the scalar loads."""
    mean, ls, sample, g = _card_inputs(rows, row_len, cuda, seed=4)
    if offset:
        def shift(t):
            buf = torch.empty(t.numel() + offset, device=cuda)
            out = buf[offset:].view(t.shape)
            out.copy_(t)
            return out
        mean, sample = shift(mean), shift(sample)
        assert mean.data_ptr() % 16
    with torch.inference_mode():
        a, b = (ops.disc_logistic_logp(mean, ls, sample) for _ in range(2))
        da, db = (ops.disc_logistic_bwd(mean, ls, sample, g)
                  for _ in range(2))
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(da, db))
    _check(a, ops.disc_logistic_ref(mean, ls, sample), da,
           ops.disc_logistic_bwd_ref(mean, ls, sample, g))


@pytest.mark.cuda
def test_non_pow2_binsize_divides_on_card(cuda):
    """At b = 0.003 the kernel divides, as the twin does on the CPU (on the
    card PyTorch multiplies by the rounded 1/b, which can floor a sample
    into another bin). Logscale -3 (b/s = 0.06), where the CPU's exp and
    log, other code than the card's, agree with it within 1e-5 (at -1.3
    the cancellation makes any two f32 implementations differ by ~5e-5 of
    dmean's max)."""
    mean, ls, sample, g = _card_inputs(32, 3072, cuda, ls=-3.0, seed=5)
    got = ops.disc_logistic_logp(mean, ls, sample, binsize=0.003)
    dgot = ops.disc_logistic_bwd(mean, ls, sample, g, binsize=0.003)
    cpu = [t.cpu() for t in (mean, ls, sample, g)]
    ref = ops.disc_logistic_ref(*cpu[:3], binsize=0.003)
    dref = ops.disc_logistic_bwd_ref(*cpu, binsize=0.003)
    _check(got.cpu(), ref, [t.cpu() for t in dgot], dref)


@pytest.mark.cuda
def test_bwd_is_one_device_kernel_on_card(cuda):
    """The backward puts one kernel on the card a call, and nothing after
    it sums the rows' shares of dlogscale."""
    from torch.profiler import ProfilerActivity, profile
    mean, ls, sample, g = _card_inputs(32, 3072, cuda)
    ops.disc_logistic_bwd(mean, ls, sample, g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ops.disc_logistic_bwd(mean, ls, sample, g)
        torch.cuda.synchronize()
    events = [(e.key, e.count) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(events) == 1 and "dl_bwd_kernel" in events[0][0], events
    assert 1 <= events[0][1] <= 10, events


@pytest.mark.cuda
@pytest.mark.parametrize("ls", [0.0, -1.3, 0.7, -3.0, 2.5])
def test_dmean_bitwise_equals_twin_on_card(cuda, ls):
    """dmean is autograd of the twin operation for operation, its two
    divisions by the scale included (``div_scale``: through the scale's
    reciprocal), so it has the twin's bits on the card, here for means
    spread over 40 binades on both sides of every bin edge."""
    rs = np.random.RandomState(9)
    shape = (64, 3072)
    sample = (rs.randint(0, 256, shape) / 256.0 - 0.5).astype(np.float32)
    spread = (rs.choice([-1.0, 1.0], shape)
              * 2.0 ** rs.uniform(-36, 4, shape)).astype(np.float32)
    mean, sample, g = (_t(a).to(cuda) for a in (
        sample + spread, sample, rs.randn(64).astype(np.float32)))
    lsv = torch.tensor([ls], device=cuda)
    got = ops.disc_logistic_bwd(mean, lsv, sample, g)[0]
    want = ops.disc_logistic_bwd_ref(mean, lsv, sample, g)[0]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), int(
        (got != want).sum())
