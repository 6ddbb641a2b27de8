"""The MNIST family's data path against ``iaf_tpu`` on the CPU: dynamic
binarization, its per-step RNG and the binarized iterator (a resumed one
included) bitwise equal to JAX's; ``load_mnist`` on tiny idx files, plain
and ``.gz``, equal to JAX's loader; the synthetic fallback at 28x28x1."""

import gzip
import os

import numpy as np
import pytest

from iaf_tpu.data import datasets as jds
from iaf_tpu.data import feed as jfeed
from iaf_torch.data import datasets, feed


def _gray(n=10, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (n, 6, 6, 1)).astype(np.uint8)


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (123, -1),
                                       (123, -2), (2**30, 10**6)])
def test_dynamic_binarize_equals_jax(seed, step):
    x = _gray(seed=seed % 97)
    got = feed.dynamic_binarize(x, feed.binarize_rng(seed, step))
    want = jfeed.dynamic_binarize(x, jfeed.binarize_rng(seed, step))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0, 255}


@pytest.mark.parametrize("start_step", [0, 5])
def test_binarized_iterator_equals_jax_and_resumes(start_step):
    """Over the batch iterator, as ``train`` builds it; a run resumed at
    ``start_step`` binarizes its batches as the straight run did."""
    images = _gray(n=40, seed=3)

    def it(port, start):
        f = feed if port else jfeed
        return f.binarized_iterator(
            f.batch_iterator(images, 8, 9, start_step=start), 9,
            start_step=start)

    got, want = it(True, start_step), it(False, start_step)
    straight = it(True, 0)
    for _ in range(start_step):
        next(straight)
    for _ in range(7):
        a = next(got)
        np.testing.assert_array_equal(a, next(want))
        np.testing.assert_array_equal(a, next(straight))


def _idx_files(d, gz: bool, n_train=5, n_test=3):
    rs = np.random.RandomState(1)
    arrays = {"train-images-idx3-ubyte": rs.randint(0, 256, (n_train, 28, 28)),
              "train-labels-idx1-ubyte": rs.randint(0, 10, n_train),
              "t10k-images-idx3-ubyte": rs.randint(0, 256, (n_test, 28, 28)),
              "t10k-labels-idx1-ubyte": rs.randint(0, 10, n_test)}
    for name, a in arrays.items():
        a = a.astype(np.uint8)
        magic = 2051 if a.ndim == 3 else 2049
        head = magic.to_bytes(4, "big") + len(a).to_bytes(4, "big")
        if a.ndim == 3:
            head += (28).to_bytes(4, "big") * 2
        raw = head + a.tobytes()
        path = os.path.join(d, name + (".gz" if gz else ""))
        with (gzip.open if gz else open)(path, "wb") as f:
            f.write(raw)
    return arrays


@pytest.mark.parametrize("gz", [False, True])
def test_load_mnist_equals_jax(tmp_path, gz):
    arrays = _idx_files(str(tmp_path), gz)
    got = datasets.load_mnist(str(tmp_path))
    want = jds.load_mnist(str(tmp_path))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.train_x.shape == (5, 28, 28, 1)
    np.testing.assert_array_equal(got.test_y, arrays["t10k-labels-idx1-ubyte"])
    assert datasets.real_data_available("mnist", str(tmp_path)) == \
        str(tmp_path)
    ds, real = datasets.load_dataset("mnist", str(tmp_path), 28, 1)
    assert real and len(ds.train_x) == 5


def test_missing_mnist_falls_back_to_synthetic(tmp_path, monkeypatch):
    """No idx files anywhere: JAX's synthetic set at 28x28x1, bit for
    bit; one file missing is not a data set."""
    monkeypatch.setattr(datasets, "_candidate_dirs", lambda d: [d])
    monkeypatch.setattr(jds, "_candidate_dirs", lambda d: [d])
    _idx_files(str(tmp_path), gz=False)
    os.remove(tmp_path / "t10k-labels-idx1-ubyte")
    assert datasets.load_mnist(str(tmp_path)) is None
    assert datasets.real_data_available("mnist", str(tmp_path)) is None
    got, real = datasets.load_dataset("mnist", str(tmp_path), 28, 1)
    want, jreal = jds.load_dataset("mnist", str(tmp_path), 28, 1)
    assert not real and not jreal
    assert got.train_x.shape[1:] == (28, 28, 1)
    np.testing.assert_array_equal(got.train_x, want.train_x)
    np.testing.assert_array_equal(got.test_x, want.test_x)
