"""Datasets: CIFAR-10 and MNIST from local files and the deterministic
synthetic set (``iaf_tpu/data/datasets.py``).

Local files only: nothing is downloaded. ``synthetic_dataset`` is an exact
numpy copy of the JAX package's, so one seed gives the same uint8 images.
"""

from __future__ import annotations

import gzip
import os
import pickle
import tarfile
import tempfile
from typing import NamedTuple

import numpy as np


class Dataset(NamedTuple):
    train_x: np.ndarray  # uint8 [N, H, W, C]
    train_y: np.ndarray  # int32 [N]
    test_x: np.ndarray
    test_y: np.ndarray


def synthetic_dataset(image_size: int, channels: int, n_train: int = 4096,
                      n_test: int = 1024, seed: int = 0) -> Dataset:
    """Deterministic CIFAR-shaped synthetic data: smooth random
    low-frequency fields quantized to uint8."""
    rng = np.random.RandomState(seed)

    def make(n):
        base = rng.randn(n, 4, 4, channels).astype(np.float32)
        img = base
        while img.shape[1] < image_size:
            h = img.shape[1] * 2
            idx = np.linspace(0, img.shape[1] - 1, h).astype(np.float32)
            lo = np.floor(idx).astype(np.int32)
            hi = np.minimum(lo + 1, img.shape[1] - 1)
            w = (idx - lo)[None, :, None, None]
            img = img[:, lo] * (1 - w) + img[:, hi] * w
            w2 = (idx - lo)[None, None, :, None]
            img = img[:, :, lo] * (1 - w2) + img[:, :, hi] * w2
        img = img[:, :image_size, :image_size]
        img = (img - img.min()) / (img.max() - img.min() + 1e-9)
        noise = rng.uniform(0, 16, img.shape)
        return np.clip(img * 239 + noise, 0, 255).astype(np.uint8)

    return Dataset(make(n_train), np.zeros(n_train, np.int32),
                   make(n_test), np.zeros(n_test, np.int32))


def _candidate_dirs(data_dir: str) -> list[str]:
    cands = [data_dir, os.environ.get("IAF_DATA_DIR"), "/root/data", "/data",
             "/datasets", os.path.expanduser("~/data")]
    seen, out = set(), []
    for d in cands:
        if d and d not in seen:
            seen.add(d)
            out.append(d)
    return out


_MNIST_FILES = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")


def _mnist_file(data_dir: str, name: str) -> str | None:
    """``name`` in ``data_dir``, plain or ``.gz``, or None."""
    for suffix in ("", ".gz"):
        p = os.path.join(data_dir, name + suffix)
        if os.path.isfile(p):
            return p
    return None


def real_data_available(name: str, data_dir: str = "./data") -> str | None:
    """Directory holding the real ``name`` files (``cifar10``: the python
    batches or their tarball; ``mnist``: the four idx files, each plain or
    ``.gz``), or None. Never downloads."""
    for d in _candidate_dirs(data_dir):
        if name == "cifar10" and (
                os.path.isdir(os.path.join(d, "cifar-10-batches-py"))
                or os.path.isfile(os.path.join(d, "cifar-10-python.tar.gz"))):
            return d
        if name == "mnist" and all(_mnist_file(d, n) for n in _MNIST_FILES):
            return d
    return None


def load_mnist(data_dir: str) -> Dataset | None:
    """MNIST from the four idx files in ``data_dir`` (each plain or
    ``.gz``), or None if one is missing. Images uint8 [N, 28, 28, 1]."""
    paths = [_mnist_file(data_dir, n) for n in _MNIST_FILES]
    if not all(paths):
        return None

    def read(p):
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rb") as f:
            return f.read()

    def images(p):
        raw = read(p)
        n = int.from_bytes(raw[4:8], "big")
        return np.frombuffer(raw, np.uint8, offset=16).reshape(n, 28, 28, 1)

    def labels(p):
        return np.frombuffer(read(p), np.uint8, offset=8).astype(np.int32)

    return Dataset(images(paths[0]), labels(paths[1]), images(paths[2]),
                   labels(paths[3]))


def load_cifar10(data_dir: str) -> Dataset | None:
    """CIFAR-10 from the python-version batches or tarball in ``data_dir``,
    or None if neither is there. A tarball is extracted into a private
    temporary directory."""
    extracted = os.path.join(data_dir, "cifar-10-batches-py")
    tgz = os.path.join(data_dir, "cifar-10-python.tar.gz")
    tmp = None
    if not os.path.isdir(extracted):
        if not os.path.isfile(tgz):
            return None
        tmp = tempfile.TemporaryDirectory(prefix="iaf_torch_cifar10_")
        with tarfile.open(tgz, "r:gz") as f:
            f.extractall(tmp.name, filter="data")
        extracted = os.path.join(tmp.name, "cifar-10-batches-py")

    def _batch(name):
        with open(os.path.join(extracted, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.uint8), np.asarray(d[b"labels"], np.int32)

    try:
        xs, ys = zip(*[_batch(f"data_batch_{i}") for i in range(1, 6)])
        test_x, test_y = _batch("test_batch")
    finally:
        if tmp is not None:
            tmp.cleanup()
    return Dataset(np.concatenate(xs), np.concatenate(ys), test_x, test_y)


def load_dataset(name: str, data_dir: str, image_size: int = 32,
                 channels: int = 3) -> tuple[Dataset, bool]:
    """(dataset, is_real): real CIFAR-10 or MNIST when found on disk, else
    the synthetic set at ``image_size`` x ``channels``."""
    loaders = {"cifar10": load_cifar10, "mnist": load_mnist}
    if name in loaders:
        found = real_data_available(name, data_dir)
        ds = loaders[name](found) if found else None
        if ds is not None:
            return ds, True
    elif name != "synthetic":
        raise ValueError(f"unknown dataset {name!r}")
    return synthetic_dataset(image_size, channels), False
