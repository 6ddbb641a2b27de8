"""Parameter bridge between the JAX pytree / ``.npz`` checkpoint of
``iaf_tpu`` and the port's ``state_dict``.

JAX keeps every stochastic layer's leaves of the CIFAR model stacked in
``params["blocks"]`` with a leading layer dim L and conv kernels in HWIO;
the port has one module per layer (``blocks.{i}.…``) and PyTorch's
layouts: a conv ``V`` is [out, in, kh, kw], a deconv's (``x_dec``; the
MNIST model's ``dec1`` and ``dec2``) [in, out, kh, kw], a dense ``V``
[out, in]. The MNIST model has no ``blocks``. The round trip is exact
(transposes only).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from iaf_torch.core.rng import generator

_SEP = "//"
_DECONVS = ("x_dec", "dec1", "dec2")


def to_torch_layout(path: tuple[str, ...], leaf: np.ndarray) -> np.ndarray:
    """One leaf from the JAX layout into the port's (``path`` without the
    layer index)."""
    if path[-1] != "V":
        return leaf
    if leaf.ndim == 4:
        return leaf.transpose((2, 3, 0, 1) if path[0] in _DECONVS
                              else (3, 2, 0, 1))
    if leaf.ndim == 2:
        return leaf.T
    return leaf


def _jax_shape(path: tuple[str, ...],
               torch_shape: tuple[int, ...]) -> tuple[int, ...]:
    """The JAX shape of a leaf the port holds in ``torch_shape``."""
    if path[-1] != "V" or len(torch_shape) not in (2, 4):
        return torch_shape
    if len(torch_shape) == 2:
        return torch_shape[::-1]
    a, b, kh, kw = torch_shape
    return (kh, kw, a, b) if path[0] in _DECONVS else (kh, kw, b, a)


def normal_leaf(path: tuple[str, ...], torch_shape: tuple[int, ...],
                key: int, stddev: float) -> torch.Tensor:
    """N(0, stddev^2) drawn from ``key`` in the leaf's JAX layout (as
    JAX's ``normal_init`` draws it), then moved into the port's."""
    draw = stddev * torch.randn(_jax_shape(path, torch_shape),
                                generator=generator(key, "cpu"))
    return torch.from_numpy(np.ascontiguousarray(
        to_torch_layout(path, draw.numpy())))


def to_jax_layout(path: tuple[str, ...], leaf: np.ndarray) -> np.ndarray:
    if path[-1] != "V":
        return leaf
    if leaf.ndim == 4:
        return leaf.transpose((2, 3, 0, 1) if path[0] in _DECONVS
                              else (2, 3, 1, 0))
    if leaf.ndim == 2:
        return leaf.T
    return leaf


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def from_jax_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX params pytree (numpy or jax leaves) -> the port's state_dict."""
    sd: dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, val in node.items():
            p = path + (key,)
            if isinstance(val, Mapping):
                walk(val, p)
                continue
            a = np.asarray(val)
            if p[0] == "blocks":
                for i in range(a.shape[0]):
                    name = ".".join(("blocks", str(i)) + p[1:])
                    sd[name] = _tensor(to_torch_layout(p[1:], a[i]))
            else:
                sd[".".join(p)] = _tensor(to_torch_layout(p, a))

    walk(tree, ())
    return sd


def to_jax_params(sd: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The port's state_dict -> the JAX params pytree (numpy leaves)."""
    tree: dict[str, Any] = {}
    stacked: dict[tuple[str, ...], dict[int, np.ndarray]] = {}
    for name, t in sd.items():
        parts = tuple(name.split("."))
        a = t.detach().cpu().numpy()
        if parts[0] == "blocks":
            rest = parts[2:]
            stacked.setdefault(rest, {})[int(parts[1])] = to_jax_layout(rest, a)
            continue
        _set(tree, parts, to_jax_layout(parts, a))
    for rest, per_layer in stacked.items():
        leaf = np.stack([per_layer[i] for i in range(len(per_layer))])
        _set(tree, ("blocks",) + rest, leaf)
    return tree


def _set(tree: dict, path: tuple[str, ...], val) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = val


def load_jax_checkpoint(npz_path: str, use_ema: bool = True
                        ) -> dict[str, torch.Tensor]:
    """state_dict from an ``iaf_tpu`` checkpoint (``ckpt-*.npz``, keys
    joined with ``//``): the Polyak average ``opt//ema`` or the raw
    ``params``."""
    prefix = ("opt", "ema") if use_ema else ("params",)
    tree: dict[str, Any] = {}
    with np.load(npz_path) as f:
        for key in f.files:
            parts = tuple(key.split(_SEP))
            if parts[:len(prefix)] == prefix:
                _set(tree, parts[len(prefix):], f[key])
    if not tree:
        raise KeyError(f"{npz_path} has no {_SEP.join(prefix)} entries")
    return from_jax_params(tree)
