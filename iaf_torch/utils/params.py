"""Parameter introspection (``iaf_tpu/utils/params.py``) of a module."""

from __future__ import annotations

import torch


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def describe(model: torch.nn.Module) -> str:
    """The parameter total and the number of arrays."""
    n_arrays = sum(1 for _ in model.parameters())
    return f"{param_count(model):,} parameters in {n_arrays} arrays"
