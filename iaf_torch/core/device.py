"""Device selection: entry points run on CUDA unless the caller asks for
the CPU, and a CUDA request without a card fails instead of falling back."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but torch.cuda is not "
                               "available; pass device='cpu' to run the "
                               "plain twins on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
