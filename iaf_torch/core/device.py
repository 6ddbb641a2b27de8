"""Device selection: entry points run on CUDA unless the caller asks for
the CPU, and a CUDA request without a card fails instead of falling back.
Also the cuDNN flags some paths set for a block: TF32 off (``no_tf32``)
and deterministic algorithms (``cudnn_deterministic``)."""

from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. Under a data-parallel launch
    (``WORLD_SIZE`` set, ``parallel/mesh.py``) "cuda" is this process's
    card, ``cuda:LOCAL_RANK``, made the current device before any NCCL
    group is."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but torch.cuda is not "
                               "available; pass device='cpu' to run the "
                               "plain twins on the CPU")
        if dev.index is None and "WORLD_SIZE" in os.environ:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(dev)
        elif dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def full_f32(compute_dtype: str, dev: torch.device) -> bool:
    """The f32 recipe runs in f32 on the card too: for ``compute_dtype``
    float32 on CUDA, turn off TF32 in cuDNN's convs and in matmuls
    (PyTorch runs f32 convs in TF32 by default, ~3 decimal digits; the
    reference computes them at "highest"). Returns whether it did; the
    flags are process-wide and stay off."""
    if compute_dtype != "float32" or dev.type != "cuda":
        return False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return True


@contextlib.contextmanager
def tf32(cudnn: bool, matmul: bool):
    """Inside the block cuDNN's convs (``cudnn``) and matmuls (``matmul``)
    may or may not compute f32 in TF32, whatever the process's flags say;
    the flags are restored after."""
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = flags[0].allow_tf32, flags[1].allow_tf32
    flags[0].allow_tf32, flags[1].allow_tf32 = cudnn, matmul
    try:
        yield
    finally:
        flags[0].allow_tf32, flags[1].allow_tf32 = saved


def no_tf32():
    """Inside the block cuDNN's convs and matmuls compute f32 in full f32
    (TF32 off) whatever the process's flags say; the flags are restored
    after. For the parts that run in f32 under any ``compute_dtype``."""
    return tf32(False, False)


@contextlib.contextmanager
def cudnn_deterministic():
    """Inside the block cuDNN picks only deterministic algorithms, so two
    runs from one seed give the same bits (its transposed convs may
    otherwise sum in a different order from run to run); the old flag is
    restored after. The data-dependent inits run under it."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = saved
