"""Config system: a typed, flat hyperparameter container with a ``k=v,...``
string parser, CLI-compatible with ``iaf_tpu.core.config``.

Same field names, defaults, parse rules and validation as the JAX package,
so an ``--hpconfig`` string or a JAX run's ``hps.json`` loads unchanged.
Fields that only steer the TPU build are accepted and ignored here:
``kernels`` and ``ar_variant`` (on CUDA the hand-written kernels always
run, on the CPU their plain twins), ``pin_state_layouts`` and
``fused_opt_layout_aware`` (XLA layout choices), ``scan_blocks`` alone
(an XLA program-shape choice), and ``num_gpus`` (as in the JAX CLI:
``torchrun`` sets the ranks). ``scan_blocks`` with ``remat`` is JAX's
activation-memory lever and is honoured: the CIFAR model's training
forward checkpoints each IAF layer's up and down pass and recomputes
them in the backward (``models/cvae.py``); ``remat`` without
``scan_blocks`` changes nothing, as in JAX, and the MNIST family has no
remat. ``grad_accum`` A splits each step's global batch into A
micro-batches, over any number of ranks. ``mesh_data`` is the data axis,
the process group of ``parallel/mesh.py``: 0 (all ranks) or the world size;
``mesh_model`` > 1, JAX's reserved model axis, is not ported and
raises. ``steps_per_dispatch`` S is the training loop's:
S steps a dispatch, on the card S replays of the step's CUDA graph
enqueued back to back.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, fields
from typing import Any


def _parse_value(raw: str, default: Any) -> Any:
    """Parse ``raw`` using the type of ``default`` (HParams-style inference)."""
    if isinstance(default, bool):
        low = raw.strip().lower()
        if low in ("true", "1", "yes"):
            return True
        if low in ("false", "0", "no"):
            return False
        raise ValueError(f"cannot parse {raw!r} as bool")
    if isinstance(default, int) and not isinstance(default, bool):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    if isinstance(default, str):
        return raw
    if isinstance(default, tuple):
        if raw.strip() == "":
            return ()
        elem = default[0] if default else 0
        return tuple(_parse_value(p, elem) for p in raw.split(";"))
    raise TypeError(f"unsupported config field type {type(default)}")


@dataclass(frozen=True)
class Config:
    """All hyperparameters of the IAF-VAE stack (see ``iaf_tpu`` for the
    meaning of each field and the reference it follows)."""

    # --- data / problem ---
    dataset: str = "cifar10"          # cifar10 | mnist | synthetic
    data_dir: str = "./data"
    image_size: int = 32
    channels: int = 3

    # --- model architecture ---
    z_size: int = 32
    h_size: int = 160
    depth: int = 2
    num_blocks: int = 2
    k: int = 1
    kl_min: float = 0.25
    depth_ar: int = 2
    ar_hidden_size: int = 0           # 0 -> use h_size
    flow: str = "iaf"                 # iaf | diag
    flow_update: str = "division"     # division | gate
    gate_forget_bias: float = 1.0
    ar_kind: str = "conv"             # conv | dense
    flow_depth: int = 2
    kernel_size: int = 3
    stem_kernel_size: int = 5
    stat_init_scale: float = 0.1

    # --- objective / likelihood ---
    likelihood: str = "dlogistic"     # dlogistic | bernoulli
    binarize: bool = False

    # --- optimization ---
    learning_rate: float = 0.002
    beta1: float = 0.9
    beta2: float = 0.999
    adamax_eps: float = 1e-8
    bias_correction: bool = False
    polyak_decay: float = 0.999
    grad_clip: float = 0.0
    grad_accum: int = 1
    batch_size: int = 16
    total_steps: int = 1_000_000
    seed: int = 123
    steps_per_dispatch: int = 1       # steps per dispatch (graph replays)

    scan_blocks: bool = False         # alone: accepted, ignored (XLA)
    fold_wn: bool = True
    remat: bool = False               # with scan_blocks: per-layer recompute
    pin_state_layouts: bool = False   # accepted, ignored (XLA layouts)
    fused_opt_layout_aware: bool = True  # accepted, ignored (XLA layouts)

    # --- precision / kernels ---
    # Conv inputs are cast to this dtype; accumulation and all elementwise
    # math stay f32.
    compute_dtype: str = "bfloat16"
    kernels: str = "auto"             # accepted, ignored (Pallas selection)
    ar_variant: str = "pertap"        # accepted, ignored (Pallas variant)
    ar_row_trim: bool = True
    merge_ar_heads: bool = True

    # --- parallelism ---
    num_gpus: int = 1                 # accepted, ignored (torchrun sets it)
    mesh_data: int = 0                # data-parallel ranks: 0 (all) or world
    mesh_model: int = 1               # model axis: only 1 (not ported)

    # --- eval ---
    eval_batch_size: int = 16
    eval_k: int = 4096
    eval_k_chunk: int = 64

    # --- checkpoint / logging ---
    logdir: str = "/tmp/iaf_tpu"
    ckpt_every: int = 1000
    ckpt_keep: int = 5
    log_every: int = 100
    eval_every: int = 0
    fail_after_step: int = 0
    tensorboard: bool = False
    image_summaries: bool = True

    # ------------------------------------------------------------------
    def parse(self, spec: str) -> "Config":
        """Return a new Config with ``k=v,...`` overrides applied; types
        are inferred from the defaults, unknown keys are an error."""
        if not spec:
            return self
        by_name = {f.name: f for f in fields(self)}
        updates: dict[str, Any] = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"malformed hpconfig item {item!r} (need k=v)")
            key, raw = item.split("=", 1)
            key = key.strip()
            if key not in by_name:
                raise KeyError(f"unknown hyperparameter {key!r}")
            updates[key] = _parse_value(raw, getattr(self, key))
        return dataclasses.replace(self, **updates)

    def __post_init__(self):
        legal = ("auto", "pallas", "xla", "pallas_ar", "pallas_opt",
                 "pallas_elem")
        if self.kernels not in legal:
            raise ValueError(f"kernels={self.kernels!r} not in {legal}")
        if self.ar_variant not in ("pertap", "im2col"):
            raise ValueError(f"ar_variant={self.ar_variant!r} not in "
                             "('pertap', 'im2col')")
        # the context is added to the FIRST hidden masked conv's output, so
        # conv AR hidden widths must equal h_size
        if (self.flow == "iaf" and self.ar_kind == "conv"
                and self.depth_ar > 0
                and self.ar_hidden_size not in (0, self.h_size)):
            raise ValueError(
                f"ar_hidden_size={self.ar_hidden_size} != h_size="
                f"{self.h_size}: conv AR hidden width is fixed to h_size "
                "by the context add (set ar_hidden_size=0, or use "
                "ar_kind=dense)")
        if (self.flow == "iaf" and self.ar_kind == "conv"
                and self.depth_ar == 0):
            raise ValueError(
                "depth_ar=0 with the conv AR path would silently drop the "
                "up/down context from the posterior flow; use flow=diag "
                "for a no-flow model or depth_ar>=1")

    @property
    def ar_hidden(self) -> int:
        return self.ar_hidden_size or self.h_size

    @property
    def num_pixels(self) -> int:
        return self.image_size * self.image_size * self.channels

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def get_default_hparams() -> Config:
    return Config()


HPS_FILENAME = "hps.json"


def save_hparams(cfg: Config, logdir: str) -> str:
    """Write the resolved config to ``logdir/hps.json`` (atomically), so
    that later eval runs rebuild the training architecture without
    ``--hpconfig``."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, HPS_FILENAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_hparams(logdir: str) -> Config | None:
    """Config from ``logdir/hps.json``, or None if absent. Unknown keys are
    skipped with a warning; list values become tuples."""
    path = os.path.join(logdir, HPS_FILENAME)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        raw = json.load(f)
    known = {f.name for f in fields(Config)}
    updates = {}
    for k, v in raw.items():
        if k not in known:
            print(f"[config] ignoring unknown saved hyperparameter {k!r}")
            continue
        updates[k] = tuple(v) if isinstance(v, list) else v
    return Config(**updates)


def resolve_config(logdir: str, hpconfig: str, mode: str = "train") -> Config:
    """Saved ``hps.json`` in ``logdir`` (if any) as the base, then
    ``--hpconfig`` overrides, then ``logdir`` itself."""
    del mode
    base = load_hparams(logdir)
    return (base if base is not None else get_default_hparams()).parse(
        hpconfig).replace(logdir=logdir)
