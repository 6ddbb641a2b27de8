"""Inference export through ``torch.export`` (``iaf_tpu/core/export.py``).

``--mode export`` writes the trained model's two inference surfaces as
``torch.export`` programs with the (EMA) weights stored in the file:

  ``sample.pt2``  f(temperature, *noise)  -> images in [0, 256) f32,
                  [num_samples, H, W, C]
  ``elbo.pt2``    f(x_uint8, *noise)      -> per-example nats [B] (the
                  k-sample IW bound)

The program records the forward kernels as the torch ops ``iaf::ar_stack``
(K1), ``iaf::masked_conv2d`` (K2), ``iaf::iaf_update`` (K3) and
``iaf::disc_logistic_logp`` (K4), registered by ``iaf_torch.ops``: loaded
on the card, the artifact launches the hand-written kernels; on the CPU
their twins. A serving process needs ``torch`` and ``iaf_torch.ops``
(which holds the kernels) and this module, none of the model code
(``iaf_torch.models``, ``nn``, ``train_lib``); this module's top-level
imports keep to that.

The noise contract, the one departure from the JAX package's artifacts
(which take a PRNG key): a ``torch.Generator`` made inside a traced
function is stored in the program as a constant, so a seed cannot be an
input. The artifact takes each noise site as an input instead, in a
fixed order, and takes no seed:

- CIFAR elbo: every ``block_i/layer_j/z_post``, [B * k, H/2, H/2, z];
- CIFAR sample: every ``block_i/layer_j/z_prior``, [num_samples, H/2,
  H/2, z];
- MNIST: ``z`` [B * k, z] (elbo) and ``z_prior`` [num_samples, z]
  (sample).

``draw_noise(contract, seed, device)`` draws them with ``core.rng``
exactly as the eager forward at key ``seed`` does, so
``load_exported(p)(x, *draw_noise(c, seed, dev))`` equals
``apply_fn(cfg, model, seed, x, mode="eval", k=k).elbo_nats`` bit for bit
on the same device (and the sample artifact ``sample(cfg, model, seed,
num_samples, T)``). Each file carries its contract (``contract.json``,
stored with ``torch.export.save``'s ``extra_files``): the surface, the
family, the inputs, the noise sites and shapes in order, ``k``,
``num_samples``, the batch, the device, ``use_ema`` and the TF32 flags
under which the eager surface runs. Those flags are process-wide backend
settings, which the program does not record: ``load_exported`` sets them
around each call and restores them after (the sample surface runs with
TF32 off, as both families' ``sample`` does; the elbo surface under the
flags the exporting process ran with).

Shapes are static: the batch is ``batch_size`` or ``cfg.eval_batch_size``
and the loaded program refuses another. Host values the model reads
become constants of the program: an export under a process group exports
rank 0's model at world size 1 (``world_size`` in the contract).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Sequence

import torch
from torch import nn

from iaf_torch import ops  # noqa: F401  (registers the iaf:: torch ops)
from iaf_torch.core.config import Config
from iaf_torch.core.device import tf32
from iaf_torch.core.rng import fold_name, site_normal

CONTRACT = "contract.json"
_PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}
# both families' ``sample`` runs under ``core.device.no_tf32``
_TF32_OFF = {"cudnn": False, "matmul": False}


class _Sample(nn.Module):
    """f(temperature, *noise): ``num`` prior samples, the noise sites of
    ``sites`` injected in that order."""

    def __init__(self, cfg: Config, model: nn.Module, family, num: int):
        super().__init__()
        self.cfg, self.model, self.family, self.num = cfg, model, family, num
        self.sites = list(family.sample_noise_shapes(cfg, num))

    def forward(self, temperature, *noise):
        return self.family.sample(self.cfg, self.model, 0, self.num,
                                  temperature,
                                  noise=dict(zip(self.sites, noise)))


class _Elbo(nn.Module):
    """f(x_uint8, *noise): the negative k-sample IW bound per example, the
    posterior noise sites of ``sites`` injected in that order."""

    def __init__(self, cfg: Config, model: nn.Module, family, k: int):
        super().__init__()
        self.cfg, self.model, self.family, self.k = cfg, model, family, k
        self.sites = list(family.noise_shapes(cfg, k))

    def forward(self, x, *noise):
        return self.family.apply_fn(self.cfg, self.model, 0, x, mode="eval",
                                    k=self.k,
                                    noise=dict(zip(self.sites, noise))
                                    ).elbo_nats


def build_inference_fns(cfg: Config, model: nn.Module,
                        num_samples: int = 16, k: int = 1):
    """``(sample, elbo)``: two ``nn.Module``s closing over ``model`` (the
    family's, ``models.get_model``), ``sample(temperature, *noise)`` and
    ``elbo(x_uint8, *noise)``, each noise site an input (the module's
    ``sites``, in order). ``k`` is the importance-sample count of the
    scoring bound (k=1 = plain ELBO); ``num_samples`` the sample batch."""
    from iaf_torch.models import get_model
    family = get_model(cfg)
    return (_Sample(cfg, model, family, num_samples),
            _Elbo(cfg, model, family, k))


def _devices(platforms: Sequence[str] | None,
             default: torch.device) -> list[torch.device]:
    """The devices of ``platforms`` (``cuda``, alias ``gpu``, and
    ``cpu``); ``default`` for none."""
    if not platforms:
        return [default]
    out = []
    for p in platforms:
        if p not in _PLATFORMS:
            raise ValueError(
                f"export platform {p!r}: iaf_torch exports for cuda (alias "
                "gpu) and cpu; a TPU artifact is iaf_tpu's export")
        if _PLATFORMS[p] == "cpu":
            dev = torch.device("cpu")
        elif not torch.cuda.is_available():
            raise ValueError(
                f"export platform {p!r}: torch.cuda is not available, and "
                "an artifact for the card is traced on the card")
        else:
            dev = default if default.type == "cuda" else torch.device(
                "cuda", torch.cuda.current_device())
        if dev not in out:
            out.append(dev)
    return out


def _tf32_now() -> dict:
    return {"cudnn": torch.backends.cudnn.allow_tf32,
            "matmul": torch.backends.cuda.matmul.allow_tf32}


def export_artifacts(cfg: Config, model: nn.Module, out_dir: str,
                     num_samples: int = 16, k: int = 1,
                     batch_size: int | None = None,
                     platforms: Sequence[str] | None = None,
                     use_ema: bool | None = None) -> dict:
    """Trace both surfaces with ``torch.export`` (no grad, static shapes:
    ``num_samples`` images to sample, ``batch_size`` or
    ``cfg.eval_batch_size`` to score) and write them to ``out_dir`` with
    their contracts; returns ``{name: path}``. One platform (default: the
    model's device) gives ``sample.pt2`` and ``elbo.pt2``; several give
    ``<name>_<platform>.pt2``, each traced from a copy of the model on
    that device. ``use_ema`` goes into the contract (None: the caller's
    weights, not a checkpoint's)."""
    home = next(model.parameters()).device
    devices = _devices(platforms, home)
    batch = batch_size or cfg.eval_batch_size
    hw, ch = cfg.image_size, cfg.channels
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for dev in devices:
        on_dev = model if dev == home else copy.deepcopy(model).to(dev)
        sample, elbo = build_inference_fns(cfg, on_dev, num_samples, k)
        shapes = {
            "sample": sample.family.sample_noise_shapes(cfg, num_samples),
            "elbo": elbo.family.noise_shapes(cfg, batch * k)}
        first = {"sample": torch.ones((), device=dev),
                 "elbo": torch.zeros((batch, hw, hw, ch), dtype=torch.uint8,
                                     device=dev)}
        for name, mod in (("sample", sample), ("elbo", elbo)):
            noise = [torch.zeros(s, device=dev) for s in shapes[name].values()]
            with torch.no_grad():
                program = torch.export.export(
                    mod, (first[name], *noise), strict=False)
            contract = {
                "surface": name, "family": cfg.likelihood,
                "inputs": ["temperature f32 []" if name == "sample" else
                           f"x uint8 {[batch, hw, hw, ch]}",
                           "*noise, in the order of 'noise'"],
                "noise": [[site, list(s)] for site, s in shapes[name].items()],
                "batch": batch, "k": k, "num_samples": num_samples,
                "device": dev.type, "use_ema": use_ema,
                "tf32": _TF32_OFF if name == "sample" else _tf32_now(),
                "world_size": 1,
                "needs": "torch and iaf_torch.ops (the iaf:: torch ops); "
                         "iaf_torch.core.export to load and draw the noise"}
            stem = name if len(devices) == 1 else f"{name}_{dev.type}"
            path = os.path.join(out_dir, f"{stem}.pt2")
            torch.export.save(program, path,
                              extra_files={CONTRACT: json.dumps(contract)})
            paths[stem] = path
    return paths


class Exported:
    """A loaded artifact: ``program`` (the ``ExportedProgram``),
    ``contract`` (its ``contract.json``), and a call that runs the program
    without grad under the contract's TF32 flags, restored after, on its
    inputs made contiguous: the program was traced on contiguous inputs
    and keeps no ``.contiguous()`` that was a no-op there, so another
    layout would flow on into cuDNN, whose algorithms (and last bits)
    follow the memory layout, where the eager forward copies it first."""

    def __init__(self, program, contract: dict):
        self.program, self.contract = program, contract
        self._module = program.module()

    def __call__(self, *args):
        flags = self.contract["tf32"]
        args = [a.contiguous() if torch.is_tensor(a) else a for a in args]
        with torch.no_grad(), tf32(flags["cudnn"], flags["matmul"]):
            return self._module(*args)


def load_exported(path: str) -> Exported:
    """Load a ``.pt2`` artifact into a callable, its input shapes checked
    against the exported ones. Needs torch and ``iaf_torch.ops`` (the
    kernels' torch ops, imported here), no model code."""
    extra = {CONTRACT: ""}
    program = torch.export.load(path, extra_files=extra)
    return Exported(program, json.loads(extra[CONTRACT]))


def _site_key(seed: int, site: str) -> int:
    """The key the eager forward at ``seed`` draws ``site`` from:
    fold_name(fold_name(seed, scope), leaf) for ``<scope>/<leaf>``, as
    ``cvae._eps`` does (scope ``block_i/layer_j``), else fold_name(seed,
    site), as ``mnist_vae``'s root sites."""
    scope, _, leaf = site.rpartition("/")
    return fold_name(fold_name(seed, scope), leaf) if scope else \
        fold_name(seed, site)


def draw_noise(contract: dict, seed: int,
               device: torch.device | str) -> list[torch.Tensor]:
    """The artifact's noise inputs for key ``seed``, in the contract's
    order: each site's draw as the eager forward at ``seed`` makes it."""
    return [site_normal(_site_key(seed, site), site, shape, device)
            for site, shape in contract["noise"]]
