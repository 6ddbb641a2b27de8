"""Port parity: config parsing and fields, AR masks, and the rule that no
module of ``iaf_torch`` imports JAX or ``iaf_tpu``."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from iaf_tpu.core import config as jconfig
from iaf_tpu.nn import masks as jmasks
from iaf_torch.core import config as tconfig
from iaf_torch.nn import masks as tmasks

PAPER = "depth=1,num_blocks=20,kl_min=0.25,learning_rate=0.002,batch_size=32"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.Config)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.Config)}
    assert jf == tf


@pytest.mark.parametrize("spec", [
    PAPER,
    "binarize=true,seed=7,dataset=mnist,kl_min=0",
    "compute_dtype=float32,kernels=pallas,ar_variant=im2col,scan_blocks=1",
])
def test_parse_matches_jax(spec):
    want = dataclasses.asdict(jconfig.Config().parse(spec))
    got = dataclasses.asdict(tconfig.Config().parse(spec))
    assert got == want


@pytest.mark.parametrize("spec,exc", [
    ("not_a_param=3", KeyError), ("depth", ValueError),
    ("binarize=maybe", ValueError), ("kernels=cuda", ValueError),
    ("ar_hidden_size=64", ValueError), ("depth_ar=0", ValueError),
])
def test_parse_errors_match_jax(spec, exc):
    with pytest.raises(exc):
        jconfig.Config().parse(spec)
    with pytest.raises(exc):
        tconfig.Config().parse(spec)


def test_jax_hps_json_loads(tmp_path):
    cfg = jconfig.Config().parse(PAPER + ",eval_k=128")
    jconfig.save_hparams(cfg, str(tmp_path))
    got = tconfig.resolve_config(str(tmp_path), "eval_k_chunk=32")
    want = cfg.parse("eval_k_chunk=32").replace(logdir=str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("h,w,n_in,n_out,zd", [
    (3, 3, 32, 160, True), (3, 3, 160, 160, False), (3, 3, 160, 32, False),
    (5, 5, 8, 16, True), (5, 5, 16, 8, False), (3, 3, 4, 8, True),
])
def test_conv_masks_bitwise(h, w, n_in, n_out, zd):
    got = tmasks.get_conv_ar_mask(h, w, n_in, n_out, zd)
    want = jmasks.get_conv_ar_mask(h, w, n_in, n_out, zd)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_merged_head_mask_bitwise():
    got = np.concatenate([tmasks.get_conv_ar_mask(3, 3, 160, 32, False)] * 2,
                         axis=-1)
    want = np.concatenate([jmasks.get_conv_ar_mask(3, 3, 160, 32, False)] * 2,
                          axis=-1)
    np.testing.assert_array_equal(got, want)
    assert tmasks.nonzero_taps(got) == ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1))


@pytest.mark.parametrize("n_in,n_out", [(4, 4), (4, 8), (8, 4), (3, 6),
                                        (32, 160), (160, 32)])
@pytest.mark.parametrize("zd", [True, False])
def test_linear_masks_bitwise(n_in, n_out, zd):
    np.testing.assert_array_equal(tmasks.get_linear_ar_mask(n_in, n_out, zd),
                                  jmasks.get_linear_ar_mask(n_in, n_out, zd))


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports without JAX
    and without the JAX package."""
    mods = []
    for root, _, files in os.walk(os.path.join(REPO, "iaf_torch")):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(mods)!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'iaf_tpu' or m.startswith('iaf_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert len(mods) >= 15
