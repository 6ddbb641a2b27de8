"""The fused inference passes around the trunk convs (``ops.glue``) and the
model's route through them (``cvae.fused_route``).

On the CPU: each op passes ``torch.library.opcheck`` and equals its twin,
its fake gives the real output's shapes, dtypes and strides, the trunk
conv with its padding inside equals the padded one, the eval forward
through the fused route is bitwise the plain route at tiny bf16 configs
of several layers, the route is taken without grad and bf16 operands
only (one call of each per-layer pass a layer), and a bf16 ``elbo.pt2``
records the ops and equals the eager forward. On the card (``cuda``
marker, skipped here): each kernel against its twin run on the card at
N = 1024 and 16 at the bounds of ``chip_smoke.glue_check`` (bitwise
where the twin's operations are exact, within 2 ulp of f32 where expf
or expm1f enter, the KL sums in another order), launches per eval chunk
and none in a training step, the graphed eval chunk's bound within 4 ulp
of f32 of the plain route's, and the exported bf16 artifact against the
eager forward."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from iaf_torch import ops
from iaf_torch.core import export
from iaf_torch.core.config import Config
from iaf_torch.models import cvae
from iaf_torch.parallel import eval_step

glue = importlib.import_module("iaf_torch.ops.glue")
ROOT = Path(__file__).resolve().parents[1]

TINY = ("dataset=synthetic,image_size=8,channels=3,z_size=4,h_size=8,"
        "depth=1,num_blocks=3,depth_ar=2,ar_hidden_size=8,kl_min=0.25,"
        "compute_dtype=bfloat16")
CONFIGS = {"paper": "", "depth2": ",depth=2,num_blocks=2",
           "no_free_bits": ",kl_min=0", "k5": ",kernel_size=5",
           "dense": ",ar_kind=dense", "gate": ",flow_update=gate"}


def _inputs(g, n=2, hw=4, zs=4, hs=8, device="cpu"):
    """Raw bf16 conv outputs, f32 biases and states of one layer."""
    def r(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(
            device=device, dtype=dtype)
    pix = (n, hw, hw)
    return dict(
        h=r(*pix, hs), conv=r(*pix, hs, dtype=torch.bfloat16),
        b=r(hs, scale=0.3), up=r(*pix, 2 * zs + 2 * hs, dtype=torch.bfloat16),
        ub=r(2 * zs + 2 * hs, scale=0.3),
        down=r(*pix, 4 * zs + 2 * hs, dtype=torch.bfloat16, scale=0.5),
        db=r(4 * zs + 2 * hs, scale=0.3), eps=r(*pix, zs), z=r(*pix, zs),
        lq=r(*pix, zs), h_top=r(hs), hs=hs)


def _cases(t):
    """Per op: (op, args, twin); the conv inputs with the 3x3 convs' zero
    border, without (the deconv's) and with the 5x5 convs'."""
    h_top = t["h_top"].expand(t["h"].shape)
    cases = {
        "posterior": (glue.posterior_op, (t["down"], t["db"], t["up"],
                                          t["ub"], t["eps"]),
                      glue.posterior_ref)}
    for pad in (1, 0, 2):
        cases.update({
            f"elu_bf16_pad{pad}": (glue.elu_bf16_op, (t["h"], pad),
                                   glue.elu_bf16_ref),
            f"elu_bf16_h_top_pad{pad}": (glue.elu_bf16_op, (h_top, pad),
                                         glue.elu_bf16_ref),
            f"residual_elu_pad{pad}": (glue.residual_elu_op,
                                       (t["h"], t["conv"], t["b"], pad),
                                       glue.residual_elu_ref),
            f"residual_elu_h_top_pad{pad}": (glue.residual_elu_op,
                                             (h_top, t["conv"], t["b"], pad),
                                             glue.residual_elu_ref),
            f"up_stats_pad{pad}": (glue.up_stats_op,
                                   (t["up"], t["ub"], t["hs"], pad),
                                   glue.up_stats_ref),
            f"kl_join_pad{pad}": (glue.kl_join_op,
                                  (t["z"], t["lq"], t["down"], t["db"], pad),
                                  glue.kl_join_ref)})
    return cases


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


CASE_NAMES = sorted(_cases(_inputs(torch.Generator().manual_seed(0))))


@pytest.mark.parametrize("name", CASE_NAMES)
def test_op_passes_opcheck_and_equals_its_twin(name):
    op, args, twin = _cases(_inputs(torch.Generator().manual_seed(3)))[name]
    torch.library.opcheck(op, args)
    for got, want in zip(_flat(op(*args)), _flat(twin(*args)), strict=True):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_fake_gives_the_real_shapes_dtypes_and_strides(name):
    from torch._subclasses.fake_tensor import FakeTensorMode
    op, args, _ = _cases(_inputs(torch.Generator().manual_seed(4)))[name]
    real = _flat(op(*args))
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if torch.is_tensor(a) else a
                     for a in args]
        fake = _flat(op(*fake_args))
    assert [(f.shape, f.dtype, f.stride()) for f in fake] == [
        (r.shape, r.dtype, r.stride()) for r in real]


def test_wrappers_refuse_autograd():
    t = _inputs(torch.Generator().manual_seed(5))
    b = t["b"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.residual_elu(t["h"], t["conv"], b, 1)
    with torch.no_grad():
        ops.residual_elu(t["h"], t["conv"], b, 1)


def test_size_guard_counts_the_padded_outputs():
    """The kernels' 32-bit offsets: an input under the limit whose output
    with its border is not is refused."""
    glue._check_size("elu_bf16", (4095, 16, 16, 1024))
    with pytest.raises(ValueError, match="32-bit"):
        glue._check_size("elu_bf16", (4095, 16, 16, 1024),
                         glue._padded_shape((4095, 16, 16, 1024), 1))


@pytest.mark.parametrize("k", [3, 5])
def test_raw_conv_on_the_bordered_input_equals_the_padded_conv(k):
    cfg = Config().parse(TINY + f",kernel_size={k}")
    model = cvae.CVAE(cfg, device="cpu")
    conv = model.blocks[0].up_conv1
    with torch.no_grad():
        conv.V.normal_(generator=torch.Generator().manual_seed(k))
        conv.b.uniform_(-1, 1)
        a = torch.randn(3, 4, 4, cfg.h_size).to(torch.bfloat16)
        assert conv.same_pad == k // 2
        raw = conv.raw(glue.padded(a, conv.same_pad))
        want = conv(a, torch.bfloat16)
    assert raw.shape == (3, 4, 4, conv.b.shape[0])
    assert raw.dtype == torch.bfloat16 and raw.is_contiguous()
    assert torch.equal(raw.float() + conv.b, want)
    assert model.x_enc.same_pad is None
    with pytest.raises(ValueError, match="stride-1"):
        model.x_enc.raw(a)


def _model(hp, seed=0, device="cpu"):
    cfg = Config().parse(hp)
    hw = cfg.image_size
    x = np.random.RandomState(seed).randint(0, 256, (4, hw, hw, 3)).astype(
        np.uint8)
    return cfg, cvae.init_params(cfg, x, rng=seed, device=device), x


@pytest.fixture
def plain(monkeypatch):
    """Runs ``fn`` with the fused route off: the plain passes."""
    def run(fn):
        with monkeypatch.context() as m:
            m.setattr(cvae, "fused_route", lambda model, dtype: False)
            return fn()
    return run


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_fused_route_is_bitwise_the_plain_route(name, mode, plain):
    cfg, model, x = _model(TINY + CONFIGS[name])

    def fwd():
        with torch.inference_mode():
            return cvae.cvae_forward(cfg, model, x, rng=7, mode=mode, k=3)
    with torch.inference_mode():
        assert cvae.fused_route(model, torch.bfloat16)
    fused, want = fwd(), plain(fwd)
    for field, got, ref in zip(fused._fields, fused, want, strict=True):
        assert torch.equal(got, ref), field


def _spy(monkeypatch):
    """Counts calls of each glue op (the CPU launches no kernel)."""
    calls = dict.fromkeys(glue.launches, 0)
    for name in calls:
        attr = f"{name}_op"
        op = getattr(glue, attr)

        def spy(*args, _op=op, _name=name):
            calls[_name] += 1
            return _op(*args)
        monkeypatch.setattr(glue, attr, spy)
    return calls


def test_route_runs_one_pass_a_layer_without_grad_and_none_under_autograd(
        monkeypatch):
    cfg, model, x = _model(TINY)
    layers = cfg.num_blocks * cfg.depth
    calls = _spy(monkeypatch)
    with torch.no_grad():
        cvae.cvae_forward(cfg, model, x, rng=1, mode="eval", k=2)
    assert calls == {"elu_bf16": 2, "residual_elu": 2 * layers,
                     "up_stats": layers, "posterior": layers,
                     "kl_join": layers}
    calls.update(dict.fromkeys(calls, 0))
    out = cvae.cvae_forward(cfg, model, x, rng=1, mode="train")
    out.loss.backward()
    assert sum(calls.values()) == 0
    assert not cvae.fused_route(model, torch.bfloat16)
    with torch.no_grad():
        assert not cvae.fused_route(model, None)
        cvae.cvae_forward(cfg.replace(compute_dtype="float32"), model, x,
                          rng=1, mode="eval")
    assert sum(calls.values()) == 0


def test_bf16_export_records_the_passes_and_equals_eager(tmp_path):
    cfg, model, x = _model(TINY.replace("num_blocks=3", "num_blocks=2")
                           + ",eval_batch_size=2")
    paths = export.export_artifacts(cfg, model, str(tmp_path),
                                    num_samples=2, k=2)
    fn = export.load_exported(paths["elbo"])
    found = {}
    for node in fn.program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith(
                "iaf."):
            found[str(node.target)] = found.get(str(node.target), 0) + 1
    assert found == {"iaf.elu_bf16.default": 2,
                     "iaf.residual_elu.default": 4,
                     "iaf.up_stats.default": 2, "iaf.posterior.default": 2,
                     "iaf.kl_join.default": 2, "iaf.ar_stack.default": 2,
                     "iaf.iaf_update.default": 2,
                     "iaf.disc_logistic_logp.default": 1}
    got = fn(torch.from_numpy(x[:2]), *export.draw_noise(fn.contract, 5,
                                                         "cpu"))
    with torch.inference_mode():
        want = cvae.apply_fn(cfg, model, 5, x[:2], mode="eval", k=2)
    assert torch.equal(got, want.elbo_nats)


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return torch.device("cuda")


def _glue_check():
    """``chip_smoke.glue_check``, the bounds a pass is held to its twin
    at on the card (the smoke test's phase 3(b) holds them too)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("chip_smoke").glue_check


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 16])
def test_passes_against_their_twins_on_card(cuda, n):
    """Paper widths (z 32, h 160, 16x16), with no border, the 3x3 convs'
    and the 5x5 convs': the residual h' and the context bitwise; every
    bf16 output within 1 bf16 step (ELU's 2 ulp of f32 before rounding),
    the border zero; z and log q within 4 ulp of their largest term; the
    KL sums within the terms' tolerances and f32 summation order
    (``chip_smoke.glue_check``); two calls bitwise."""
    glue_check = _glue_check()
    t = _inputs(torch.Generator().manual_seed(n), n=n, hw=16, zs=32,
                hs=160, device=cuda)
    ops.reset_launch_counts()
    for name, (op, args, twin) in _cases(t).items():
        got, want = _flat(op(*args)), _flat(twin(*args))
        differ = glue_check(op._schema.name.split("::")[1], args, got, want)
        print(f"[glue] {name} n={n}: elements apart from the twin's bits, "
              f"per output {differ}")
        for a, b in zip(_flat(op(*args)), got, strict=True):
            assert torch.equal(a, b), name
    counts = ops.launch_counts()
    assert counts["elu_bf16"] == 12 and counts["residual_elu"] == 12
    assert counts["up_stats"] == counts["kl_join"] == 6
    assert counts["posterior"] == 2
    with pytest.raises(TypeError, match="bfloat16"):
        glue.up_stats_op(t["up"].float(), t["ub"], 160, 1)


PAPER = ("dataset=synthetic,image_size=32,channels=3,z_size=32,h_size=160,"
         "depth=1,num_blocks=20,depth_ar=2,kl_min=0.25,"
         "compute_dtype=bfloat16")


@pytest.fixture(scope="module")
def paper_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return _model(PAPER, seed=11, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1024, 16])
def test_graphed_chunk_within_4_ulp_of_the_plain_route(paper_model, plain,
                                                       k):
    """One image, k rows a chunk (N = 1024 and 16): the graphed eval's
    bound through the fused route (every pass once a layer a replay)
    against the eager plain route's, within 4 ulp of f32 (the KL sums are
    taken in another order; an H100 read 0 here, and 1 ulp for 1 of 16
    images of a 1024-row chunk in ``chip_smoke.glue_route_phase``); two
    replays bitwise."""
    cfg, model, x = paper_model
    cfg = cfg.replace(eval_k_chunk=k)
    step = eval_step.make_graphed_eval_step(cfg, "cuda", k=k)
    for _ in range(2):              # warm-up, then capture and replay
        step(model, 3, x[:1])
    ops.reset_launch_counts()
    got = step(model, 3, x[:1])
    counts = ops.launch_counts()
    assert torch.equal(got, step(model, 3, x[:1]))
    step.close()
    layers = cfg.num_blocks
    assert counts["residual_elu"] == 2 * layers and counts["elu_bf16"] == 2
    assert all(counts[p] == layers for p in ("up_stats", "posterior",
                                             "kl_join"))
    want = plain(lambda: eval_step.make_eval_step(cfg, "cuda", k=k)(
        model, 3, x[:1]))
    ulp = torch.finfo(torch.float32).eps * want.abs()
    print(f"[glue] k={k} nll fused {got.tolist()} plain {want.tolist()} "
          f"gap {float((got - want).abs().max()):.4g} nats")
    assert bool(((got - want).abs() <= 4 * ulp).all())


@pytest.mark.cuda
def test_training_step_launches_no_pass(paper_model):
    cfg, model, x = paper_model
    ops.reset_launch_counts()
    out = cvae.cvae_forward(cfg, model, x[:2], rng=1, mode="train")
    out.loss.backward()
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ar_stack"] == cfg.num_blocks
    assert all(counts[p] == 0 for p in glue.launches)


@pytest.mark.cuda
def test_bf16_export_equals_eager_on_card(cuda, tmp_path):
    cfg, model, x = _model(TINY + ",eval_batch_size=2", device=cuda)
    paths = export.export_artifacts(cfg, model, str(tmp_path),
                                    num_samples=2, k=4)
    fn = export.load_exported(paths["elbo"])
    xs = torch.from_numpy(x[:2]).to(cuda)
    ops.reset_launch_counts()
    got = fn(xs, *export.draw_noise(fn.contract, 5, cuda))
    assert ops.launch_counts()["kl_join"] == cfg.num_blocks
    with torch.inference_mode():
        want = cvae.apply_fn(cfg, model, 5, xs, mode="eval", k=4)
    assert torch.equal(got, want.elbo_nats)
