"""The forward kernels K1-K4 as torch ops (``iaf::ar_stack``,
``iaf::masked_conv2d``, ``iaf::iaf_update``, ``iaf::disc_logistic_logp``)
on the CPU: ``torch.library.opcheck`` (schema, fake tensors, dispatch)
on each op, each op bitwise equal to its twin, and the public wrappers'
routing: without grad through the op, under autograd through the twin
(which autograd differentiates), the same bits either way."""

import importlib

import numpy as np
import pytest
import torch

from iaf_torch import ops
from iaf_torch.nn.masks import get_conv_ar_mask, nonzero_taps

ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
mc_mod = importlib.import_module("iaf_torch.ops.masked_conv")
fused_mod = importlib.import_module("iaf_torch.ops.fused")


def _k1(g):
    masks = [get_conv_ar_mask(3, 3, 4, 8, True), get_conv_ar_mask(3, 3, 8, 8),
             get_conv_ar_mask(3, 3, 8, 8)]
    ws = [torch.randn(*m.shape, generator=g) * torch.from_numpy(m)
          for m in masks]
    bs = [torch.randn(m.shape[-1], generator=g) for m in masks]
    z, ctx = torch.randn(2, 4, 4, 4, generator=g), torch.randn(
        2, 4, 4, 8, generator=g)
    return dict(op=ar_mod.ar_stack_op, op_args=(z, ctx, ws, bs),
                twin=lambda: ops.ar_stack_ref(z, ctx, ws, bs),
                wrapper=ops.ar_stack, args=(z, ctx, ws, bs, masks),
                leaves=[z, ctx, *ws, *bs], attr=(ar_mod, "ar_stack_op"))


def _k2(g):
    taps = nonzero_taps(get_conv_ar_mask(5, 5, 4, 8))
    x, w = torch.randn(2, 4, 4, 4, generator=g), torch.randn(5, 5, 4, 8,
                                                             generator=g)
    flat = [v for tap in taps for v in tap]
    return dict(op=mc_mod.masked_conv2d_op, op_args=(x, w, flat),
                twin=lambda: ops.masked_conv2d_ref(x, w, taps),
                wrapper=ops.masked_conv2d, args=(x, w, taps), leaves=[x, w],
                attr=(mc_mod, "masked_conv2d_op"))


def _k3(g):
    a = tuple(torch.randn(2, 4, 4, 4, generator=g) for _ in range(4))
    return dict(op=fused_mod.iaf_update_op, op_args=a,
                twin=lambda: ops.iaf_update_ref(*a), wrapper=ops.iaf_update,
                args=a, leaves=list(a), attr=(fused_mod, "iaf_update_op"))


def _k4(g):
    mean = torch.randn(2, 4, 4, 3, generator=g) * 0.1
    ls = torch.tensor(-2.0)
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 4, 4, 3)).astype(np.float32)) / 256.0 - 0.5
    return dict(op=fused_mod.disc_logistic_op,
                op_args=(mean, ls, x, 1.0 / 256.0),
                twin=lambda: ops.disc_logistic_ref(mean, ls, x),
                wrapper=ops.disc_logistic_logp, args=(mean, ls, x),
                leaves=[mean, ls], attr=(fused_mod, "disc_logistic_op"))


CASES = {"ar_stack": _k1, "masked_conv2d": _k2, "iaf_update": _k3,
         "disc_logistic_logp": _k4}


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_passes_opcheck_and_equals_its_twin(name):
    case = CASES[name](torch.Generator().manual_seed(3))
    assert case["op"].name() == f"iaf::{name}"
    torch.library.opcheck(case["op"], case["op_args"])
    for got, want in zip(_flat(case["op"](*case["op_args"])),
                         _flat(case["twin"]()), strict=True):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_takes_the_op_without_grad_and_the_twin_under_autograd(
        name, monkeypatch):
    case = CASES[name](torch.Generator().manual_seed(5))
    calls = []
    op = case["op"]

    def spy(*args):
        calls.append(args)
        return op(*args)
    monkeypatch.setattr(*case["attr"], spy)
    with torch.no_grad():
        no_grad = _flat(case["wrapper"](*case["args"]))
    assert len(calls) == 1
    leaves = [t.requires_grad_() for t in case["leaves"]]
    graded = _flat(case["wrapper"](*case["args"]))
    assert len(calls) == 1, "the autograd path went through the op"
    for a, b in zip(no_grad, graded, strict=True):
        assert torch.equal(a, b.detach())
    torch.autograd.backward(graded, [torch.ones_like(t) for t in graded])
    assert all(t.grad is not None for t in leaves)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return torch.device("cuda")


DIRECT = {"ar_stack": lambda a: ar_mod._fwd(*a, save_pre=False)[0],
          "masked_conv2d": lambda a: mc_mod._fwd(
              a[0], a[1], mc_mod._pairs(a[2])),
          "iaf_update": lambda a: fused_mod._iaf_fwd(*a),
          "disc_logistic_logp": lambda a: fused_mod._dl_fwd(
              a[0], a[1].reshape(1), a[2], a[3])}


def _to(a, device):
    if torch.is_tensor(a):
        return a.to(device).contiguous()
    if isinstance(a, list):
        return [_to(t, device) for t in a]
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_launches_its_kernel_on_card(cuda, name):
    """On CUDA tensors the op is the kernel's launch: one launch in the
    count, the bits of the direct launch, also from non-contiguous
    inputs (an exported program may hand them over), and (for a wrong
    input) the kernel's own error, not a fallback to the twin."""
    case = CASES[name](torch.Generator().manual_seed(3))
    args = [_to(a, cuda) for a in case["op_args"]]
    ops.reset_launch_counts()
    got = _flat(case["op"](*args))
    assert ops.launch_counts()[name] == 1
    want = _flat(DIRECT[name](args))
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    strided = [a.transpose(1, 2).contiguous().transpose(1, 2)
               if torch.is_tensor(a) and a.dim() == 4 else a for a in args]
    assert not strided[0].is_contiguous()
    for a, b in zip(_flat(case["op"](*strided)), want, strict=True):
        assert torch.equal(a, b)
    if name in ("iaf_update", "disc_logistic_logp"):
        bad = [a.double() if torch.is_tensor(a) else a for a in args]
        with pytest.raises(TypeError, match="float32"):
            case["op"](*bad)
