"""Adamax + Polyak: 10 steps of the port's ``apply_updates`` (K5's twin on
the CPU) against ``iaf_tpu.optim.apply_updates`` on the same numpy params
and gradients, f32, with and without bias correction and clipping
(rtol 1e-6: the same operations in the same order, only the
bias-correction power and the clip norm's reduction order may differ by
an ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iaf_tpu import optim as joptim
from iaf_torch import ops, optim

SHAPES = {"conv.V": (8, 4, 3, 3), "conv.b": (8,), "scalar": ()}
HYPER = dict(lr=0.002, beta1=0.9, beta2=0.999, eps=1e-8, polyak_decay=0.999)


def _problem(seed=0, steps=10):
    rs = np.random.RandomState(seed)
    params = {k: np.asarray(rs.randn(*s), np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: np.asarray(rs.randn(*s) * 10.0 ** rs.randint(-3, 2),
                            np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("bias_correction,grad_clip",
                         [(False, 0.0), (True, 0.0), (False, 1.0),
                          (True, 0.5)])
def test_ten_steps_match_jax(bias_correction, grad_clip):
    params, grads = _problem()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = joptim.init_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = optim.init_state(tp)
    for g in grads:
        jp, jstate = joptim.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate,
            bias_correction=bias_correction, grad_clip=grad_clip, **HYPER)
        tp, tstate = optim.apply_updates(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate,
            bias_correction=bias_correction, grad_clip=grad_clip, **HYPER)
    assert int(tstate.step) == int(jstate.step) == len(grads)
    for k in params:
        for got, want in ((tp[k], jp[k]), (tstate.m[k], jstate.m[k]),
                          (tstate.u[k], jstate.u[k]),
                          (tstate.ema[k], jstate.ema[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_ema_is_a_copy_and_none_grad_is_zero():
    params, grads = _problem(seed=1, steps=3)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = optim.init_state(tp)
    for k in tp:
        assert state.ema[k].data_ptr() != tp[k].data_ptr()
    with_zero = {k: torch.from_numpy(v) for k, v in grads[0].items()}
    with_none = dict(with_zero, scalar=None)
    with_zero["scalar"] = torch.zeros(())
    a = {k: v.clone() for k, v in tp.items()}
    b = {k: v.clone() for k, v in tp.items()}
    _, sa = optim.apply_updates(a, with_zero, optim.init_state(a), **HYPER)
    _, sb = optim.apply_updates(b, with_none, optim.init_state(b), **HYPER)
    for k in tp:
        assert torch.equal(a[k], b[k]) and torch.equal(sa.ema[k], sb.ema[k])
    assert torch.equal(a["scalar"], tp["scalar"])   # zero grad: no move


def test_k5_wrapper_runs_twin_per_leaf_on_cpu():
    params, grads = _problem(seed=2, steps=1)
    names = list(params)
    p = [torch.from_numpy(params[k].copy()) for k in names]
    g = [torch.from_numpy(grads[0][k]) for k in names]
    m, u = [torch.rand_like(t) for t in p], [torch.rand_like(t) for t in p]
    e = [t.clone() for t in p]
    want = [ops.adamax_polyak_ref(*leaf, torch.tensor(0.01), beta1=0.9,
                                  beta2=0.999, eps=1e-8, polyak_decay=0.99)
            for leaf in zip(p, g, m, u, e)]
    ops.reset_launch_counts()
    ops.adamax_polyak(p, g, m, u, e, torch.tensor(0.01), beta1=0.9,
                      beta2=0.999, eps=1e-8, polyak_decay=0.99)
    assert ops.launch_counts()["adamax_polyak"] == 0
    for i, w in enumerate(want):
        for got, ref in zip((p[i], m[i], u[i], e[i]), w):
            assert torch.equal(got, ref)
