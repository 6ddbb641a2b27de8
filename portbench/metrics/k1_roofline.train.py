"""Kernels: K1 (``ar_stack``) forward and backward in the training step,
the sum of their bounds (``yardstick.k1_fwd`` with the pre-activations
and ``k1_bwd`` at the step's batch, one call each per IAF layer a step)
over their device time, %. The device time is classes ``k1`` and ``k2``:
K1's backward runs K2's tensor-core conv kernels through their C
entries, and in a configuration whose AR nets take K1 nothing else
launches them. Moves ``train_examples_per_s``."""

from portbench import reference as ref
from portbench import yardstick as y


def read(x):
    if x.traffic["kind"] != "train" or x.trace is None:
        return None
    dev_s = x.trace.class_s("k1", "k2")
    if not x.trace.class_s("k1") or not dev_s:
        return None
    b = x.traffic["batch_size"]
    bound_ms = y.kernel_bound_ms(x.c, [y.k1_fwd(x.c, b, True),
                                       y.k1_bwd(x.c, b)])
    total = bound_ms * ref.n_layers(x.c) * x.units / 1e3
    return 100.0 * total / dev_s
