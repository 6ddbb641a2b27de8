"""Kernels: K1 (``ar_stack``) forward in the IW eval, one call per IAF
layer a chunk over the chunk's rows (images x samples), the sum of its
bounds (``yardstick.k1_fwd``) over its device time (class ``k1``), %.
Moves ``iw_samples_per_s``."""

from portbench import reference as ref
from portbench import yardstick as y


def read(x):
    if x.traffic["kind"] != "iw_eval" or x.trace is None:
        return None
    dev_s = x.trace.class_s("k1")
    if not dev_s:
        return None
    rows = x.traffic["batch_size"] * x.traffic["k_chunk"]
    bound_ms = y.kernel_bound_ms(x.c, [y.k1_fwd(x.c, rows, False)])
    return 100.0 * bound_ms * ref.n_layers(x.c) * x.units / 1e3 / dev_s
