"""Hand-written Hopper kernels of the eval path, each with its plain twin.

On CUDA tensors the kernels always run; a twin serves CPU tensors (and the
tests) only. There is no switch between the two.

- K1 ``ar_stack`` (CUDA C++, ``csrc/ar_stack.cu``), twin ``ar_stack_ref``
- K3 ``iaf_update`` (Triton), twin ``iaf_update_ref``
- K4 ``disc_logistic_logp`` (Triton), twin ``disc_logistic_ref``
"""

from iaf_torch.ops import ar_stack as _ar_stack_mod
from iaf_torch.ops import fused as _fused_mod
from iaf_torch.ops.ar_stack import ar_stack, ar_stack_ref  # noqa: F401
from iaf_torch.ops.fused import (  # noqa: F401
    disc_logistic_logp,
    disc_logistic_ref,
    iaf_update,
    iaf_update_ref,
)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {**_ar_stack_mod.launches, **_fused_mod.launches}


def reset_launch_counts() -> None:
    for counts in (_ar_stack_mod.launches, _fused_mod.launches):
        for name in counts:
            counts[name] = 0
