"""Layers: device ms a step in operations that are neither the port's
kernels nor cuDNN's or cuBLAS's, nor CUDA's memcpy and memset: PyTorch's own
elementwise passes, dtype copies and reductions, classed by name
(``kernel_classes.json``). Moves ``train_examples_per_s``."""


def read(x):
    if x.traffic["kind"] != "train" or x.trace is None or not x.units:
        return None
    return 1e3 * x.trace.class_s("elementwise") / x.units
