"""PyTorch/CUDA port of ``iaf_tpu`` for NVIDIA Hopper (H100): same config,
params and numbers, with the Pallas kernels rewritten as CUDA C++/Triton."""
