"""Hopper kernels of the port (CUDA C++ in ``repro_torch/csrc``), their
wrappers and their plain PyTorch versions."""
