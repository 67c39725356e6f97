"""PyTorch/CUDA port of the AME memory engine (``repro`` is the JAX reference).

Same module and function names as the reference; the Pallas TPU kernels are
CUDA C++ kernels for Hopper in ``csrc/``.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""
