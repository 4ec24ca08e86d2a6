"""PyTorch/CUDA port of the paged serving path, for one NVIDIA H100.

A package of its own beside the JAX reference (``src/repro``): it imports
``torch`` and ``numpy`` and nothing of JAX or of the reference package.
Every Pallas kernel on the ported path has a hand-written Hopper
counterpart under ``repro_torch/kernels`` with a plain PyTorch version
beside it; the wrappers in ``kernels/ops.py`` launch the kernel for CUDA
tensors and take the plain version only for CPU tensors.
"""
