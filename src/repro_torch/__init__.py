"""PyTorch/CUDA port of the serving paths, the training path and the HPC
benchmarks, for one NVIDIA H100.

A package of its own beside the JAX reference (``src/repro``): it imports
``torch`` and ``numpy`` and nothing of JAX or of the reference package.
Every Pallas kernel on the ported paths has a hand-written Hopper
counterpart under ``repro_torch/kernels`` with a plain PyTorch version
beside it; the wrappers in ``kernels/ops.py`` launch the kernel for CUDA
tensors and take the plain version only for CPU tensors.  The training
path runs the plain versions on the card as well: no kernel has a
backward.
"""
