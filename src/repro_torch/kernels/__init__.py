"""Hand-written Hopper kernels of the port, one package each.

Each ``<name>/`` package holds ``ref.py`` (the plain PyTorch version)
and ``ops.py`` (the wrapper: the kernel for CUDA tensors, the plain
version for CPU tensors); CUDA sources live in ``repro_torch/csrc`` and
are built by :mod:`._build` at first use.
"""
