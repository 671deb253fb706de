"""Hand-written Hopper kernels of the port, one package each.

Each ``<name>/`` package holds ``ref.py`` (the plain PyTorch version)
and ``ops.py`` (the wrapper: the kernel for CUDA tensors, the plain
version for CPU tensors); CUDA sources live in ``repro_torch/csrc`` and
are built by :mod:`._build` at first use.  :func:`count_launch` is where
every wrapper counts its launches.
"""
import threading


def count_launch(fn, n: int = 1) -> None:
    """Count ``n`` launches of ``fn``'s kernel where the wrapper launches
    it: ``fn.launches``, and ``fn.launches_by_thread`` by the launching
    thread's name (``spmd_map``'s rank threads are ``spmd-rank<r>``)."""
    fn.launches += n
    by = fn.launches_by_thread
    name = threading.current_thread().name
    by[name] = by.get(name, 0) + n
