"""Doorbell stage-copy kernel (DESIGN.md §13).

The fused data plane's hot step — dtype-normalize a doorbell's K
payloads into one packed wire image, and optionally push it into the
packet pool — as one hand-written CUDA kernel for Hopper
(``csrc/doorbell.cu``, the port of the reference's Pallas
``stage_copy_tpu``).  ``ref.py`` holds the plain PyTorch versions,
``ops.py`` the public wrappers that launch the kernel for CUDA tensors:
``stage_copy`` of a stacked ``(K, E)`` tensor, ``stage_copy_rows`` of K
separate row tensors (the main path's fused doorbell) and
``stage_copy_push`` into packet slots.
"""
from .ops import stage_copy, stage_copy_push, stage_copy_rows, uniform_rows
from .ref import stage_copy_push_ref, stage_copy_ref, stage_copy_rows_ref

__all__ = ["stage_copy", "stage_copy_push", "stage_copy_push_ref",
           "stage_copy_ref", "stage_copy_rows", "stage_copy_rows_ref",
           "uniform_rows"]
