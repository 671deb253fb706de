"""Doorbell stage-copy kernel (DESIGN.md §13).

The fused data plane's hot step — dtype-normalize a doorbell's K
payloads into one packed wire image, and optionally push it into the
packet pool — as one hand-written CUDA kernel for Hopper
(``csrc/doorbell.cu``, the port of the reference's Pallas
``stage_copy_tpu``).  ``ref.py`` holds the plain PyTorch versions,
``ops.py`` the public wrappers that launch the kernel for CUDA tensors.
"""
from .ops import stage_copy, stage_copy_push
from .ref import stage_copy_push_ref, stage_copy_ref

__all__ = ["stage_copy", "stage_copy_push", "stage_copy_push_ref",
           "stage_copy_ref"]
