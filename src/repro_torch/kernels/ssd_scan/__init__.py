"""Mamba2 SSD chunked scan: the port of the reference's Pallas
``ssd_scan_tpu`` as a hand-written CUDA kernel for Hopper
(``csrc/ssd_scan.cu``).  ``ref.py`` holds the plain per-step recurrence,
``ops.py`` the wrappers that launch the kernel for CUDA tensors."""
from .ops import ssd_scan, ssd_scan_bhsp
from .ref import ssd_scan_ref

__all__ = ["ssd_scan", "ssd_scan_bhsp", "ssd_scan_ref"]
