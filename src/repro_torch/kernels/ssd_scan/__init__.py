"""Mamba2 SSD chunked scan: the port of the reference's Pallas
``ssd_scan_tpu`` as a hand-written CUDA kernel for Hopper
(``csrc/ssd_scan.cu``, two variants).  ``ref.py`` holds the plain
per-step recurrence and the plain version of the tensor-core variant's
rounding, ``ops.py`` the wrappers that launch the kernel for CUDA tensors
and the variant rule."""
from .ops import (TC_CHUNK, VARIANTS, rows_aligned, ssd_scan, ssd_scan_bhsp,
                  tc_scratch_bytes, variant, variant_of)
from .ref import ssd_scan_ref, ssd_scan_tc_ref

__all__ = ["TC_CHUNK", "VARIANTS", "rows_aligned", "ssd_scan",
           "ssd_scan_bhsp", "ssd_scan_ref", "ssd_scan_tc_ref",
           "tc_scratch_bytes", "variant", "variant_of"]
