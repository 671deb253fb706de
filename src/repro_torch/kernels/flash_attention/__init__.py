"""Flash-attention kernel: the port of the reference's Pallas
``flash_attention_tpu`` as a hand-written CUDA kernel for Hopper
(``csrc/flash_attention.cu``, two variants: ``"tc"`` on the tensor cores
for bf16, ``"simt"`` on the CUDA cores).  ``ref.py`` holds the plain
PyTorch version, ``ops.py`` the wrappers (kernel layout and seq-major)
that launch the kernel for CUDA tensors."""
from .ops import (HEAD_DIMS, TC_HEAD_DIMS, flash_attention,
                  flash_attention_bhsd, tma_geometry, variant,
                  variant_of)
from .ref import flash_attention_ref

__all__ = ["HEAD_DIMS", "TC_HEAD_DIMS", "flash_attention",
           "flash_attention_bhsd", "flash_attention_ref", "tma_geometry",
           "variant", "variant_of"]
