"""Flash-attention kernel: the port of the reference's Pallas
``flash_attention_tpu`` as a hand-written CUDA kernel for Hopper
(``csrc/flash_attention.cu``).  ``ref.py`` holds the plain PyTorch
version, ``ops.py`` the wrappers (kernel layout and seq-major) that
launch the kernel for CUDA tensors."""
from .ops import HEAD_DIMS, flash_attention, flash_attention_bhsd
from .ref import flash_attention_ref

__all__ = ["HEAD_DIMS", "flash_attention", "flash_attention_bhsd",
           "flash_attention_ref"]
