"""RMSNorm kernel: the port of the reference's Pallas ``rmsnorm_tpu`` as
a hand-written CUDA kernel for Hopper (``csrc/rmsnorm.cu``).  ``ref.py``
holds the plain PyTorch version, ``ops.py`` the wrapper that launches the
kernel for CUDA tensors."""
from .ops import rmsnorm
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_ref"]
