"""MoE grouped matmul: the port of the reference's Pallas ``moe_gmm_tpu``
as a hand-written CUDA kernel for Hopper (``csrc/moe_gmm.cu``).
``ref.py`` holds the plain PyTorch version, ``ops.py`` the wrapper that
launches the kernel for CUDA tensors."""
from .ops import moe_gmm, variant
from .ref import moe_gmm_ref

__all__ = ["moe_gmm", "moe_gmm_ref", "variant"]
