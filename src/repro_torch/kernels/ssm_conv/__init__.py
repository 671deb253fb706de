"""The SSM mixer's conv stage: the causal depthwise conv, SiLU and the dt
softplus as one hand-written CUDA kernel for Hopper
(``csrc/ssm_conv.cu``).  It replaces no TPU kernel (the reference's stage
is plain ``jnp``).  ``ref.py`` holds the plain PyTorch version, ``ops.py``
the wrapper that launches the kernel for CUDA tensors."""
from .ops import CONV_WIDTH, row_stride, ssm_conv
from .ref import causal_conv, softplus_dt, ssm_conv_ref

__all__ = ["CONV_WIDTH", "causal_conv", "row_stride", "softplus_dt",
           "ssm_conv", "ssm_conv_ref"]
