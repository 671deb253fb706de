"""Model stack of the port: the dense family (GQA, sliding-window and
qk-norm transformers), the moe family, the ssm family (Mamba2) and the
hybrid family (attention and SSM heads side by side), on PyTorch.
RMSNorm, prefill attention, the expert FFN and the SSD scan run the
hand-written Hopper kernels for CUDA tensors.

Ported so far: ``common``, ``layers``, ``attention``, ``blocks``, ``moe``,
``ssm``, ``lm`` (dense, moe, ssm and hybrid families) and ``registry``.
Still to port (ROADMAP.md): the vlm and audio families, and the training
loss."""
from .common import ModelConfig, ParamSpec

__all__ = ["ModelConfig", "ParamSpec"]
