"""Model stack of the port: the dense family (GQA, sliding-window and
qk-norm transformers) and the moe family, on PyTorch.  RMSNorm, prefill
attention and the expert FFN run the hand-written Hopper kernels for
CUDA tensors.

Ported so far: ``common``, ``layers``, ``attention``, ``blocks``, ``moe``,
``lm`` (dense and moe families) and ``registry``.  Still to port
(ROADMAP.md): ``ssm``, the vlm and audio families, and the training
loss."""
from .common import ModelConfig, ParamSpec

__all__ = ["ModelConfig", "ParamSpec"]
