"""Model stack of the port: the dense family (GQA, sliding-window and
qk-norm transformers), on PyTorch.  RMSNorm and prefill attention run
the hand-written Hopper kernels for CUDA tensors.

Ported so far: ``common``, ``layers``, ``attention``, ``blocks``, ``lm``
(dense family) and ``registry``.  Still to port (ROADMAP.md): ``moe``,
``ssm``, the vlm and audio families, and the training loss."""
from .common import ModelConfig, ParamSpec

__all__ = ["ModelConfig", "ParamSpec"]
