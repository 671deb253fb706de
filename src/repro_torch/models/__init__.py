"""Model stack of the port: the dense family (GQA, sliding-window and
qk-norm transformers), the moe family, the ssm family (Mamba2), the
hybrid family (attention and SSM heads side by side), the vlm family
(gated cross-attention to image embeddings) and the audio family (an
encoder-decoder with cross-attention), on PyTorch.  RMSNorm, prefill
attention, the expert FFN and the SSD scan run the hand-written Hopper
kernels for CUDA tensors.

Ported: ``common``, ``layers``, ``attention``, ``blocks``, ``moe``,
``ssm``, ``lm`` (every family, forward and the training loss) and
``registry``."""
from .common import ModelConfig, ParamSpec

__all__ = ["ModelConfig", "ParamSpec"]
