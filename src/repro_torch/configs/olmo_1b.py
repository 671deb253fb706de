"""olmo-1b [dense] — non-parametric LayerNorm, tied embeddings.

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304 [arXiv:2402.00838; hf]
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304,
    norm="layernorm_np",         # OLMo: LN without scale/bias
    mlp="swiglu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="olmo-1b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4,
    d_ff=192, vocab=512, norm="layernorm_np", mlp="swiglu",
    tie_embeddings=True, tp_target=4,
)
