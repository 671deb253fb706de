"""command-r-plus-104b [dense] — GQA kv=8, no-bias, parallel attn/FFN block.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000, head_dim=128,
    norm="layernorm",            # Cohere uses (bias-free) LayerNorm
    mlp="swiglu", parallel_block=True, tie_embeddings=True,
    rope_theta=75_000_000.0,
)

SMOKE = ModelConfig(
    name="command-r-plus-104b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=16,
    norm="layernorm", mlp="swiglu", parallel_block=True,
    tie_embeddings=True, tp_target=4,
)
