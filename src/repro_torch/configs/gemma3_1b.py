"""gemma3-1b [dense] — 5:1 local:global SWA, 128k context, qk-norm, geglu.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 head_dim=256
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab=262144, head_dim=256,
    norm="rmsnorm", mlp="geglu", tie_embeddings=True, qk_norm=True,
    sliding_window=512, swa_every_nth_global=6,   # 5 local : 1 global
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="gemma3-1b-smoke", family="dense",
    n_layers=3, d_model=96, n_heads=2, n_kv_heads=1,
    d_ff=192, vocab=512, head_dim=32, norm="rmsnorm", mlp="geglu",
    tie_embeddings=True, qk_norm=True, sliding_window=8,
    swa_every_nth_global=3, tp_target=4,
)
