"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001 ssm_state=16
SWA everywhere except 3 global layers (first/middle/last); meta tokens
omitted (frontend-independent backbone). [arXiv:2411.13676; hf]
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    norm="rmsnorm", mlp="swiglu", tie_embeddings=True,
    sliding_window=1024, global_layers=(0, 15, 31),
    ssm_state=16, ssm_headdim=64, ssm_expand=2, ssm_chunk=128,
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=5, n_kv_heads=5,
    d_ff=128, vocab=512, head_dim=16, norm="rmsnorm", mlp="swiglu",
    tie_embeddings=True, sliding_window=8, global_layers=(0,),
    ssm_state=8, ssm_headdim=16, ssm_chunk=8, tp_target=4,
)
