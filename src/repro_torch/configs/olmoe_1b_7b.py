"""olmoe-1b-7b [moe] — 64 experts top-8, qk-norm.

16L d_model=2048 16H (GQA kv=16) d_ff=1024/expert vocab=50304
[arXiv:2409.02060; hf]
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304,
    norm="rmsnorm", mlp="swiglu", qk_norm=True,
    n_experts=64, top_k=8, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="olmoe-1b-7b-smoke", family="moe",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab=512, norm="rmsnorm", mlp="swiglu", qk_norm=True,
    n_experts=8, top_k=2, capacity_factor=2.0, tp_target=4,
)
