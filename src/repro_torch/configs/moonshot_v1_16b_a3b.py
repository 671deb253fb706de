"""moonshot-v1-16b-a3b [moe] — Moonlight: 64 experts top-6 + shared experts.

48L d_model=2048 16H (GQA kv=16) d_ff=1408/expert vocab=163840
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840,
    norm="rmsnorm", mlp="swiglu",
    n_experts=64, top_k=6, shared_expert_ff=2816,   # 2x expert width
    capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke", family="moe",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab=512, norm="rmsnorm", mlp="swiglu",
    n_experts=8, top_k=2, shared_expert_ff=128,
    capacity_factor=2.0, tp_target=4,
)
