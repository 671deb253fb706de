"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th.

100L (80 self + 20 gated cross) d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
Frontend STUB: input_specs provides precomputed patch embeddings.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256,
    norm="rmsnorm", mlp="swiglu",
    cross_attn_every=5, n_image_tokens=1600,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-90b-smoke", family="vlm",
    n_layers=4, d_model=96, n_heads=4, n_kv_heads=2,
    d_ff=192, vocab=512, head_dim=24, norm="rmsnorm", mlp="swiglu",
    cross_attn_every=2, n_image_tokens=8, tp_target=4,
)
