"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1024 ssm_state=128 vocab=50280 [arXiv:2405.21060; unverified]
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    norm="rmsnorm", tie_embeddings=True,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    ssm_conv_kernel=4, ssm_groups=1,
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=512, norm="rmsnorm", tie_embeddings=True,
    ssm_state=16, ssm_headdim=16, ssm_chunk=8, tp_target=4,
)
