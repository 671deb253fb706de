"""minitron-8b [dense] — pruned Nemotron: squared-ReLU MLP, GQA kv=8.

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000 [arXiv:2407.14679; hf]
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000,
    norm="layernorm",            # Nemotron uses LayerNorm1p (~LN)
    mlp="relu2",
)

SMOKE = ModelConfig(
    name="minitron-8b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=8, n_kv_heads=2,
    d_ff=192, vocab=512, head_dim=12, norm="layernorm", mlp="relu2",
    tp_target=4,
)
