"""whisper-tiny [audio] — encoder-decoder backbone; conv frontend STUB.

4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865 (padded to 51968)
[arXiv:2212.04356; unverified].  input_specs provides precomputed frame
embeddings (1500 frames = 30 s at 50 Hz post-conv).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    norm="layernorm", mlp="gelu", tie_embeddings=True,
    encoder_layers=4, n_audio_frames=1500,
)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, norm="layernorm", mlp="gelu",
    tie_embeddings=True, encoder_layers=2, n_audio_frames=16, tp_target=4,
)
