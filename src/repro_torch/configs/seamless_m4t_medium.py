"""seamless-m4t-medium [arXiv:2308.11596] — encoder-decoder, multimodal.

12L (decoder; + 12L encoder) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
The speech frontend is a STUB per assignment: ``input_specs()`` provides
precomputed frame embeddings for the encoder (frontend="embed").  The text
decoder length is seq_len * dec_len_ratio.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    rope_theta=10_000.0,
    mlp_kind="gelu",
    layer_pattern=(("attn", "dense"),),
    encdec=True,
    num_encoder_layers=12,
    dec_len_ratio=0.125,
    frontend="embed",
    tie_embeddings=True,
)
