"""gemma-7b [arXiv:2403.08295].

28L d_model=3072 16H (kv=16, head_dim=256) d_ff=24576 vocab=256000, GeGLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    rope_theta=10_000.0,
    mlp_kind="geglu",
    layer_pattern=(("attn", "dense"),),
    tie_embeddings=True,
    scale_embeddings=True,
    norm_eps=1e-6,
)
