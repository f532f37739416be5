"""chatglm3-6b [arXiv:2406.12793].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
RoPE applied to half the head dims ("2d" rotary); QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope_theta=10_000.0,
    rope_fraction=0.5,
    qkv_bias=True,
    mlp_kind="swiglu",
    layer_pattern=(("attn", "dense"),),
    tie_embeddings=False,
)
