"""chameleon-34b [arXiv:2405.09818] — early-fusion VLM backbone.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
The VQ image tokenizer frontend is a STUB per assignment: ``input_specs()``
provides precomputed patch/token embeddings (frontend="embed").
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    rope_theta=10_000.0,
    mlp_kind="swiglu",
    layer_pattern=(("attn", "dense"),),
    frontend="embed",
    tie_embeddings=False,
)
