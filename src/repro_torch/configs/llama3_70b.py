"""llama3-70b [arXiv:2407.21783] — the paper's own 70B evaluation model.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Not part of the assigned 40-cell grid; used by the paper-scale serving
simulations (PF-High / PF-Low) and available via --arch llama3-70b.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    mlp_kind="swiglu",
    layer_pattern=(("attn", "dense"),),
    tie_embeddings=False,
)
