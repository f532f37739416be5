"""gemma2-2b [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000.
Alternating local (sliding window 4096) / global attention, attention
logit softcap 50, final logit softcap 30, GeGLU, scaled embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    rope_theta=10_000.0,
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_kind="geglu",
    layer_pattern=(("local", "dense"), ("attn", "dense")),
    tie_embeddings=True,
    scale_embeddings=True,
    norm_eps=1e-6,
)
