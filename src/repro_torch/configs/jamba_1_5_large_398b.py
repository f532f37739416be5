"""jamba-1.5-large-398b [arXiv:2403.19887] — hybrid Mamba+attention, MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Jamba block = 8 layers with attention:mamba = 1:7 (attention at block
index 3) and MoE FFN every other layer.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

_BLOCK = (
    ("mamba", "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("attn", "moe"),
    ("mamba", "dense"), ("mamba", "moe"),
    ("mamba", "dense"), ("mamba", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,                  # 9 repeats of the 8-layer Jamba block
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    rope_theta=10_000.0,            # attention layers in Jamba use no RoPE;
                                    # kept harmless (see models.attention)
    mlp_kind="swiglu",
    layer_pattern=_BLOCK,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    tie_embeddings=False,
    subquadratic=True,              # 1:7 hybrid: run long_500k
)
