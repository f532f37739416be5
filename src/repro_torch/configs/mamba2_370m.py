"""mamba2-370m [arXiv:2405.21060] — SSD (state-space duality), attention-free.

48L d_model=1024 vocab=50280, ssm_state=128, no FFN (pure Mamba2 blocks).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=16,               # nominal; attention-free
    num_kv_heads=16,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=(("mamba", "none"),),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    tie_embeddings=True,
    subquadratic=True,
)
