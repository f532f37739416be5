"""deepseek-v2-lite-16b [arXiv:2405.04434].

27L d_model=2048 16H d_ff=1408(expert) vocab=102400, MLA kv_lora=512,
MoE 64 routed top-6 + 2 shared experts; first layer dense (d_ff=10944).

NOTE: the assignment header says "MoE 64e top-6" while its note says
"2 shared+160 routed"; 160 routed belongs to full V2 — we follow the
primary spec (64 routed, matching the public V2-Lite config).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,            # unused by MLA; kept for bookkeeping
    d_ff=1408,
    vocab_size=102400,
    rope_theta=10_000.0,
    mlp_kind="swiglu",
    layer_pattern=(("mla", "moe"),),
    first_k_dense=1,
    first_dense_d_ff=10944,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, d_ff_shared=1408),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128, q_lora_rank=None),
    tie_embeddings=False,
)
