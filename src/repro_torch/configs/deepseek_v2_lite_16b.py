"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434].

27L d_model=2048 16H, MoE 64e top-6 with d_expert=1408, vocab=102400;
v2-lite has no q compression; first layer dense (d_ff=10944).
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    moe=MoEConfig(n_experts=64, n_shared_experts=2, top_k=6,
                  d_expert=1408, capacity_factor=1.25,
                  inference_capacity_factor=2.0, n_dense_layers=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    moe=MoEConfig(n_experts=8, n_shared_experts=2, top_k=2, d_expert=32,
                  n_dense_layers=1, capacity_factor=8.0),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16),
    dtype="float32",
)
