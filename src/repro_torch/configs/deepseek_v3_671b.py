"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437].

61L d_model=7168 128H, MoE 256e top-8 with d_expert=2048, vocab=129280,
MLA kv_lora=512 q_lora=1536 rope=64 nope=128 v=128; first 3 layers dense.
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,             # dense-layer FFN width
    vocab_size=129280,
    moe=MoEConfig(n_experts=256, n_shared_experts=1, top_k=8,
                  d_expert=2048, capacity_factor=1.25,
                  inference_capacity_factor=2.0, n_dense_layers=3),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    mtp_depth=1,
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    moe=MoEConfig(n_experts=8, n_shared_experts=1, top_k=2, d_expert=32,
                  n_dense_layers=1, capacity_factor=8.0),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=24, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16),
    mtp_depth=1,
    dtype="float32",
)
