"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242].

54L d_model=2560, ssm_state=64; a single shared (attn + FFN) block with
32H (kv=32) and d_ff=10240 is applied between groups of 6 Mamba2 layers
(9 applications, one weight copy) — the Zamba2 shared-block scheme.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    hybrid_attn_every=6,
    ssm=SSMConfig(state_dim=64, head_dim=64, n_groups=1, chunk=64,
                  conv_width=4, expand=2),
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    hybrid_attn_every=2,
    ssm=SSMConfig(state_dim=16, head_dim=32, n_groups=1, chunk=8,
                  conv_width=4, expand=2),
    dtype="float32",
)
