"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048, attention-free, vocab=50280, ssm_state=128.
Mamba-2 1.3b: expand=2 → d_inner=4096, head_dim=64 → 64 SSD heads.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,            # d_inner / ssm head_dim
    n_kv_heads=64,
    d_ff=0,                # attn-free, no FFN (mixer only)
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, n_groups=1, chunk=64,
                  conv_width=4, expand=2),
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=256,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=16, head_dim=32, n_groups=1, chunk=8,
                  conv_width=4, expand=2),
    dtype="float32",
)
