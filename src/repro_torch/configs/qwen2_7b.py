"""qwen2-7b [dense] — GQA, QKV bias [arXiv:2407.10671].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    dtype="float32",
)
