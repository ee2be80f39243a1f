"""qwen2.5-14b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-14B].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke",
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
