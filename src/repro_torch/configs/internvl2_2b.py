"""internvl2-2b [vlm] — InternViT (stub) + InternLM2 backbone
[arXiv:2404.16821].

LM: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The ViT
frontend is a stub: input_specs provides precomputed patch embeddings
(B, 256, 1024); the projector MLP is part of the model.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    n_vision_tokens=256,
    d_vision=1024,
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    n_vision_tokens=8,
    d_vision=32,
    dtype="float32",
)
