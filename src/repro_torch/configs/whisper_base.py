"""whisper-base [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].

6L encoder + 6L decoder, d_model=512 8H, d_ff=2048, vocab=51865.  The conv
frontend is a stub: input_specs provides precomputed frame embeddings
(B, 1500, 512).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    n_encoder_layers=6,
    encoder_seq=1500,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    n_encoder_layers=2,
    encoder_seq=32,
    tie_embeddings=True,
    dtype="float32",
)
