"""Whisper-style encoder-decoder: the port of ``repro.models.encdec``.

The audio conv frontend is a stub, as in the reference: ``encode`` takes
precomputed frame embeddings (B, T_enc, d).  The encoder runs
bidirectional self-attention (on the ``pallas`` route the flash kernel,
non-causal), the decoder causal self-attention over its GQA cache (flash
for a fresh-cache prefill, decode attention for every step) and then
cross-attention over the encoder output (always the plain chunked route,
its k and v projected from ``enc_out`` anew in every call, as in the
reference).  Blocks are pre-LayerNorm with a GELU MLP.  Both stacks add
sinusoids to their input and, as the reference does, also apply rope in
self-attention.

The decoder's cache is a list of per-layer GQA caches (k, v, pos); the
start position is layer 0's ``pos``.  ``decode(..., last_only=True)``
projects only the final position, as the Engine's prefill reads no other
(the reference projects all S).  The sinusoid rows are computed at the
positions that need them, with the reference table's formula, instead of
indexing a 2^15-row table.  ``loss_fn`` is the decoder's cross-entropy
over every position (training projects them all); under grad mode each
encoder and decoder block runs under ``layers.remat`` when ``cfg.remat``,
the reference's checkpointed scan bodies.  Attribute names are the reference params
tree's (``frontend_proj.w``, ``enc_blocks.<i>.attn.wq.w``,
``dec_blocks.<i>.cross_attn.wk.w``, ``dec_norm.bias`` ...).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .attention import GQA, gqa_apply, gqa_cache_init
from .layers import (Dense, Embedding, GeluMLP, LayerNorm, cross_entropy,
                     dense, embed, gelu_mlp, layernorm, remat, unembed)


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The reference's ``_sinusoid`` table at rows ``positions`` (S,):
    (S, d) fp32, sines then cosines of pos / 10000^(2i / d)."""
    pos = positions.to(torch.float32)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncBlock(nn.Module):
    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(cfg.d_model, dtype)
        self.attn = GQA(cfg, dtype)
        self.norm2 = LayerNorm(cfg.d_model, dtype)
        self.mlp = GeluMLP(cfg.d_model, cfg.d_ff, dtype)


def enc_block_apply(p: EncBlock, cfg, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    h, _ = gqa_apply(p.attn, cfg, layernorm(p.norm1, x, cfg.norm_eps),
                     positions=positions, causal=False)
    x = x + h
    return x + gelu_mlp(p.mlp, layernorm(p.norm2, x, cfg.norm_eps))


class DecBlock(nn.Module):
    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(cfg.d_model, dtype)
        self.self_attn = GQA(cfg, dtype)
        self.norm2 = LayerNorm(cfg.d_model, dtype)
        self.cross_attn = GQA(cfg, dtype)
        self.norm3 = LayerNorm(cfg.d_model, dtype)
        self.mlp = GeluMLP(cfg.d_model, cfg.d_ff, dtype)


def dec_block_apply(p: DecBlock, cfg, x: torch.Tensor, enc_out: torch.Tensor,
                    positions: torch.Tensor, cache: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    h, new_cache = gqa_apply(p.self_attn, cfg,
                             layernorm(p.norm1, x, cfg.norm_eps),
                             positions=positions, causal=True, cache=cache)
    x = x + h
    h, _ = gqa_apply(p.cross_attn, cfg, layernorm(p.norm2, x, cfg.norm_eps),
                     positions=positions, kv_input=enc_out)
    x = x + h
    return x + gelu_mlp(p.mlp, layernorm(p.norm3, x, cfg.norm_eps)), \
        new_cache


class EncDec(nn.Module):
    """Parameters of the encoder-decoder (the reference's params tree)."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = cfg.d_model
        self.frontend_proj = Dense(d, d, dtype=dtype)
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, dtype)
            for _ in range(cfg.n_encoder_layers or cfg.n_layers))
        self.enc_norm = LayerNorm(d, dtype)
        self.embed = Embedding(cfg.vocab_size, d, dtype)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, dtype)
                                        for _ in range(cfg.n_layers))
        self.dec_norm = LayerNorm(d, dtype)


def encode(cfg, model: EncDec, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T_enc, d_model), precomputed frame embeddings (the stub
    frontend) -> the encoder output (B, T_enc, d_model) in the activation
    dtype."""
    x = dense(model.frontend_proj, frames.to(cfg.activation_dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    x = x + sinusoid(positions, cfg.d_model).to(x.dtype)[None]
    for block in model.enc_blocks:
        x = remat(cfg, enc_block_apply, block, cfg, x, positions)
    return layernorm(model.enc_norm, x, cfg.norm_eps)


def decode(cfg, model: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor,
           caches: Optional[List[Dict]] = None, *, last_only: bool = False
           ) -> Tuple[torch.Tensor, Optional[List[Dict]]]:
    """tokens (B, S) -> (logits (B, S, V) fp32, new caches).  With
    ``caches`` the tokens start at layer 0's ``pos``; ``last_only``
    projects only the final position.  The unembed is the tied
    embedding."""
    x = embed(model.embed, tokens, cfg.activation_dtype)
    pos0 = caches[0]["pos"] if caches is not None else 0
    positions = pos0 + torch.arange(tokens.shape[1], device=x.device)
    x = x + sinusoid(positions, cfg.d_model).to(x.dtype)[None]
    new_caches = []
    for i, block in enumerate(model.dec_blocks):
        if caches is None:
            x, nc = remat(cfg, dec_block_apply, block, cfg, x, enc_out,
                          positions)
        else:
            x, nc = dec_block_apply(block, cfg, x, enc_out, positions,
                                    caches[i])
        new_caches.append(nc)
    if last_only:
        x = x[:, -1:]
    x = layernorm(model.dec_norm, x, cfg.norm_eps)
    return unembed(model.embed, x), \
        (new_caches if caches is not None else None)


def forward(cfg, model: EncDec, batch: Dict, *, last_only: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: dict(frames, tokens) -> (logits, aux 0)."""
    enc_out = encode(cfg, model, batch["frames"])
    logits, _ = decode(cfg, model, batch["tokens"], enc_out,
                       last_only=last_only)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(cfg, model: EncDec, batch: Dict) -> torch.Tensor:
    """batch: dict(frames, tokens, labels) -> the decoder's mean
    cross-entropy over all positions."""
    logits, _ = forward(cfg, model, batch)
    return cross_entropy(logits, batch["labels"])


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None) -> List[Dict]:
    """One GQA cache (k, v, pos) per decoder layer."""
    return [gqa_cache_init(cfg, batch, max_len, dtype, device)
            for _ in range(cfg.n_layers)]


def decode_step(cfg, model: EncDec, tokens: torch.Tensor,
                enc_out: torch.Tensor, caches: List[Dict], *,
                last_only: bool = False):
    return decode(cfg, model, tokens, enc_out, caches, last_only=last_only)
