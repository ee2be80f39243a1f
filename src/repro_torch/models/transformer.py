"""Decoder-only LM, dense and SSM families: the port of
``repro.models.transformer``.

The reference scans stacked per-layer params; here the layers are a
``ModuleList`` walked in Python, and the cache is a list with one dict per
layer under ``"blocks"``: (k, v, pos) for a dense block, (state, conv,
pos) for a Mamba-2 block.  Attribute names follow the reference params
tree (``embed.embedding``, ``final_norm.scale``, ``blocks.<i>.attn.wq.w``,
``blocks.<i>.mixer.A_log`` ...), which ``convert.from_jax_params`` relies
on.

Public API: ``Transformer``, ``forward``, ``init_cache``, ``decode_step``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .attention import GQA, gqa_apply, gqa_cache_init
from .layers import (Dense, Embedding, RMSNorm, SwiGLU, dense, embed, rmsnorm,
                     swiglu, unembed)
from .ssm import Mamba2, mamba2_apply, mamba2_cache_init


class DenseBlock(nn.Module):
    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, dtype)
        self.attn = GQA(cfg, dtype)
        self.norm2 = RMSNorm(cfg.d_model, dtype)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype)


def dense_block_apply(p: DenseBlock, cfg, x: torch.Tensor,
                      positions: torch.Tensor, cache: Optional[Dict] = None
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    h, new_cache = gqa_apply(p.attn, cfg, rmsnorm(p.norm1, x, cfg.norm_eps),
                             positions=positions, cache=cache)
    x = x + h
    x = x + swiglu(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps))
    return x, new_cache


class MambaBlock(nn.Module):
    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, dtype)
        self.mixer = Mamba2(cfg, dtype)


def mamba_block_apply(p: MambaBlock, cfg, x: torch.Tensor,
                      positions: torch.Tensor, cache: Optional[Dict] = None
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    h, new_cache = mamba2_apply(p.mixer, cfg, rmsnorm(p.norm, x, cfg.norm_eps),
                                cache=cache)
    return x + h, new_cache


# family -> (block parameters, block apply)
_BLOCKS = {"dense": (DenseBlock, dense_block_apply),
           "ssm": (MambaBlock, mamba_block_apply)}


class Transformer(nn.Module):
    """Parameters of a decoder-only LM (the reference's params tree)."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype)
        self.final_norm = RMSNorm(cfg.d_model, dtype)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, dtype=dtype)
        block = _BLOCKS[cfg.family][0]
        self.blocks = nn.ModuleList(block(cfg, dtype)
                                    for _ in range(cfg.n_layers))


def _backbone(cfg, model: Transformer, x: torch.Tensor,
              positions: torch.Tensor, caches: Optional[Dict] = None):
    """Embedded input -> final hidden states.  Returns (x, new_caches)."""
    apply = _BLOCKS[cfg.family][1]
    new_layers: List[Dict] = []
    for i, block in enumerate(model.blocks):
        x, nc = apply(
            block, cfg, x, positions,
            caches["blocks"][i] if caches is not None else None)
        new_layers.append(nc)
    return x, ({"blocks": new_layers} if caches is not None else None)


def _logits(cfg, model: Transformer, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(model.embed, x)
    return dense(model.lm_head, x.float())


def forward(cfg, model: Transformer, tokens: torch.Tensor, *,
            last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) fp32, aux loss).  ``last_only``
    projects only the final position, as serving prefill needs."""
    x = embed(model.embed, tokens, cfg.activation_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _backbone(cfg, model, x, positions)
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, model, x), torch.zeros((), device=x.device)


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None) -> Dict:
    """One cache per layer; ``max_len`` sizes the KV cache of a dense
    block and nothing of an SSM block."""
    if cfg.family == "ssm":
        return {"blocks": [mamba2_cache_init(cfg, batch, dtype, device)
                           for _ in range(cfg.n_layers)]}
    return {"blocks": [gqa_cache_init(cfg, batch, max_len, dtype, device)
                       for _ in range(cfg.n_layers)]}


def decode_step(cfg, model: Transformer, tokens: torch.Tensor, cache: Dict, *,
                last_only: bool = False) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, S) at the cache's position -> (logits (B, S, V), cache).
    S == 1 is a decode step and S > 1 a cached prefill.  ``last_only``
    projects only the final position (the Engine's prefill reads no other);
    the reference always projects all S."""
    x = embed(model.embed, tokens, cfg.activation_dtype)
    pos = cache["blocks"][0]["pos"]
    positions = pos + torch.arange(tokens.shape[1], device=x.device)
    x, new_caches = _backbone(cfg, model, x, positions, caches=cache)
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, model, x), new_caches
