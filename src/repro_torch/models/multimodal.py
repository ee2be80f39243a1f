"""InternVL2-style VLM: the port of ``repro.models.multimodal``.

The ViT frontend is a stub, as in the reference: ``project`` takes
precomputed patch embeddings (B, n_vision_tokens, d_vision).  The model is
the dense ``Transformer`` plus the projector MLP (the InternVL "mlp1"
bridge: LayerNorm over d_vision, biased fc1, tanh GELU, biased fc2), so
its state-dict names are the reference tree's flattened.  The backbone is
``models.transformer`` with the projected patches as prefix embeddings;
the cache and decode step are the dense family's, as in the reference
(serving is text-only: no decode path reads patches).  ``loss_fn`` is
the backbone's with the projected patches as the prefix, whose positions
carry no labels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import transformer
from .layers import Dense, LayerNorm, dense, gelu, layernorm


class Projector(nn.Module):
    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = LayerNorm(cfg.d_vision, dtype)
        self.fc1 = Dense(cfg.d_vision, cfg.d_model, bias=True, dtype=dtype)
        self.fc2 = Dense(cfg.d_model, cfg.d_model, bias=True, dtype=dtype)


class VLM(transformer.Transformer):
    """The dense backbone's parameters and the ``projector``."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__(cfg, dtype)
        self.projector = Projector(cfg, dtype)


def project(cfg, model: VLM, patches: torch.Tensor) -> torch.Tensor:
    """patches (B, P, d_vision) -> prefix embeddings (B, P, d_model)."""
    p = model.projector
    x = layernorm(p.norm, patches.to(cfg.activation_dtype))
    return dense(p.fc2, gelu(dense(p.fc1, x)))


def forward(cfg, model: VLM, batch: Dict, *, last_only: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: dict(patches (B, P, d_vision), tokens (B, S)) -> (logits over
    P + S positions, or the last with ``last_only``, aux)."""
    return transformer.forward(cfg, model, batch["tokens"],
                               input_embeds=project(cfg, model,
                                                    batch["patches"]),
                               last_only=last_only)


def loss_fn(cfg, model: VLM, batch: Dict) -> torch.Tensor:
    """batch: dict(patches, tokens, labels) -> scalar loss."""
    return transformer.loss_fn(
        cfg, model, {"tokens": batch["tokens"], "labels": batch["labels"],
                     "input_embeds": project(cfg, model, batch["patches"])})


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None,
               per_slot_pos: bool = False) -> Dict:
    return transformer.init_cache(cfg, batch, max_len, dtype, device,
                                  per_slot_pos)


def decode_step(cfg, model: VLM, tokens: torch.Tensor, cache: Dict, *,
                last_only: bool = False):
    return transformer.decode_step(cfg, model, tokens, cache,
                                   last_only=last_only)
