"""Family dispatcher: the single entry point the engine and launcher use.

The decoder-only families are ported: dense, SSM, MoE and hybrid, with
GQA or MLA attention.  Enc-dec and VLM raise ``NotImplementedError``
naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import transformer

# ROADMAP.md queue 1 items for the families the port does not have yet
_NOT_PORTED = {
    "encdec": "item 5 (enc-dec and VLM)",
    "vlm": "item 5 (enc-dec and VLM)",
}


def check_supported(cfg) -> None:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP.md queue 1, {_NOT_PORTED[cfg.family]})")
    if cfg.family not in ("dense", "ssm", "moe", "hybrid"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.family == "moe" and cfg.moe is None:
        raise ValueError(f"{cfg.name}: the moe family needs cfg.moe")
    if cfg.family in ("ssm", "hybrid") and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: the {cfg.family} family needs cfg.ssm")


def build(cfg, dtype: torch.dtype = torch.float32) -> transformer.Transformer:
    """Uninitialised parameters for ``cfg`` (see ``convert``)."""
    check_supported(cfg)
    return transformer.Transformer(cfg, dtype)


def forward(cfg, model, batch: Dict, *, last_only: bool = False):
    check_supported(cfg)
    return transformer.forward(cfg, model, batch["tokens"],
                               last_only=last_only)


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None,
               per_slot_pos: bool = False) -> Dict:
    """``per_slot_pos=True``: the continuous-batching cache, a (batch,)
    int32 ``pos`` per layer (``serve.scheduler``)."""
    check_supported(cfg)
    return transformer.init_cache(cfg, batch, max_len, dtype, device,
                                  per_slot_pos)


def decode_step(cfg, model, batch: Dict, cache: Dict, *,
                last_only: bool = False):
    """One cached step; batch carries tokens (B, S)."""
    check_supported(cfg)
    return transformer.decode_step(cfg, model, batch["tokens"], cache,
                                   last_only=last_only)
