"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth its CUDA kernel is held to (on
the card by ``chip_smoke.py``) and the path the ``ops`` wrappers take for
CPU tensors.  They repeat the kernels' arithmetic in fp32 and are no
yardstick of speed.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v, q (B, H, S, D), k / v (B, Hkv, T, D).

    The causal mask is top-left aligned, q_pos >= k_pos, as in the Pallas
    kernel (``repro/kernels/flash_attention.py:52-56``); it equals the
    bottom-right ``repro.kernels.ref.attention`` only when S == T.  GQA maps
    q head h to kv head h // (H / Hkv)."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, g, s, d).float() * scale
    logits = torch.einsum("bkgsd,bktd->bkgst", qg, k.float())
    if causal:
        keep = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(t, device=q.device)[None, :])
        logits = torch.where(keep, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(b, h, s, v.shape[-1]).to(q.dtype)


def pos_vector(pos: Union[int, torch.Tensor], b: int,
               device: torch.device) -> torch.Tensor:
    """A scalar or per-row decode position as an int32 (B,) tensor.  A
    Python int becomes a device-side fill, not a host-to-device copy, so a
    decode step does not wait on the card."""
    if isinstance(pos, int):
        return torch.full((b,), pos, dtype=torch.int32, device=device)
    p = pos.to(device=device, dtype=torch.int32)
    return p.reshape(-1).expand(b).contiguous() if p.numel() == 1 else p


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: Union[int, torch.Tensor], *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One query row per (b, h) against the cache: keys t <= pos[b] count.
    q (B, H, D); caches (B, Hkv, T, D); ``pos`` a scalar or (B,) int.
    Mirrors ``repro.compiler.registry._decode_reference``."""
    b, h, d = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, g, d).float() * scale
    s = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.float())
    keep = (torch.arange(t, device=q.device)[None, :]
            <= pos_vector(pos, b, q.device)[:, None])
    s = torch.where(keep[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p, v_cache.float())
    return out.reshape(b, h, v_cache.shape[-1]).to(q.dtype)
