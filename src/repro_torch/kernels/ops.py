"""Public kernel wrappers: the port's ``repro.kernels.ops``.

A CUDA tensor launches the hand-written kernel or raises; a CPU tensor
takes the plain PyTorch version in ``ref``.  Nothing falls back from the
card to the plain version.  The launch counts live on the kernel modules
(``flash_attention.launches``, ``decode_attention.launches``,
``ssd_scan.launches``, ``ssd_decode.launches``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from . import decode_attention as _da
from . import flash_attention as _fa
from . import ref
from . import ssd_decode as _sd
from . import ssd_scan as _ss


def _route(x: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention, q (B, H, S, D), k / v (B, Hkv, T, D); GQA maps
    q head h to kv head h // (H / Hkv).  Causal is top-left aligned."""
    if _route(q, "flash_attention"):
        return _fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    return ref.flash_attention(q, k, v, causal=causal, scale=scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: Union[int, torch.Tensor], *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-position attention against a preallocated cache: q (B, H, D),
    caches (B, Hkv, T, D), valid slots 0..pos[b] (scalar or (B,) pos)."""
    if _route(q, "decode_attention"):
        return _da.decode_attention_cuda(q, k_cache, v_cache, pos,
                                         scale=scale)
    return ref.decode_attention(q, k_cache, v_cache, pos, scale=scale)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int,
             final_state: bool = False):
    """Mamba-2 chunked SSD scan: x (B, L, H, P), dt (B, L, H), A (H,), B / C
    (B, L, G, N).  Returns y, or (y, fp32 (B, H, N, P) final state)."""
    if _route(x, "ssd_scan"):
        return _ss.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk,
                                 final_state=final_state)
    return ref.ssd_scan(x, dt, A, B, C, chunk=chunk, final_state=final_state)


def ssd_decode(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
               A: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """One-token SSD step: state (B, H, N, P) fp32, x (B, H, P), dt (B, H),
    A (H,), B / C (B, G, N).  Returns (y fp32 (B, H, P), new state)."""
    if _route(x, "ssd_decode"):
        return _sd.ssd_decode_cuda(state, x, dt, A, B, C)
    return ref.ssd_decode(state, x, dt, A, B, C)
