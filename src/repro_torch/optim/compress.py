"""Gradient compression with error feedback: the port of
``repro.optim.compress``.

int8 block-quantized gradients for a slow all-reduce: 256-element blocks,
each scaled by its largest magnitude / 127 and rounded half to even, with
the quantization residual carried into the next step's gradient (error
feedback), so the compression stays unbiased over time.  With the
trainer's pump M the accumulated gradient is quantized once per M
microbatches.  Gradients are dicts of named tensors.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

BLOCK = 256


def _leaf_quantize(g: torch.Tensor, err: Optional[torch.Tensor]):
    g = g.float() + (err.float() if err is not None else 0.0)
    flat = g.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(-1)[:g.numel()].reshape(g.shape)
    return q, scale, g - deq


def quantize(grads: Mapping[str, torch.Tensor],
             err_state: Optional[Mapping[str, torch.Tensor]] = None
             ) -> Tuple[Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                        Dict[str, torch.Tensor]]:
    """grads -> ({name: (int8 blocks, fp32 scales)}, the new error-feedback
    state)."""
    q, err = {}, {}
    for name, g in grads.items():
        qi, scale, e = _leaf_quantize(
            g, None if err_state is None else err_state[name])
        q[name], err[name] = (qi, scale), e
    return q, err


def dequantize(q: Mapping[str, Tuple[torch.Tensor, torch.Tensor]],
               like: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for name, (qi, scale) in q.items():
        g = like[name]
        out[name] = (qi.float() * scale).reshape(-1)[:g.numel()] \
            .reshape(g.shape)
    return out


def compression_ratio(grads: Mapping[str, torch.Tensor]) -> float:
    """Bytes (int8 + scales) / bytes (fp32)."""
    total = sum(g.numel() for g in grads.values())
    q_bytes = total * 1 + (total // BLOCK + 1) * 4
    return q_bytes / (total * 4)
