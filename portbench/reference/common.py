"""Plain fp32 building blocks of the references, written from the
equations.  Nothing here imports the program under test.

Weight layout conventions (the same tensors are handed to the program):
a projection weight is (d_in, d_out) and applies as ``x @ w``; RoPE
rotates the two halves of a head's rotary dims against each other
(``x1 * cos - x2 * sin``, ``x1 * sin + x2 * cos``), with frequencies
``theta ** (-2i / d)``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

# a leaf: (name, shape, mean, std); the draw is mean + std * N(0, 1)
Leaf = Tuple[str, Tuple[int, ...], float, float]
Weights = Callable[[str], torch.Tensor]


def strict_fp32() -> None:
    """fp32 products stay fp32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def dense_leaf(name: str, d_in: int, d_out: int) -> Leaf:
    return (name, (d_in, d_out), 0.0, d_in ** -0.5)


def norm_leaf(name: str, d: int) -> Leaf:
    return (name, (d,), 1.0, 0.05)


def embed_leaf(p: Dict) -> Leaf:
    return ("embed.embedding", (p["vocab_size"], p["d_model"]), 0.0,
            p["d_model"] ** -0.5)


def head_leaves(p: Dict) -> List[Leaf]:
    """The final norm, and the output head unless tied to the embedding."""
    out = [norm_leaf("final_norm.scale", p["d_model"])]
    if not p.get("tie_embeddings"):
        out.append(dense_leaf("lm_head.w", p["d_model"], p["vocab_size"]))
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, ..., D): position s rotates row s; halves rotate together."""
    s, d = x.shape[0], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    shape = (s,) + (1,) * (x.dim() - 2) + (d // 2,)
    cos = torch.cos(ang).float().reshape(shape)
    sin = torch.sin(ang).float().reshape(shape)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, block: int = 1024) -> torch.Tensor:
    """q / k (S, H, Dk), v (S, H, Dv) -> (S, H, Dv); softmax over keys
    0..s for query s, in blocks of query rows."""
    s = q.shape[0]
    kt = k.permute(1, 2, 0)                              # (H, Dk, S)
    vh = v.transpose(0, 1)                               # (H, S, Dv)
    out = []
    keys = torch.arange(s, device=q.device)
    for a in range(0, s, block):
        b = min(s, a + block)
        sc = torch.matmul(q[a:b].transpose(0, 1), kt) * scale   # (H, r, S)
        mask = keys[None, :] <= torch.arange(a, b, device=q.device)[:, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        out.append(torch.matmul(torch.softmax(sc, dim=-1), vh))
    return torch.cat(out, dim=1).transpose(0, 1)


def head_logits(p: Dict, x: torch.Tensor, w: Weights) -> torch.Tensor:
    """Final norm and the output head (the embedding's transpose where
    tied)."""
    x = rmsnorm(x, w("final_norm.scale"), p["norm_eps"])
    if p.get("tie_embeddings"):
        return x @ w("embed.embedding").T
    return x @ w("lm_head.w")


def fp8_weights(w: Weights, names: set) -> Weights:
    """The control's weights: every leaf in ``names`` rounded to fp8 e4m3
    under a per-leaf scale (its largest magnitude maps to 448), the rest
    as they are."""
    def get(name: str) -> torch.Tensor:
        t = w(name)
        if name not in names:
            return t
        s = t.abs().amax().clamp(min=1e-30) / 448.0
        return (t / s).to(torch.float8_e4m3fn).float() * s
    return get


def matrix_names(leaves: List[Leaf]) -> set:
    """Leaves that are matrices (projections, experts, tables)."""
    return {name for name, shape, _m, _s in leaves if len(shape) >= 2}


def widest_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position, how far the given token's logit lies below the best."""
    best = logits.max(dim=-1).values
    return best - logits.gather(-1, tokens[:, None].long())[:, 0]
