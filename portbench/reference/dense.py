"""The dense family (Qwen2, Qwen3): a stack of pre-norm decoder layers,
then the final norm and the output head (tied to the embedding where the
configuration says so).  Plain fp32 PyTorch from the equations, imports
nothing of the program; each layer's weights are upcast when it runs, so
no fp32 copy of the whole model exists.

Layer: x += GQA(rmsnorm1(x)); x += SwiGLU(rmsnorm2(x)), where
    q, k, v = u @ wq (+ bq), u @ wk (+ bk), u @ wv (+ bv), per head
    q, k = rmsnorm(q), rmsnorm(k) per head where ``qk_norm``
    q, k = RoPE(q), RoPE(k);  each group of n_heads / n_kv_heads query
    heads reads one key-value head
    o = softmax(causal, q k^T / sqrt(D)) v;  out = o @ wo
"""
from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference.common import (Leaf, Weights, causal_attention,
                                        dense_leaf, embed_leaf, head_leaves,
                                        head_logits, norm_leaf, rmsnorm,
                                        rope, swiglu)


def _heads(p: Dict):
    h, hkv = p["n_heads"], p["n_kv_heads"]
    return h, hkv, p.get("head_dim") or p["d_model"] // h


def leaves(p: Dict) -> List[Leaf]:
    d, f = p["d_model"], p["d_ff"]
    h, hkv, hd = _heads(p)
    out: List[Leaf] = [embed_leaf(p)] + head_leaves(p)
    for i in range(p["n_layers"]):
        a = f"blocks.{i}."
        out += [norm_leaf(a + "norm1.scale", d),
                dense_leaf(a + "attn.wq.w", d, h * hd),
                dense_leaf(a + "attn.wk.w", d, hkv * hd),
                dense_leaf(a + "attn.wv.w", d, hkv * hd),
                dense_leaf(a + "attn.wo.w", h * hd, d)]
        if p.get("qkv_bias"):
            out += [(a + f"attn.w{x}.b", (n * hd,), 0.0, 0.1)
                    for x, n in (("q", h), ("k", hkv), ("v", hkv))]
        if p.get("qk_norm"):
            out += [norm_leaf(a + "attn.q_norm.scale", hd),
                    norm_leaf(a + "attn.k_norm.scale", hd)]
        out += [norm_leaf(a + "norm2.scale", d),
                dense_leaf(a + "mlp.gate.w", d, f),
                dense_leaf(a + "mlp.up.w", d, f),
                dense_leaf(a + "mlp.down.w", f, d)]
    return out


def _proj(p: Dict, w: Weights, a: str, u: torch.Tensor, n: int, hd: int,
          norm: str) -> torch.Tensor:
    y = u @ w(a + ".w")
    if p.get("qkv_bias"):
        y = y + w(a + ".b")
    y = y.reshape(u.shape[0], n, hd)
    if norm and p.get("qk_norm"):
        y = rmsnorm(y, w(norm), p["norm_eps"])
    return y


def layer(p: Dict, w: Weights, a: str, x: torch.Tensor) -> torch.Tensor:
    eps = p["norm_eps"]
    h, hkv, hd = _heads(p)
    u = rmsnorm(x, w(a + "norm1.scale"), eps)
    q = rope(_proj(p, w, a + "attn.wq", u, h, hd, a + "attn.q_norm.scale"),
             p["rope_theta"])
    k = rope(_proj(p, w, a + "attn.wk", u, hkv, hd, a + "attn.k_norm.scale"),
             p["rope_theta"])
    v = _proj(p, w, a + "attn.wv", u, hkv, hd, "")
    k = k.repeat_interleave(h // hkv, dim=1)
    v = v.repeat_interleave(h // hkv, dim=1)
    o = causal_attention(q, k, v, hd ** -0.5).reshape(x.shape[0], h * hd)
    x = x + o @ w(a + "attn.wo.w")
    u = rmsnorm(x, w(a + "norm2.scale"), eps)
    return x + swiglu(u, w(a + "mlp.gate.w"), w(a + "mlp.up.w"),
                      w(a + "mlp.down.w"))


def forward(p: Dict, w: Weights, seqs: List[torch.Tensor],
            starts: List[int]) -> List[torch.Tensor]:
    """Logits (fp32) at positions ``starts[i]`` onwards of each token
    sequence, every layer applied to all sequences before the next."""
    table = w("embed.embedding")
    xs = [table[s.long()] for s in seqs]
    del table
    for i in range(p["n_layers"]):
        xs = [layer(p, w, f"blocks.{i}.", x) for x in xs]
    return [head_logits(p, x[st:], w) for x, st in zip(xs, starts)]


def token_flops(p: Dict, keys: int, head: bool) -> float:
    """Model FLOPs of one token whose attention reads ``keys`` positions:
    every projection (2 per weight), attention (4 H D per key and layer),
    and the output head where ``head``."""
    d, f = p["d_model"], p["d_ff"]
    h, hkv, hd = _heads(p)
    layer_w = d * (h + 2 * hkv) * hd + h * hd * d + 3 * d * f
    out = 2.0 * p["n_layers"] * layer_w
    out += p["n_layers"] * 4.0 * keys * h * hd
    if head:
        out += 2.0 * d * p["vocab_size"]
    return out
