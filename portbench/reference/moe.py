"""The DeepSeek-V2 family (DeepSeek-V2-Lite, arXiv:2405.04434, and its
published ``config.json``): leading dense layers, then layers whose
feed-forward is a mixture of experts, each with multi-head latent
attention (MLA), then the final norm and an untied output head.  Plain
fp32 PyTorch from the published equations; imports nothing of the
program.  Each layer's weights are upcast once when it runs, so no fp32
copy of the whole model exists, and the feed-forward of a layer runs over
the tokens of every sequence together.

Attention (no query compression, ``q_lora_rank`` 0):
    q = u @ wq, per head split into q_nope (dn) and q_rope (dr)
    [c, k_rope] = u @ wkv_a;  c = rmsnorm(c) (the kv_lora_rank latent)
    [k_nope, v] = c @ wkv_b, per head (dn, dv);  k_rope shared over heads
    q_rope, k_rope = RoPE(q_rope), RoPE(k_rope), under YaRN where the
        configuration has ``rope_scaling``
    o = softmax(causal, [q_nope, q_rope] . [k_nope, k_rope] * scale) v
    out = o @ wo;  scale = (dn + dr) ** -0.5 * mscale(mscale_all_dim) ** 2
YaRN (``rope_scaling``, type yarn): rotary pair i of the dr dims has the
    base frequency f_i = theta ** (-2i / dr) below the correction dim of
    ``beta_fast`` rotations over ``original_max_position_embeddings``
    positions, f_i / factor above that of ``beta_slow``, and a linear ramp
    between (floor and ceil of the two dims); cos and sin are scaled by
    mscale(mscale) / mscale(mscale_all_dim), mscale(m) = 0.1 m ln(factor)
    + 1.
Feed-forward: the dense layers a SwiGLU of ``d_ff``; the others
    p = softmax(u @ w_router) in fp32, the greedy top-k experts by p, each
    token's output sum_k g_k SwiGLU_e(k)(u) + SwiGLU_shared(u), with
    g_k = p_k (``norm_topk_prob`` false, as published; true renormalises
    them to sum 1), routed experts of width ``d_expert`` and one shared
    SwiGLU of width n_shared * d_expert.  Dropless: every routed token is
    computed.

One departure: the published checkpoint rotates interleaved pairs of the
rope dims, where this reference (and the program) rotates the two halves
against each other.  On weights drawn at random that is a fixed
permutation of the rope columns of ``wq`` and ``wkv_a``, the same model.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from portbench.reference.common import (Leaf, Weights, causal_attention,
                                        dense_leaf, embed_leaf, head_leaves,
                                        head_logits, norm_leaf, rmsnorm,
                                        swiglu)


def _mla(p: Dict):
    m = p["mla"]
    return (m["nope_head_dim"], m["rope_head_dim"], m["v_head_dim"],
            m["kv_lora_rank"])


def _attn_leaves(p: Dict, a: str) -> List[Leaf]:
    d, h = p["d_model"], p["n_heads"]
    dn, dr, dv, kvr = _mla(p)
    if p["mla"].get("q_lora_rank"):
        raise ValueError("this reference has no query compression")
    return [dense_leaf(a + "attn.wq.w", d, h * (dn + dr)),
            dense_leaf(a + "attn.wkv_a.w", d, kvr + dr),
            norm_leaf(a + "attn.kv_norm.scale", kvr),
            dense_leaf(a + "attn.wkv_b.w", kvr, h * (dn + dv)),
            dense_leaf(a + "attn.wo.w", h * dv, d)]


def _expert_leaf(name: str, e: int, d_in: int, d_out: int) -> Leaf:
    return (name, (e, d_in, d_out), 0.0, d_in ** -0.5)


def _layers(p: Dict):
    """(prefix, dense) of every layer, in order."""
    nd = p["moe"]["n_dense_layers"]
    return [(f"blocks_dense.{i}.", True) for i in range(nd)] + \
        [(f"blocks.{i}.", False) for i in range(p["n_layers"] - nd)]


def leaves(p: Dict) -> List[Leaf]:
    d, mo = p["d_model"], p["moe"]
    e, de = mo["n_experts"], mo["d_expert"]
    ds = de * mo["n_shared_experts"]
    out: List[Leaf] = [embed_leaf(p)] + head_leaves(p)
    for a, is_dense in _layers(p):
        out += [norm_leaf(a + "norm1.scale", d)] + _attn_leaves(p, a)
        out.append(norm_leaf(a + "norm2.scale", d))
        if is_dense:
            out += [dense_leaf(a + "mlp.gate.w", d, p["d_ff"]),
                    dense_leaf(a + "mlp.up.w", d, p["d_ff"]),
                    dense_leaf(a + "mlp.down.w", p["d_ff"], d)]
            continue
        out += [dense_leaf(a + "moe.router.w", d, e),
                _expert_leaf(a + "moe.gate", e, d, de),
                _expert_leaf(a + "moe.up", e, d, de),
                _expert_leaf(a + "moe.down", e, de, d)]
        if ds:
            out += [dense_leaf(a + "moe.shared.gate.w", d, ds),
                    dense_leaf(a + "moe.shared.up.w", d, ds),
                    dense_leaf(a + "moe.shared.down.w", ds, d)]
    return out


# ------------------------------------------------------------------ YaRN --
def _yarn_mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn(dr: int, theta: float, rs: Optional[Dict]):
    """(inverse frequencies (dr / 2,) in fp64, the cos / sin factor, the
    softmax scale's factor) of ``rope_scaling`` ``rs`` (None: plain
    RoPE)."""
    inv = theta ** (-torch.arange(0, dr, 2, dtype=torch.float64) / dr)
    if rs is None:
        return inv, 1.0, 1.0
    f, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def dim(rot):
        return dr * math.log(orig / (rot * 2 * math.pi)) \
            / (2 * math.log(theta))

    low = max(math.floor(dim(rs["beta_fast"])), 0)
    high = min(math.ceil(dim(rs["beta_slow"])), dr - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dr // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0.0, 1.0)
    inv = inv / f * ramp + inv * (1.0 - ramp)
    all_dim = rs.get("mscale_all_dim") or 0.0
    cos_sin = _yarn_mscale(f, rs.get("mscale", 1.0)) \
        / _yarn_mscale(f, all_dim)
    soft = _yarn_mscale(f, all_dim) ** 2 if all_dim else 1.0
    return inv, cos_sin, soft


def rope_tables(p: Dict, n: int, device) -> tuple:
    """(cos, sin) (n, dr / 2) fp32 of positions 0..n-1, YaRN's factor on
    both, and the softmax scale."""
    dn, dr, _dv, _kvr = _mla(p)
    inv, cos_sin, soft = yarn(dr, p["rope_theta"], p.get("rope_scaling"))
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None, :]
    return ((torch.cos(ang) * cos_sin).float().to(device),
            (torch.sin(ang) * cos_sin).float().to(device),
            (dn + dr) ** -0.5 * soft)


def _rope(x: torch.Tensor, cos: torch.Tensor,
          sin: torch.Tensor) -> torch.Tensor:
    """x (S, H, D): position s rotates row s, the two halves together."""
    s, d = x.shape[0], x.shape[-1]
    cos, sin = cos[:s, None, :], sin[:s, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ----------------------------------------------------------------- layers --
def _attention(p: Dict, lw: Dict, u: torch.Tensor, rope) -> torch.Tensor:
    s, h = u.shape[0], p["n_heads"]
    dn, dr, dv, kvr = _mla(p)
    cos, sin, scale = rope
    q = (u @ lw["attn.wq.w"]).reshape(s, h, dn + dr)
    kv_a = u @ lw["attn.wkv_a.w"]
    c = rmsnorm(kv_a[:, :kvr], lw["attn.kv_norm.scale"], p["norm_eps"])
    kv = (c @ lw["attn.wkv_b.w"]).reshape(s, h, dn + dv)
    k_rope = _rope(kv_a[:, None, kvr:], cos, sin).expand(s, h, dr)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :dn], k_rope], dim=-1)
    o = causal_attention(q, k, kv[..., dn:], scale)
    return o.reshape(s, h * dv) @ lw["attn.wo.w"]


def _experts(p: Dict, lw: Dict, u: torch.Tensor) -> torch.Tensor:
    """The routed experts over tokens u (T, d), dropless."""
    mo = p["moe"]
    probs = torch.softmax(u @ lw["moe.router.w"], dim=-1)
    gate, idx = torch.topk(probs, mo["top_k"], dim=-1)
    if mo.get("norm_topk_prob", True):
        gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(u)
    for e in range(mo["n_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            y = swiglu(u[rows], lw["moe.gate"][e], lw["moe.up"][e],
                       lw["moe.down"][e])
            out.index_add_(0, rows, y * gate[rows, slot][:, None])
    return out


def _feed_forward(p: Dict, lw: Dict, u: torch.Tensor,
                  is_dense: bool) -> torch.Tensor:
    if is_dense:
        return swiglu(u, lw["mlp.gate.w"], lw["mlp.up.w"], lw["mlp.down.w"])
    y = _experts(p, lw, u)
    if p["moe"]["n_shared_experts"]:
        y = y + swiglu(u, lw["moe.shared.gate.w"], lw["moe.shared.up.w"],
                       lw["moe.shared.down.w"])
    return y


def _layer_weights(p: Dict, w: Weights, a: str) -> Dict[str, torch.Tensor]:
    """The fp32 weights of the layer whose leaves' names start with
    ``a``, by their names within the layer."""
    return {name[len(a):]: w(name) for name, _s, _m, _d in leaves(p)
            if name.startswith(a)}


def forward(p: Dict, w: Weights, seqs: List[torch.Tensor],
            starts: List[int]) -> List[torch.Tensor]:
    """Logits (fp32) at positions ``starts[i]`` onwards of each token
    sequence, every layer applied to all sequences before the next."""
    eps = p["norm_eps"]
    table = w("embed.embedding")
    xs = [table[s.long()] for s in seqs]
    del table
    lens = [x.shape[0] for x in xs]
    rope = rope_tables(p, max(lens), xs[0].device)
    for a, is_dense in _layers(p):
        lw = _layer_weights(p, w, a)
        xs = [x + _attention(p, lw, rmsnorm(x, lw["norm1.scale"], eps), rope)
              for x in xs]
        x = torch.cat(xs)
        x = x + _feed_forward(p, lw, rmsnorm(x, lw["norm2.scale"], eps),
                              is_dense)
        xs = list(torch.split(x, lens))
        del lw, x
    return [head_logits(p, x[st:], w) for x, st in zip(xs, starts)]


def token_flops(p: Dict, keys: int, head: bool) -> float:
    """Model FLOPs of one token whose attention reads ``keys`` positions:
    every projection it uses (2 per weight: the attention's, the dense
    layers' SwiGLU, the router, its top-k routed experts and the shared
    one), attention (2 H (dn + dr) + 2 H dv per key and layer), and the
    output head where ``head``."""
    d, h, mo = p["d_model"], p["n_heads"], p["moe"]
    dn, dr, dv, kvr = _mla(p)
    attn_w = d * h * (dn + dr) + d * (kvr + dr) + kvr * h * (dn + dv) \
        + h * dv * d
    nd = mo["n_dense_layers"]
    n_moe = p["n_layers"] - nd
    moe_w = d * mo["n_experts"] + 3 * d * mo["d_expert"] * (
        mo["top_k"] + mo["n_shared_experts"])
    out = 2.0 * (p["n_layers"] * attn_w + nd * 3 * d * p["d_ff"]
                 + n_moe * moe_w)
    out += p["n_layers"] * 2.0 * keys * h * (dn + dr + dv)
    if head:
        out += 2.0 * d * p["vocab_size"]
    return out
