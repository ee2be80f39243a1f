"""GQA attention: the port of the GQA half of ``repro.models.attention``.

Two execution paths, selected by ``cfg.attention_impl`` as in the reference:

  - ``xla_chunked``: plain chunked attention with an online-softmax carry
    over KV blocks (the reference's ``lax.scan`` becomes a Python loop), and
    plain single-position decode attention.
  - ``pallas``: the hand-written CUDA kernels through ``kernels.ops`` — the
    flash kernel for cache-free forward and fresh-cache prefill, the decode
    kernel for every cached S == 1 step.  On CPU tensors the ops take their
    plain versions.

Cache positions are a Python int (one depth for every row); per-slot
position vectors belong to the continuous-batching slice.  The cache is
written in place: a step writes its k / v rows into the preallocated
tensors and returns the same tensors with ``pos`` advanced.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

from .layers import Dense, RMSNorm, apply_rope, dense, rmsnorm

NEG_INF = -1e30


def _kv_valid_mask(length: int, pos: int, s: int,
                   device: torch.device) -> torch.Tensor:
    """Valid-slot mask (length,) for a cache after writing s tokens at pos."""
    return torch.arange(length, device=device) < pos + s


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_pos: Optional[torch.Tensor] = None,
                      kv_mask: Optional[torch.Tensor] = None,
                      block: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Flash-style attention over KV blocks.  q (B, H, S, D); k / v
    (B, Hkv, T, Dk / Dv); returns (B, H, S, Dv) in q's dtype.  Keys past T
    are zero padding masked to NEG_INF, exactly as in the reference."""
    b, h, s, d = q.shape
    _, hkv, t, dk = k.shape
    dv = v.shape[-1]
    g = h // hkv
    scale = d ** -0.5 if scale is None else scale
    block = min(block, t)
    nblk = -(-t // block)
    tpad = nblk * block
    dev = q.device

    mask = torch.arange(tpad, device=dev) < t
    if tpad != t:
        k = F.pad(k, (0, 0, 0, tpad - t))
        v = F.pad(v, (0, 0, 0, tpad - t))
    if kv_mask is not None:
        mask = mask & F.pad(kv_mask, (0, tpad - t), value=False)
    if q_pos is None:
        q_pos = torch.arange(s, device=dev)

    qg = q.reshape(b, hkv, g, s, d).float() * scale
    m_run = torch.full((b, hkv, g, s), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, s, dv), dtype=torch.float32, device=dev)
    for i in range(nblk):
        sl = slice(i * block, (i + 1) * block)
        kc, vc = k[:, :, sl].float(), v[:, :, sl].float()
        sblk = torch.einsum("bkgsd,bktd->bkgst", qg, kc)
        keep = mask[sl][None, :]
        if causal:
            kpos = torch.arange(i * block, (i + 1) * block, device=dev)
            keep = keep & (q_pos[:, None] >= kpos[None, :])
        sblk = torch.where(keep, sblk, NEG_INF)
        m_new = torch.maximum(m_run, sblk.amax(dim=-1))
        p = torch.exp(sblk - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,bktd->bkgsd", p, vc)
        m_run = m_new
    l_run = torch.where(l_run == 0.0, 1.0, l_run)
    out = acc / l_run[..., None]
    return out.reshape(b, h, s, dv).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_mask: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Plain single-position attention.  q (B, H, D); caches (B, Hkv, T, D);
    kv_mask (B, T)."""
    b, h, d = q.shape
    hkv = k_cache.shape[1]
    g = h // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, g, d).float() * scale
    s = torch.einsum("bkgd,bktd->bkgt", qg, k_cache.float())
    s = torch.where(kv_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p, v_cache.float())
    return out.reshape(b, h, v_cache.shape[-1]).to(q.dtype)


class GQA(nn.Module):
    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        self.wq = Dense(d, h * hd, bias=cfg.qkv_bias, dtype=dtype)
        self.wk = Dense(d, hkv * hd, bias=cfg.qkv_bias, dtype=dtype)
        self.wv = Dense(d, hkv * hd, bias=cfg.qkv_bias, dtype=dtype)
        self.wo = Dense(h * hd, d, dtype=dtype)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, dtype)
            self.k_norm = RMSNorm(hd, dtype)


def gqa_apply(p: GQA, cfg, x: torch.Tensor, *, positions: torch.Tensor,
              causal: bool = True, cache: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA self-attention.  x (B, S, d); positions (S,).  ``cache`` is
    dict(k, v, pos) with an int pos; returns (out, new_cache)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_

    q = dense(p.wq, x).reshape(b, s, h, hd)
    k = dense(p.wk, x).reshape(b, s, hkv, hd)
    v = dense(p.wv, x).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
    rp = positions[None, :]
    q = apply_rope(q.transpose(1, 2), rp, cfg.rope_theta)   # (B, H, S, hd)
    k = apply_rope(k.transpose(1, 2), rp, cfg.rope_theta)
    v = v.transpose(1, 2)
    kernels = cfg.attention_impl == "pallas"

    new_cache = None
    if cache is not None:
        pos = cache["pos"]
        kc, vc = cache["k"], cache["v"]
        kc[:, :, pos:pos + s] = k.to(kc.dtype)
        vc[:, :, pos:pos + s] = v.to(vc.dtype)
        new_cache = {"k": kc, "v": vc, "pos": pos + s}
        t = kc.shape[2]
        if s == 1:
            if kernels:
                out = ops.decode_attention(q[:, :, 0].contiguous(), kc, vc, pos)
            else:
                mask = _kv_valid_mask(t, pos, s, x.device)
                out = decode_attention(q[:, :, 0], kc, vc,
                                       mask.expand(b, t))
            out = out[:, :, None, :]
        elif kernels and cfg.fresh_prefill_kernel and pos == 0:
            # fresh-cache prefill: attention over the just-written cache
            # under its valid mask equals causal attention over the current
            # tokens; pos is concrete here, so the reference's lax.cond is
            # a plain branch
            out = ops.flash_attention(q, k, v, causal=causal)
        else:
            out = chunked_attention(q, kc, vc, causal=causal, q_pos=positions,
                                    kv_mask=_kv_valid_mask(t, pos, s, x.device),
                                    block=cfg.attn_block_kv)
    elif kernels:
        out = ops.flash_attention(q, k, v, causal=causal)
    else:
        out = chunked_attention(q, k, v, causal=causal, q_pos=positions,
                                block=cfg.attn_block_kv)
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return dense(p.wo, out), new_cache


def gqa_cache_init(cfg, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[torch.device] = None) -> Dict:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}
