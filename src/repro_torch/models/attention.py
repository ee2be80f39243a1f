"""Attention: the port of ``repro.models.attention`` (GQA and MLA; GQA
also as cross-attention over an encoder output, ``kv_input``, which always
takes the plain chunked route, as in the reference).

Two execution paths, selected by ``cfg.attention_impl`` as in the reference:

  - ``xla_chunked``: plain chunked attention with an online-softmax carry
    over KV blocks (the reference's ``lax.scan`` becomes a Python loop), and
    plain single-position decode attention.
  - ``pallas``: the hand-written CUDA kernels — the flash kernel for
    cache-free forward and fresh-cache prefill, the decode kernel for every
    cached S == 1 step.  ``cfg.kernel_plan == 'measure'`` routes both
    through the plan registry (``compiler.registry``: bucketed, measured
    pump plans), ``'direct'`` calls ``kernels.ops`` at pump 1.  On CPU
    tensors the ops take their plain versions.

MLA (``mla_apply``) follows the reference's three branches: a fresh-cache
prefill writes the compressed cache and attends over the current tokens
through chunked attention, a decode step runs the absorbed path over the
compressed cache with fp32 accumulation, and the cache-free forward
decompresses and attends.  Under ``cfg.rope_scaling`` (YaRN, the port's
addition for deepseek-v2-lite as published) the rope frequencies ramp
to their scaled values and every branch's softmax scale takes YaRN's
mscale² (``mla_scale``).  Its nope + rope head width (192 in
deepseek-v2-lite) is not its v width (128), so the flash kernel's branch
(``dn + dr == dv``) is reached by no shipped config.

Cache positions come in two shapes, as in the reference.  A Python int
``pos`` is one depth for every row (``Engine.generate``, a prefill, a
continuation chunk).  A **per-slot** ``pos``, an int32 ``(B,)`` tensor on
the cache's device (``init_cache(per_slot_pos=True)``), makes each row an
independent decode lane at its own depth (``serve.scheduler``): the
single-token write, the key mask and the rope positions are per row, and
decode passes the tensor itself to the kernel, which reads it on the card.
Nothing here reads a tensor ``pos`` on the host.  The per-slot form is
decode-only (S == 1).  A lane whose ``pos`` has run past the cache (a free
lane keeps decoding garbage) writes nothing and attends over every key, as
the reference's mask write does.  The cache is written in place: a step
writes its rows into the preallocated tensors and returns the same tensors
with ``pos`` advanced.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

from .layers import (Dense, RMSNorm, SlotStep, apply_rope, cache_pos, dense,
                     local_map, rmsnorm, slot_step, splittable)

NEG_INF = -1e30


def _per_slot(pos) -> bool:
    return isinstance(pos, torch.Tensor) and pos.dim() > 0


def _rope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Positions broadcast over (B, H, S, D) heads: the classic ``(S,)``
    vector or per-slot ``(B, S)`` rows (the reference's
    ``_rope_positions``)."""
    return positions[None, :] if positions.dim() == 1 \
        else positions[:, None, :]


def _kv_valid_mask(length: int, pos: int, s: int,
                   device: torch.device) -> torch.Tensor:
    """Valid-slot mask (length,) for a cache of ``length`` after writing
    ``s`` tokens at an int ``pos`` (per slot: ``SlotStep.valid``)."""
    return torch.arange(length, device=device) < pos + s


def _slot_step(slots: Optional[SlotStep], pos: torch.Tensor,
               length: int) -> SlotStep:
    """The step's shared ``SlotStep``, or this layer's own where it is
    called alone."""
    return slots if slots is not None else slot_step(pos, length)


def _write_rows(cache: torch.Tensor, new: torch.Tensor, st: SlotStep) -> None:
    """Per-slot single-token write, in place: row b of ``cache`` (B, T, ...)
    takes ``new[b]`` at ``st.at[b]``; a row with pos >= T keeps its cache
    unchanged (the reference's mask write)."""
    keep = st.keep.reshape(-1, *([1] * (new.dim() - 1)))
    cache[st.rows, st.at] = torch.where(keep, new.to(cache.dtype),
                                        cache[st.rows, st.at])


def _per_slot_only_decode(s: int) -> None:
    if s != 1:
        raise ValueError(
            "per-slot cache positions are decode-only (S == 1): prefill "
            "runs on a fresh int-pos cache and is scattered into its slot "
            "(serve.scheduler.insert_rows)")


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_pos: Optional[torch.Tensor] = None,
                      kv_mask: Optional[torch.Tensor] = None,
                      block: int = 1024,
                      scale: Optional[float] = None,
                      q_start: Optional[int] = None) -> torch.Tensor:
    """Flash-style attention over KV blocks.  q (B, H, S, D); k / v
    (B, Hkv, T, Dk / Dv); returns (B, H, S, Dv) in q's dtype.  Keys past T
    are zero padding masked to NEG_INF, exactly as in the reference.

    ``q_start`` (causal only): the queries' positions are ``q_start +
    arange(S)``, known on the host (a fresh prefill).  Each block of
    ``block`` queries then stops at the last KV block holding a key at or
    before its last query: the blocks after it are wholly masked for those
    rows, and a wholly masked block adds exactly nothing to their running
    max, sum and output (its weights are exp(NEG_INF - m) = 0), so the
    answer is the unsplit one up to the rounding of products over fewer
    rows."""
    b, h, s, d = q.shape
    _, hkv, t, dk = k.shape
    if causal and q_start is not None and s > block:
        outs = []
        for i in range(0, s, block):
            rows = min(block, s - i)
            end = min(t, -(-(q_start + i + rows) // block) * block)
            outs.append(chunked_attention(
                q[:, :, i:i + rows], k[:, :, :end], v[:, :, :end],
                causal=True,
                q_pos=None if q_pos is None else q_pos[i:i + rows],
                kv_mask=None if kv_mask is None else kv_mask[:end],
                block=block, scale=scale))
        return torch.cat(outs, dim=2)
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


def _flash(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool) -> torch.Tensor:
    """The flash kernel for the ``pallas`` routes: through the plan
    registry under ``kernel_plan='measure'``, else ``ops`` at pump 1."""
    if cfg.kernel_plan == "measure":
        from repro_torch.compiler.registry import default_registry
        return default_registry().flash_attention(q, k, v, causal=causal)
    return ops.flash_attention(q, k, v, causal=causal)


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


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_pos: Optional[torch.Tensor] = None,
                    kv_mask: Optional[torch.Tensor] = None,
                    **kw) -> torch.Tensor:
    """``chunked_attention``; on DTensors each rank attends over its own
    batch rows and heads (``layers.local_map``: DTensor cannot flatten the
    sharded heads into the grouped products)."""
    row_pos = q_pos is not None and q_pos.dim() == 2
    return local_map(
        lambda q, k, v, qp, m: chunked_attention(q, k, v, q_pos=qp,
                                                 kv_mask=m, **kw),
        (q, k, v, q_pos, kv_mask),
        ((0, 1), (0, 1), (0, 1), (0,) if row_pos else None, None), (0, 1))


def local_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           kv_mask: torch.Tensor) -> torch.Tensor:
    """``decode_attention``, per rank over its batch rows and heads on
    DTensors (as ``local_attention``)."""
    return local_map(decode_attention, (q, k_cache, v_cache, kv_mask),
                     ((0, 1), (0, 1), (0, 1), (0,)), (0, 1))


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
              causal: bool = True, cache: Optional[Dict] = None,
              slots: Optional[SlotStep] = None,
              kv_input: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention.  x (B, S, d); positions (S,), or (B, S) under a
    per-slot cache.  ``cache`` is dict(k, v, pos), pos an int or a (B,)
    int32 tensor; ``slots`` the decode step's shared write and mask under
    a per-slot pos.  ``kv_input`` (B, T, d) makes it cross-attention: k
    and v projected from it, no rope, no cache, non-causal, and always the
    plain chunked route (the reference's kernel branch needs ``kv_input``
    None).  Returns (out, new_cache)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if kv_input is not None and cache is not None:
        raise ValueError("cross-attention (kv_input) takes no cache")
    kv_src = x if kv_input is None else kv_input
    t_in = kv_src.shape[1]

    q = splittable(dense(p.wq, x), 2, h).reshape(b, s, h, hd)
    k = splittable(dense(p.wk, kv_src), 2, hkv).reshape(b, t_in, hkv, hd)
    v = splittable(dense(p.wv, kv_src), 2, hkv).reshape(b, t_in, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if kv_input is None:
        rp = _rope_positions(positions)
        # (B, H, S, hd)
        q = apply_rope(q, rp, cfg.rope_theta, cfg.rope_scaling)
        k = apply_rope(k, rp, cfg.rope_theta, cfg.rope_scaling)
    kernels = cfg.attention_impl == "pallas"

    new_cache = None
    if kv_input is not None:
        out = local_attention(q, k, v, causal=False, q_pos=positions,
                              block=cfg.attn_block_kv)
    elif cache is not None:
        pos = cache["pos"]
        kc, vc = cache["k"], cache["v"]
        t = kc.shape[2]
        st = None
        if _per_slot(pos):
            _per_slot_only_decode(s)
            # each lane writes at its own depth (rows of (B, T, Hkv, hd))
            st = _slot_step(slots, pos, t)
            _write_rows(kc.transpose(1, 2), k[:, :, 0], st)
            _write_rows(vc.transpose(1, 2), v[:, :, 0], st)
        else:
            kc[:, :, pos:pos + s] = k.to(kc.dtype)
            vc[:, :, pos:pos + s] = v.to(vc.dtype)
        new_cache = {"k": kc, "v": vc,
                     "pos": pos + s if st is None else st.next_pos}
        if s == 1:
            # the kernel takes an int or the (B,) tensor pos itself; the
            # registry keys a tensor on the full-cache plan
            if kernels and cfg.kernel_plan == "measure":
                from repro_torch.compiler.registry import default_registry
                out = default_registry().decode_attention(
                    q[:, :, 0].contiguous(), kc, vc, pos)
            elif kernels:
                out = ops.decode_attention(q[:, :, 0].contiguous(), kc, vc, pos)
            else:
                mask = (_kv_valid_mask(t, pos, s, x.device).expand(b, t)
                        if st is None else st.valid)
                out = local_decode_attention(q[:, :, 0], kc, vc, mask)
            out = out[:, :, None, :]
        elif kernels and cfg.fresh_prefill_kernel and pos == 0:
            # fresh-cache prefill: attention over the just-written cache
            # under its valid mask equals causal attention over the current
            # tokens; pos is concrete here, so the reference's lax.cond is
            # a plain branch
            out = _flash(cfg, q, k, v, causal=causal)
        else:
            # a continuation chunk (pos > 0, or the flash route off) attends
            # over the whole written prefix under its valid mask
            out = local_attention(q, kc, vc, causal=causal, q_pos=positions,
                                  kv_mask=_kv_valid_mask(t, pos, s, x.device),
                                  block=cfg.attn_block_kv)
    elif kernels:
        out = _flash(cfg, q, k, v, causal=causal)
    else:
        out = local_attention(q, k, v, causal=causal, q_pos=positions,
                              block=cfg.attn_block_kv)
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return dense(p.wo, out), new_cache


def gqa_cache_init(cfg, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[torch.device] = None,
                   per_slot_pos: bool = False) -> Dict:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": cache_pos(batch, per_slot_pos, device)}


# --------------------------------------------------------------------- MLA --
class MLA(nn.Module):
    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        dn, dr, dv, kvr = (m.nope_head_dim, m.rope_head_dim, m.v_head_dim,
                           m.kv_lora_rank)
        if m.q_lora_rank:
            self.wq_a = Dense(d, m.q_lora_rank, dtype=dtype)
            self.q_norm = RMSNorm(m.q_lora_rank, dtype)
            self.wq_b = Dense(m.q_lora_rank, h * (dn + dr), dtype=dtype)
        else:
            self.wq = Dense(d, h * (dn + dr), dtype=dtype)
        self.wkv_a = Dense(d, kvr + dr, dtype=dtype)
        self.kv_norm = RMSNorm(kvr, dtype)
        self.wkv_b = Dense(kvr, h * (dn + dv), dtype=dtype)
        self.wo = Dense(h * dv, d, dtype=dtype)


def _mla_q(p: MLA, cfg, x: torch.Tensor):
    m = cfg.mla
    h, dn, dr = cfg.n_heads, m.nope_head_dim, m.rope_head_dim
    b, s, _ = x.shape
    if m.q_lora_rank:
        q = dense(p.wq_b, rmsnorm(p.q_norm, dense(p.wq_a, x), cfg.norm_eps))
    else:
        q = dense(p.wq, x)
    q = splittable(q, 2, h).reshape(b, s, h, dn + dr)
    return q[..., :dn], q[..., dn:]


def mla_scale(cfg) -> float:
    """MLA's softmax scale: 1 / sqrt(nope + rope width), times YaRN's
    ``softmax_mscale`` under ``cfg.rope_scaling``."""
    m = cfg.mla
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    if cfg.rope_scaling is not None:
        scale *= cfg.rope_scaling.softmax_mscale
    return scale


def _mla_attend(cfg, q_nope, q_rope, kv, k_rope, positions,
                kernel: bool, q_start: Optional[int] = None) -> torch.Tensor:
    """Decompressed causal attention over the current tokens: q (B, S, H,
    dn / dr), kv (B, S, H, dn + dv), k_rope (B, S, dr) shared over heads.
    ``kernel`` takes the flash kernel, which needs dn + dr == dv;
    ``q_start`` as in ``chunked_attention``.  Returns (B, S, H·dv)."""
    m = cfg.mla
    h, dn, dr = cfg.n_heads, m.nope_head_dim, m.rope_head_dim
    b, s = q_nope.shape[:2]
    k = torch.cat([kv[..., :dn], k_rope[:, :, None, :].expand(b, s, h, dr)],
                  dim=-1).transpose(1, 2)
    v = kv[..., dn:].transpose(1, 2)
    q = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)
    if kernel:
        # the kernel scales by 1 / sqrt(dn + dr): YaRN's mscale goes on q
        mscale = mla_scale(cfg) * (dn + dr) ** 0.5
        out = _flash(cfg, q * mscale if mscale != 1.0 else q, k, v,
                     causal=True)
    else:
        out = local_attention(q, k, v, causal=True, q_pos=positions,
                              block=cfg.attn_block_kv, scale=mla_scale(cfg),
                              q_start=q_start)
    return out.transpose(1, 2).reshape(b, s, h * m.v_head_dim)


def mla_apply(p: MLA, cfg, x: torch.Tensor, *, positions: torch.Tensor,
              cache: Optional[Dict] = None, slots: Optional[SlotStep] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA self-attention (causal).  x (B, S, d); positions (S,), or (B, S)
    under a per-slot cache; ``cache`` is dict(c_kv, k_rope, pos), pos an
    int or a (B,) int32 tensor, written in place; ``slots`` as in
    ``gqa_apply``.  Prefill and the
    cache-free forward decompress and attend; a continuation chunk
    (``cfg.prefill_continuation``) decompresses the whole written prefix; a
    decode step (S == 1) attends over the compressed cache through the
    absorbed projections."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv, kvr = (m.nope_head_dim, m.rope_head_dim, m.v_head_dim,
                       m.kv_lora_rank)

    # the reference's flash branch: reached only when dn + dr == dv, which
    # no shipped config has (deepseek-v2-lite: 128 + 64 != 128)
    flash = cfg.attention_impl == "pallas" and dn + dr == dv
    q_nope, q_rope = _mla_q(p, cfg, x)
    rp = _rope_positions(positions)
    q_rope = apply_rope(q_rope.transpose(1, 2), rp, cfg.rope_theta,
                        cfg.rope_scaling).transpose(1, 2)
    kv_a = dense(p.wkv_a, x)
    c_kv = rmsnorm(p.kv_norm, kv_a[..., :kvr], cfg.norm_eps)   # (B, S, kvr)
    k_rope = apply_rope(kv_a[:, None, :, kvr:], rp, cfg.rope_theta,
                        cfg.rope_scaling)[:, 0]

    if cache is None:
        kv = splittable(dense(p.wkv_b, c_kv), 2, h).reshape(b, s, h, dn + dv)
        out = _mla_attend(cfg, q_nope, q_rope, kv, k_rope, positions, flash)
        return dense(p.wo, out), None

    pos = cache["pos"]
    ckv_c, krope_c = cache["c_kv"], cache["k_rope"]
    t = ckv_c.shape[1]
    st = None
    if _per_slot(pos):
        _per_slot_only_decode(s)
        st = _slot_step(slots, pos, t)
        _write_rows(ckv_c, c_kv[:, 0], st)
        _write_rows(krope_c, k_rope[:, 0], st)
    else:
        ckv_c[:, pos:pos + s] = c_kv.to(ckv_c.dtype)
        krope_c[:, pos:pos + s] = k_rope.to(krope_c.dtype)
    new_cache = {"c_kv": ckv_c, "k_rope": krope_c,
                 "pos": pos + s if st is None else st.next_pos}

    if s > 1 and cfg.prefill_continuation:
        # continuation chunk: the current tokens attend over the whole
        # written cache, the compressed prefix decompressed through wkv_b
        # and masked to the pos + s valid slots (at pos 0 the mask reduces
        # this to the chunk-local prefill below)
        kv = splittable(dense(p.wkv_b, ckv_c.to(x.dtype)), 2, h).reshape(
            b, t, h, dn + dv)
        k = torch.cat([kv[..., :dn],
                       krope_c[:, :, None, :].to(x.dtype).expand(b, t, h, dr)],
                      dim=-1).transpose(1, 2)
        q = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)
        out = local_attention(q, k, kv[..., dn:].transpose(1, 2),
                              causal=True, q_pos=positions,
                              kv_mask=_kv_valid_mask(t, pos, s, x.device),
                              block=cfg.attn_block_kv, scale=mla_scale(cfg))
        out = out.transpose(1, 2).reshape(b, s, h * dv)
        return dense(p.wo, out), new_cache
    if s > 1:
        # prefill: attend over the current tokens; the flash kernel only on
        # a fresh cache, as the reference's lax.cond on pos == 0; the plain
        # route skips the key blocks after each block of queries
        kv = splittable(dense(p.wkv_b, c_kv), 2, h).reshape(b, s, h, dn + dv)
        out = _mla_attend(cfg, q_nope, q_rope, kv, k_rope, positions,
                          flash and cfg.fresh_prefill_kernel and pos == 0,
                          q_start=pos)
        return dense(p.wo, out), new_cache

    # absorbed decode: w_uk (kvr, h, dn), w_uv (kvr, h, dv); every product
    # that touches the cache reads it in its own dtype and sums in fp32
    wkv_b = splittable(p.wkv_b.w, 1, h).reshape(kvr, h, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    f32 = torch.float32
    q_abs = torch.einsum("bhd,khd->bhk", q_nope[:, 0].to(f32),
                         w_uk.to(f32))                            # (B, H, kvr)
    sc = torch.einsum("bhk,btk->bht", q_abs.to(ckv_c.dtype).to(f32),
                      ckv_c.to(f32))
    sc = sc + torch.einsum("bhr,btr->bht",
                           q_rope[:, 0].to(krope_c.dtype).to(f32),
                           krope_c.to(f32))
    keep = (_kv_valid_mask(t, pos, 1, x.device)[None, None, :]
            if st is None else st.valid[:, None, :])
    sc = torch.where(keep, sc * mla_scale(cfg), NEG_INF)
    attn = torch.softmax(sc, dim=-1)
    out_c = torch.einsum("bht,btk->bhk", attn.to(ckv_c.dtype).to(f32),
                         ckv_c.to(f32))
    out = torch.einsum("bhk,khd->bhd", out_c.to(w_uv.dtype).to(f32),
                       w_uv.to(f32))
    out = out.reshape(b, 1, h * dv).to(x.dtype)
    return dense(p.wo, out), new_cache


def mla_cache_init(cfg, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[torch.device] = None,
                   per_slot_pos: bool = False) -> Dict:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.rope_head_dim),
                                  dtype=dtype, device=device),
            "pos": cache_pos(batch, per_slot_pos, device)}
