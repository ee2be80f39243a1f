"""Mamba-2 block (SSD, state-space duality): the port of ``repro.models.ssm``.

Block structure: in-proj → short causal conv → SSD scan → gated out-proj.
Two SSD routes, selected by ``cfg.ssm_impl`` as in the reference:

  - ``xla``: ``_ssd_chunked``, plain chunked torch with a Python loop over
    chunks for the state carry, a mirror of the reference's ``_ssd_xla``.
  - ``pallas``: the hand-written CUDA kernels through ``kernels.ops``: the
    SSD scan for every prefill (with its final-state output when a cache is
    filled) and the SSD decode step for every cached one-token step.  On
    CPU tensors the ops take their plain versions.  Under
    ``kernel_plan='measure'`` both go through the plan registry
    (``compiler.registry``: bucketed, measured pump plans), as in the
    reference; under ``'direct'`` through ``kernels.ops`` at pump 1.  The
    reference takes its kernels only under ``'measure'``; in the port
    ``ssm_impl='pallas'`` selects them under either policy.

Decode keeps a recurrent state (B, H, N, P) in fp32 and the conv tail
(B, W - 1, conv_dim) per layer.  The step is position-free, so ``pos`` is
bookkeeping: an int, or per slot an int32 (B,) tensor
(``mamba2_cache_init(per_slot_pos=True)``).

A continuation chunk (``cfg.prefill_continuation``) starts from the cached
state, as in the reference: the conv window is seeded from the cached
tail, the chunk is scanned from a zero state (under ``ssm_impl='pallas'``
by the scan kernel with its final state, under either kernel plan), and
the exact initial-state correction is plain torch: with s0 the cached
state, y_t gains C_t·s0·exp(cumsum_t A·dt) and the final state
s0·exp(sum A·dt).  Both terms are zero at s0 = 0.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

from .layers import (Dense, RMSNorm, SlotStep, cache_pos, dense, local_map,
                     rmsnorm, splittable)


class Mamba2(nn.Module):
    """Mixer parameters, named as the reference params tree."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        d_in = s.expand * d
        n_heads = d_in // s.head_dim
        gn = s.n_groups * s.state_dim
        conv_dim = d_in + 2 * gn
        # fused input projection: [z (gate), x, B, C, dt]
        self.in_proj = Dense(d, 2 * d_in + 2 * gn + n_heads, dtype=dtype)
        self.conv_w = nn.Parameter(torch.empty(s.conv_width, conv_dim,
                                               dtype=dtype))
        self.conv_b = nn.Parameter(torch.empty(conv_dim, dtype=dtype))
        self.A_log = nn.Parameter(torch.empty(n_heads, dtype=dtype))
        self.dt_bias = nn.Parameter(torch.empty(n_heads, dtype=dtype))
        self.D = nn.Parameter(torch.empty(n_heads, dtype=dtype))
        self.norm = RMSNorm(d_in, dtype)
        self.out_proj = Dense(d_in, d, dtype=dtype)


def _split_proj(cfg, proj: torch.Tensor):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    gn = s.n_groups * s.state_dim
    z, xbc, dt = torch.split(splittable(proj, proj.dim() - 1, 1),
                             [d_in, d_in + 2 * gn, n_heads], dim=-1)
    return z, xbc, dt, d_in, n_heads, gn


def _causal_conv(window: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time.  window (B, W - 1 + L, C): the L
    tokens after the W - 1 before them; w (W, C).  Returns (B, L, C)."""
    wdt = w.shape[0]
    l = window.shape[1] - wdt + 1
    out = sum(window[:, i:i + l, :] * w[i] for i in range(wdt))
    return F.silu(out + b)


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in plain torch, a mirror of the reference's ``_ssd_xla``
    (``repro/models/ssm.py:66-126``): group-aware einsums with a per-group
    ``cb``, fp32 decay cumsum and state carry.  The reference feeds bf16
    operands to the MXU with fp32 accumulation (``cdt``); here each operand
    is rounded to ``cdt`` and multiplied in fp32, which is exact for bf16
    products, so only the summation order differs.  L must divide by
    ``chunk``.  Returns y in x's dtype and the fp32 (B, H, N, P) state."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    nch = l // chunk
    cdt = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    f32 = torch.float32

    def rnd(t: torch.Tensor) -> torch.Tensor:      # a cdt operand, in fp32
        return t.to(cdt).to(f32)

    xg = rnd(x.reshape(b, nch, chunk, g, hpg, p))
    dtg = dt.reshape(b, nch, chunk, g, hpg).to(f32)
    Bc = rnd(B.reshape(b, nch, chunk, g, n))
    Cc = rnd(C.reshape(b, nch, chunk, g, n))
    Ag = A.reshape(g, hpg)
    logp = torch.cumsum(Ag * dtg, dim=2)                   # (b,nch,c,g,j)

    # intra-chunk dual form; cb is per group, the decay per head
    cb = torch.einsum("bncgk,bnsgk->bngcs", Cc, Bc)       # (b,nch,g,c,c)
    lp_t = logp.permute(0, 1, 3, 4, 2)                    # (b,nch,g,j,c)
    diff = lp_t[..., :, None] - lp_t[..., None, :]        # (b,nch,g,j,c,c)
    t_idx = torch.arange(chunk, device=x.device)
    mask = t_idx[:, None] >= t_idx[None, :]
    dt_t = dtg.permute(0, 1, 3, 4, 2)                     # (b,nch,g,j,c)
    G = torch.where(mask, cb[:, :, :, None]
                    * torch.exp(torch.where(mask, diff, 0.0))
                    * dt_t[..., None, :], 0.0)
    y_intra = torch.einsum("bngjcs,bnsgjp->bncgjp", rnd(G), xg)

    # inter-chunk state scan (fp32 carry)
    w = torch.exp(lp_t[..., -1:] - lp_t) * dt_t           # (b,nch,g,j,c)
    chunk_contrib = torch.einsum("bncgk,bngjc,bncgjp->bngjkp", Bc, rnd(w), xg)
    chunk_decay = torch.exp(lp_t[..., -1])                # (b,nch,g,j)
    s = torch.zeros((b, g, hpg, n, p), dtype=f32, device=x.device)
    starts = []
    for i in range(nch):
        starts.append(s)
        s = s * chunk_decay[:, i, ..., None, None] + chunk_contrib[:, i]
    s_starts = torch.stack(starts, dim=1)                 # (b,nch,g,j,n,p)
    y_carry = torch.einsum("bncgk,bngjkp,bncgj->bncgjp", Cc, rnd(s_starts),
                           rnd(torch.exp(logp)))
    y = (y_intra + y_carry).reshape(b, l, h, p)
    return y.to(x.dtype), s.reshape(b, h, n, p)


def _ssd_step(state: torch.Tensor, xh: torch.Tensor, dt1: torch.Tensor,
              A: torch.Tensor, Bg: torch.Tensor, Cg: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One plain recurrent step: the fp32 state (B, H, N, P) decays by
    exp(A dt) and takes dt B x; y = C · state (B, H, P)."""
    hpg = xh.shape[1] // Bg.shape[1]
    Bh = Bg.repeat_interleave(hpg, dim=1)
    Ch = Cg.repeat_interleave(hpg, dim=1)
    decay = torch.exp(A[None] * dt1)                              # (B,H)
    upd = torch.einsum("bhn,bhp->bhnp", Bh.float() * dt1[..., None],
                       xh.float())
    state = state * decay[..., None, None] + upd
    return torch.einsum("bhn,bhnp->bhp", Ch.float(), state), state


def mamba2_apply(p: Mamba2, cfg, x: torch.Tensor, *,
                 cache: Optional[Dict] = None,
                 slots: Optional[SlotStep] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, L, d) -> (out, new_cache).  cache: dict(state, conv, pos);
    ``slots``: a per-slot decode step's shared next ``pos``."""
    s = cfg.ssm
    b, l, _ = x.shape
    proj = dense(p.in_proj, x)
    z, xbc, dt, d_in, n_heads, gn = _split_proj(cfg, proj)
    dt = F.softplus(dt + p.dt_bias.to(dt.dtype))                  # (B,L,H)
    A = -torch.exp(p.A_log.float())                               # (H,)
    kernels = cfg.ssm_impl == "pallas"

    if cache is not None and l == 1:
        # single-token recurrent step
        window = torch.cat([cache["conv"], xbc], dim=1)           # (B,W,C)
        w = p.conv_w.to(x.dtype)
        conv_out = F.silu((window * w).sum(dim=1, keepdim=True)
                          + p.conv_b.to(x.dtype))
        new_conv = window[:, 1:]
        xs, B_, C_ = torch.split(splittable(conv_out, 2, 1),
                                 [d_in, gn, gn], dim=-1)
        xh = xs.reshape(b, n_heads, s.head_dim)
        Bg = B_.reshape(b, s.n_groups, s.state_dim)
        Cg = C_.reshape(b, s.n_groups, s.state_dim)
        dt1 = dt[:, 0]                                            # (B,H)
        state = cache["state"].float()
        if kernels and cfg.kernel_plan == "measure":
            from repro_torch.compiler.registry import default_registry
            y, state = default_registry().ssd_decode(state, xh, dt1, A,
                                                     Bg, Cg)
        elif kernels:
            y, state = ops.ssd_decode(state, xh, dt1, A, Bg, Cg)
        else:
            y, state = local_map(_ssd_step, (state, xh, dt1, A, Bg, Cg),
                                 ((0,), (0,), (0,), None, (0,), (0,)),
                                 [(0,), (0,)])
        y = y + p.D.float()[None, :, None] * xh.float()
        y = y.reshape(b, 1, d_in).to(x.dtype)
        new_cache = {"state": state.to(cache["state"].dtype),
                     "conv": new_conv, "pos": cache["pos"] + 1
                     if slots is None else slots.next_pos}
    else:
        cont = cache is not None and cfg.prefill_continuation
        wdt = s.conv_width
        # the W - 1 tokens before the chunk: a continuation's cached tail
        # (so token 0 sees the previous chunk's last tokens), else zeros
        before = cache["conv"].to(x.dtype) if cont else \
            xbc.new_zeros(b, wdt - 1, xbc.shape[-1])
        window = torch.cat([before, xbc], dim=1)
        conv_out = _causal_conv(window, p.conv_w.to(x.dtype),
                                p.conv_b.to(x.dtype))
        xs, B_, C_ = torch.split(splittable(conv_out, 2, 1),
                                 [d_in, gn, gn], dim=-1)
        xh = xs.reshape(b, l, n_heads, s.head_dim)
        Bg = B_.reshape(b, l, s.n_groups, s.state_dim)
        Cg = C_.reshape(b, l, s.n_groups, s.state_dim)
        if kernels:
            # the kernel masks a ragged L itself, so it keeps the configured
            # chunk where the plain route below falls back to chunk 1 (the
            # registry fits it to the length bucket)
            if cfg.kernel_plan == "measure":
                from repro_torch.compiler.registry import default_registry
                scan = default_registry().ssd_scan
            else:
                scan = ops.ssd_scan
            out = scan(xh, dt, A, Bg, Cg, chunk=s.chunk,
                       final_state=cache is not None)
            y, s_final = out if cache is not None else (out, None)
        else:
            chunk = min(s.chunk, l)
            if l % chunk:
                chunk = 1
            y, s_final = local_map(
                lambda *a: _ssd_chunked(*a, chunk), (xh, dt, A, Bg, Cg),
                ((0,), (0,), None, (0,), (0,)), [(0,), (0,)])
        if cont:
            # the exact initial-state correction on the zero-state scan
            s0 = cache["state"].float()                            # (B,H,N,P)
            lp = torch.cumsum(A[None, None, :] * dt.float(), dim=1)  # (B,L,H)
            hpg = n_heads // s.n_groups
            Ch = Cg.repeat_interleave(hpg, dim=2).float()
            y_init = torch.einsum("blhn,bhnp->blhp", Ch, s0) \
                * torch.exp(lp)[..., None]
            y = (y.float() + y_init).to(xh.dtype)
            s_final = s_final.float() \
                + s0 * torch.exp(lp[:, -1])[..., None, None]
        y = y + p.D.to(y.dtype)[None, None, :, None] * xh
        y = y.reshape(b, l, d_in)
        new_cache = None
        if cache is not None:
            # prefill: store the final SSD state and the conv tail, off the
            # window, so a chunk shorter than it keeps the earlier tokens
            tail = window[:, -(wdt - 1):]
            new_cache = {"state": s_final.to(cache["state"].dtype),
                         "conv": tail.to(cache["conv"].dtype),
                         "pos": cache["pos"] + l}

    y = rmsnorm(p.norm, y * F.silu(z), cfg.norm_eps)
    return dense(p.out_proj, y), new_cache


def mamba2_cache_init(cfg, batch: int, dtype: torch.dtype = torch.bfloat16,
                      device: Optional[torch.device] = None,
                      per_slot_pos: bool = False) -> Dict:
    """Recurrent state (fp32) and conv tail (``dtype``) of one layer.  The
    step is position-free; ``pos`` is bookkeeping, an int, or per slot an
    int32 (B,) tensor."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    return {
        "state": torch.zeros((batch, n_heads, s.state_dim, s.head_dim),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "pos": cache_pos(batch, per_slot_pos, device),
    }
