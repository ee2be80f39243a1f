"""The SSM family (Mamba-2): a stack of Mamba-2 blocks, each
x += mixer(rmsnorm(x)), then the final norm and the output head (tied to
the embedding where the configuration says so).  Plain fp32 PyTorch from
the equations, imports nothing of the program.

Mamba-2 block, on the pre-normed input u:
    [z, xBC, dt] = u @ in_proj;  dt = softplus(dt + dt_bias);  A = -exp(A_log)
    xBC = silu(causal depthwise conv(xBC) + conv_b);  [x, B, C] = xBC
    s_t = exp(A dt_t) s_{t-1} + dt_t B_t x_t^T;   y_t = C_t s_t + D x_t
    out = rmsnorm(y * silu(z)) @ out_proj
The recurrence is evaluated exactly in its chunked dual form (fp32).
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference.common import (Leaf, Weights, dense_leaf,
                                        embed_leaf, head_leaves, head_logits,
                                        norm_leaf, rmsnorm)


def _sizes(p: Dict):
    s = p["ssm"]
    d = p["d_model"]
    d_in = s["expand"] * d
    nh = d_in // s["head_dim"]
    gn = s["n_groups"] * s["state_dim"]
    return d, d_in, nh, gn, d_in + 2 * gn


def leaves(p: Dict) -> List[Leaf]:
    d, d_in, nh, gn, conv_dim = _sizes(p)
    s = p["ssm"]
    out: List[Leaf] = [embed_leaf(p)] + head_leaves(p)
    for i in range(p["n_layers"]):
        b = f"blocks.{i}."
        out += [norm_leaf(b + "norm.scale", d),
                dense_leaf(b + "mixer.in_proj.w", d, 2 * d_in + 2 * gn + nh),
                (b + "mixer.conv_w", (s["conv_width"], conv_dim), 0.0,
                 s["conv_width"] ** -0.5),
                (b + "mixer.conv_b", (conv_dim,), 0.0, 0.1),
                (b + "mixer.A_log", (nh,), 1.0, 0.5),
                (b + "mixer.dt_bias", (nh,), -3.5, 0.5),
                (b + "mixer.D", (nh,), 1.0, 0.1),
                norm_leaf(b + "mixer.norm.scale", d_in),
                dense_leaf(b + "mixer.out_proj.w", d_in, d)]
    return out


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """y_t = C_t s_t with s_t = exp(A dt_t) s_{t-1} + dt_t B_t x_t^T, s_0 = 0.
    x (L, H, P), dt (L, H), A (H,), B / C (L, N) shared by the heads.
    Exact chunked form: within a chunk the sum over s <= t directly, the
    state carried between chunks."""
    L, H, P = x.shape
    pad = -L % chunk
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    n = x.shape[0] // chunk
    x = x.reshape(n, chunk, H, P)
    dt = dt.reshape(n, chunk, H)
    B = B.reshape(n, chunk, -1)
    C = C.reshape(n, chunk, -1)
    cum = torch.cumsum(dt * A, dim=1)                            # (n, c, H)
    t = torch.arange(chunk, device=x.device)
    lower = (t[:, None] >= t[None, :])[None, :, :, None]         # s <= t
    diff = torch.where(lower, cum[:, :, None, :] - cum[:, None, :, :],
                       float("-inf"))
    cb = torch.einsum("ntk,nsk->nts", C, B)
    w = cb[..., None] * torch.exp(diff) * dt[:, None, :, :]      # (n,t,s,H)
    y = torch.einsum("ntsh,nshp->nthp", w, x)
    # each chunk's own contribution to the state at its end
    tail = torch.exp(cum[:, -1:, :] - cum) * dt                  # (n, c, H)
    contrib = torch.einsum("nsk,nsh,nshp->nhkp", B, tail, x)
    decay = torch.exp(cum[:, -1, :])                             # (n, H)
    state = torch.zeros(H, B.shape[-1], P, device=x.device)
    starts = []
    for i in range(n):
        starts.append(state)
        state = state * decay[i][:, None, None] + contrib[i]
    s0 = torch.stack(starts)                                     # (n,H,N,P)
    y = y + torch.einsum("ntk,nhkp,nth->nthp", C, s0, torch.exp(cum))
    return y.reshape(n * chunk, H, P)[:L]


def mamba(p: Dict, w: Weights, pre: str, u: torch.Tensor) -> torch.Tensor:
    s = p["ssm"]
    d, d_in, nh, gn, conv_dim = _sizes(p)
    L = u.shape[0]
    proj = u @ w(pre + "in_proj.w")
    z, xbc, dt = torch.split(proj, [d_in, conv_dim, nh], dim=-1)
    dt = F.softplus(dt + w(pre + "dt_bias"))
    A = -torch.exp(w(pre + "A_log"))
    cw = w(pre + "conv_w")                                       # (W, C)
    W = cw.shape[0]
    win = torch.cat([xbc.new_zeros(W - 1, conv_dim), xbc])
    conv = sum(win[i:i + L] * cw[i] for i in range(W)) + w(pre + "conv_b")
    xs, Bm, Cm = torch.split(F.silu(conv), [d_in, gn, gn], dim=-1)
    xh = xs.reshape(L, nh, s["head_dim"])
    y = ssd(xh, dt, A, Bm, Cm) + w(pre + "D")[None, :, None] * xh
    y = rmsnorm(y.reshape(L, d_in) * F.silu(z), w(pre + "norm.scale"),
                p["norm_eps"])
    return y @ w(pre + "out_proj.w")


def forward(p: Dict, w: Weights, seqs: List[torch.Tensor],
            starts: List[int]) -> List[torch.Tensor]:
    """Logits (fp32) at positions ``starts[i]`` onwards of each token
    sequence, every layer applied to all sequences before the next."""
    table = w("embed.embedding")
    xs = [table[s.long()] for s in seqs]
    del table
    for i in range(p["n_layers"]):
        pre = f"blocks.{i}."
        xs = [x + mamba(p, w, pre + "mixer.",
                        rmsnorm(x, w(pre + "norm.scale"), p["norm_eps"]))
              for x in xs]
    return [head_logits(p, x[st:], w) for x, st in zip(xs, starts)]


def token_flops(p: Dict, keys: int, head: bool) -> float:
    """Model FLOPs of one token (``keys`` is unused: no attention): every
    projection (2 per weight), the SSD recurrence (state update and
    read-out, 4 H N P a layer), and the output head where ``head``."""
    d, d_in, nh, gn, conv_dim = _sizes(p)
    s = p["ssm"]
    mamba_w = d * (2 * d_in + 2 * gn + nh) + d_in * d
    f = 2.0 * p["n_layers"] * mamba_w
    f += p["n_layers"] * 4.0 * nh * s["state_dim"] * s["head_dim"]
    if head:
        f += 2.0 * d * p["vocab_size"]
    return f
