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
                    causal: bool = False, scale: Optional[float] = None,
                    stats: bool = False):
    """softmax(q kᵀ · scale) v, q (B, H, S, D), k / v (B, Hkv, T, D).

    The causal mask is top-left aligned, q_pos >= k_pos, as in the Pallas
    kernel (``repro/kernels/flash_attention.py:52-56``); it equals the
    bottom-right ``repro.kernels.ref.attention`` only when S == T.  GQA maps
    q head h to kv head h // (H / Hkv).  ``stats=True`` also returns the
    fp32 (B, H, S) row max m of the masked scaled logits and the
    denominator l = Σ exp(logit - m), what ``_flash_graph``'s carry ends
    with."""
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
    out = out.reshape(b, h, s, v.shape[-1]).to(q.dtype)
    if not stats:
        return out
    m = logits.amax(dim=-1)
    l_ = torch.exp(logits - m[..., None]).sum(dim=-1)
    return out, m.reshape(b, h, s), l_.reshape(b, h, s)


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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int,
             final_state: bool = False):
    """Mamba-2 chunked SSD scan, the Pallas kernel's math
    (``repro/kernels/ssd_scan.py:45-72``, ``_ssd_graph``'s ``step_fn``).

    x (B, L, H, P); dt (B, L, H) post-softplus; A (H,); B / C (B, L, G, N)
    with head h reading group h // (H / G).  fp32 throughout, one loop step
    per chunk.  A ragged L is padded to a chunk multiple with dt = 0 steps,
    which leave the carried state untouched, so the padding is exact.  The
    decay cumsum accumulates in fp64 and rounds once to fp32, so the CPU
    and the card (and the CUDA kernel) agree on it.  Returns y in x's
    dtype and, with ``final_state``, the fp32 (B, H, N, P) state."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    heads = torch.arange(h, device=x.device) // (h // g)
    nch = -(-l // chunk)
    pad = nch * chunk - l
    f32 = torch.float32

    def prep(t: torch.Tensor) -> torch.Tensor:
        t = t.to(f32)
        return torch.nn.functional.pad(t, (0,) * (2 * (t.dim() - 2))
                                       + (0, pad)) if pad else t

    xs = prep(x).transpose(1, 2)                          # (b, h, l', p)
    dts = prep(dt).transpose(1, 2)                        # (b, h, l')
    Bs = prep(B)[:, :, heads].transpose(1, 2)             # (b, h, l', n)
    Cs = prep(C)[:, :, heads].transpose(1, 2)
    Af = A.to(f32)[None, :, None]
    idx = torch.arange(chunk, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    state = torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    ys = []
    for ci in range(nch):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        xc, dtc, bc, cc = xs[:, :, sl], dts[:, :, sl], Bs[:, :, sl], Cs[:, :, sl]
        logp = torch.cumsum(Af * dtc, dim=-1, dtype=torch.float64).to(f32)
        y_carry = torch.exp(logp)[..., None] * (cc @ state)
        cb = cc @ bc.transpose(-1, -2)                    # (b, h, c, c)
        ratio = logp[..., :, None] - logp[..., None, :]
        gmat = torch.where(mask, cb * torch.exp(torch.where(mask, ratio, 0.0))
                           * dtc[..., None, :], 0.0)
        ys.append(y_carry + gmat @ xc)
        p_total = logp[..., -1:]
        w = torch.exp(p_total - logp) * dtc               # (b, h, c)
        state = state * torch.exp(p_total)[..., None] \
            + (bc * w[..., None]).transpose(-1, -2) @ xc
    y = torch.cat(ys, dim=2)[:, :, :l].transpose(1, 2).to(x.dtype)
    return (y, state) if final_state else y


def ssd_decode(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
               A: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """One-token SSD step: ``state' = state·exp(A·dt) + (B·dt)⊗x`` and
    ``y = C·state'`` (``repro/core/autopump.py:564-640``,
    ``registry.py::_ssd_decode_reference``).  state (B, H, N, P); x
    (B, H, P); dt (B, H) post-softplus; A (H,); B / C (B, G, N).  Returns
    (y fp32 (B, H, P), state' fp32 (B, H, N, P))."""
    h, g = x.shape[1], B.shape[1]
    heads = torch.arange(h, device=x.device) // (h // g)
    f32 = torch.float32
    Bh, Ch = B.to(f32)[:, heads], C.to(f32)[:, heads]     # (b, h, n)
    dtf = dt.to(f32)
    decay = torch.exp(A.to(f32)[None] * dtf)
    st = state.to(f32) * decay[..., None, None] \
        + (Bh * dtf[..., None])[..., :, None] * x.to(f32)[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch, st)
    return y, st


# ------------------------------------------------ the paper's four kernels --
def vecadd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """z = x + y (``repro/kernels/ref.py:13``)."""
    return x + y


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a (M, K) · b (K, N) in fp32, rounded once to ``out_dtype``."""
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def _stencil_interior(x: torch.Tensor, kind: str, coef: float) -> torch.Tensor:
    """The updated interior of one stage, summed in the Pallas body's order
    (``repro/kernels/stencil.py:40-51``): the planes before and after, then
    the rows above and below, then the columns left and right."""
    prev, cur, nxt = x[:-2], x[1:-1], x[2:]
    c = cur[:, 1:-1, 1:-1]
    neigh = (prev[:, 1:-1, 1:-1] + nxt[:, 1:-1, 1:-1]
             + cur[:, :-2, 1:-1] + cur[:, 2:, 1:-1]
             + cur[:, 1:-1, :-2] + cur[:, 1:-1, 2:])
    if kind == "jacobi":
        return (neigh + c) * (1.0 / 7.0)
    return c + coef * (neigh - 6.0 * c)


def jacobi3d(x: torch.Tensor) -> torch.Tensor:
    """One 7-point Jacobi stage on a (d0, d1, d2) volume, boundary copied."""
    y = x.clone()
    y[1:-1, 1:-1, 1:-1] = _stencil_interior(x, "jacobi", 0.0)
    return y


def diffusion3d(x: torch.Tensor, coef: float = 0.1) -> torch.Tensor:
    """One explicit diffusion stage, c + coef·(Σ6 − 6c), boundary copied."""
    y = x.clone()
    y[1:-1, 1:-1, 1:-1] = _stencil_interior(x, "diffusion", coef)
    return y


def stencil_chain(x: torch.Tensor, stages: int, kind: str = "jacobi",
                  coef: float = 0.1) -> torch.Tensor:
    """``stages`` stencil stages in a row (``kind`` jacobi or diffusion)."""
    for _ in range(stages):
        x = jacobi3d(x) if kind == "jacobi" else diffusion3d(x, coef)
    return x


def floyd_warshall(dist: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest paths over an (n, n) matrix: for k in order,
    d ← min(d, d[:, k] + d[k, :]) from the d of step k − 1."""
    d = dist
    for k in range(d.shape[0]):
        d = torch.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    return d


# ------------------------------------------------------- the grouped GEMM --
def grouped_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[e] = x[e] · w[e]: x (E, C, D), w (E, D, F) -> (E, C, F) in x's
    dtype, summed over the whole D in fp32 and rounded once."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def ragged_grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                        tiles: torch.Tensor) -> torch.Tensor:
    """The ragged form: x (rows, D) is a row-major concatenation of expert
    row groups, w (E, D, F).  Tile table row i = (expert, first row, row
    count) says that rows [first, first + count) belong to that expert's
    group; expert -1 marks a surplus tile, whose rows are zero.  Returns
    (rows, F) in x's dtype, summed over the whole D in fp32 and rounded
    once; rows no tile covers are zero."""
    rows, f = x.shape[0], w.shape[2]
    out = torch.zeros((rows, f), dtype=torch.float32, device=x.device)
    if tiles.numel() == 0 or rows == 0:
        return out.to(x.dtype)
    ex, r0, nr = tiles.long().unbind(1)
    bc = max(int(nr.max()), 1)
    r = r0[:, None] + torch.arange(bc, device=x.device)[None, :]
    valid = (torch.arange(bc, device=x.device)[None, :] < nr[:, None]) \
        & (r < rows) & (r >= 0)
    row_expert = torch.full((rows,), -1, dtype=torch.long, device=x.device)
    row_expert[r[valid]] = ex[:, None].expand_as(r)[valid]
    for e in range(w.shape[0]):
        sel = (row_expert == e).nonzero().squeeze(1)
        if sel.numel():
            out[sel] = x[sel].float() @ w[e].float()
    return out.to(x.dtype)


# ------------------------------------------------- the fused-region kernel --
def _block_offsets(o, mesh) -> torch.Tensor:
    """Element offset of ``o``'s block at every grid point of ``mesh`` (one
    coordinate tensor per grid axis)."""
    off = torch.full_like(mesh[0], o.base) if mesh else \
        torch.tensor(o.base)
    for c, g in zip(o.coef, mesh):
        if c:
            off = off + c * g
    for axis, vals in o.tables:
        off = off + torch.tensor(vals, device=mesh[axis].device)[mesh[axis]]
    return off


def _block_elems(o, device) -> torch.Tensor:
    r = torch.arange(o.rows, device=device)[:, None] * o.rs
    return r + torch.arange(o.cols, device=device)[None, :] * o.cs


def region_map_reduce(desc, operands, max_elems: int = 1 << 24
                      ) -> torch.Tensor:
    """The region kernel's function (``csrc/region_map_reduce.cu``) on the
    descriptor ``desc`` (``kernels.region_map_reduce.RegionDesc``): gather
    each operand's block at every grid point by its affine map, apply
    ``add`` or the block product in fp32, sum over the reduce axes and
    write each map point's block of the output, rounded once to its dtype.
    The map points are taken in chunks of at most ``max_elems`` gathered
    elements, so the card-size plans fit in memory."""
    in0, in1 = operands
    dev = in0.device
    grid, red = list(desc.grid), list(desc.reduce)
    map_axes = [i for i, r in enumerate(red) if not r]
    red_axes = [i for i, r in enumerate(red) if r]
    n_red = 1
    for i in red_axes:
        n_red *= grid[i]
    n_map = 1
    for i in map_axes:
        n_map *= grid[i]
    a, b = desc.ins
    per_point = n_red * (a.rows * a.cols + b.rows * b.cols)
    chunk = max(1, max_elems // max(per_point, 1))
    out = torch.zeros(desc.out.shape, dtype=getattr(torch, desc.dtype),
                      device=dev)
    flat_out = out.reshape(-1)
    ea, eb = _block_elems(a, dev), _block_elems(b, dev)
    eo = _block_elems(desc.out, dev)
    red_idx = torch.arange(n_red, device=dev)
    for m0 in range(0, n_map, chunk):
        m_idx = torch.arange(m0, min(n_map, m0 + chunk), device=dev)
        # grid coordinates of every (map point, reduce point) pair, the
        # reduce points innermost in plan order
        coords = [None] * len(grid)
        rem = m_idx[:, None]
        for i in reversed(map_axes):
            coords[i] = (rem % grid[i]).expand(-1, n_red)
            rem = rem // grid[i]
        rem = red_idx[None, :]
        for i in reversed(red_axes):
            coords[i] = (rem % grid[i]).expand(m_idx.numel(), -1)
            rem = rem // grid[i]
        ta = in0.reshape(-1)[_block_offsets(a, coords)[..., None, None]
                             + ea].float()
        tb = in1.reshape(-1)[_block_offsets(b, coords)[..., None, None]
                             + eb].float()
        tile = ta + tb if desc.op == "add" else ta @ tb
        tile = tile.sum(dim=1)                 # over the reduce points
        o_off = _block_offsets(desc.out, [c[:, 0] for c in coords])
        flat_out[o_off[:, None, None] + eo] = tile.to(out.dtype)
    return out
