"""Public kernel wrappers: the port's ``repro.kernels.ops``.

A CUDA tensor launches the hand-written kernel or raises; a CPU tensor
takes the plain PyTorch version in ``ref``.  Nothing falls back from the
card to the plain version.  The launch counts live on the kernel modules
(``flash_attention.launches``, ``decode_attention.launches``,
``ssd_scan.launches``, ``ssd_decode.launches``, ``vecadd.launches``,
``matmul.launches``, ``stencil.launches``, ``floyd_warshall.launches``,
``grouped_gemm.launches``).

The paper's four kernels take ``pump`` as a factor or a ``PumpSpec`` and
raise the reference's ``ValueError`` for shapes the pump cannot divide, on
either device; ``'auto'`` and ``'measure'`` need the compiler, which is not
ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..core.ir import PumpSpec
from . import decode_attention as _da
from . import flash_attention as _fa
from . import floyd_warshall as _fw
from . import grouped_gemm as _gg
from . import matmul as _mm
from . import ref
from . import ssd_decode as _sd
from . import ssd_scan as _ss
from . import stencil as _st
from . import vecadd as _va


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


# ------------------------------------------------ the paper's four kernels --
def _as_spec(pump: Union[PumpSpec, int, str]) -> PumpSpec:
    if pump in ("auto", "measure"):
        raise NotImplementedError(
            f"pump={pump!r} plans the factor through the compiler, which the "
            f"port does not have yet; pass a factor or a PumpSpec")
    return PumpSpec(factor=pump) if isinstance(pump, int) else pump


def vecadd(x: torch.Tensor, y: torch.Tensor, *, vector_width: int = 8,
           pump: Union[PumpSpec, int, str] = 1) -> torch.Tensor:
    """z = x + y, 1-D, with spatial width V and temporal pump M (paper
    Table 2); any length (the kernel masks the ragged tail)."""
    spec = _as_spec(pump)
    if spec.mode == "R" and vector_width % spec.factor:
        raise ValueError(f"V={vector_width} not divisible by M={spec.factor} "
                         f"in mode R")
    if _route(x, "vecadd"):
        return _va.vecadd_cuda(x, y, vector_width=vector_width, pump=spec)
    return ref.vecadd(x, y)


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 64, bn: int = 64,
           bk: int = 32, pump: Union[PumpSpec, int, str] = 1,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a (M, K) · b (K, N) with a pump-M K stream (paper Table 3), fp32
    accumulation over the whole K, rounded once to ``out_dtype`` (default
    a's).  The default tile is one the kernel is built for (the reference's
    default is 128 x 128 x 128)."""
    spec = _as_spec(pump)
    if spec.mode == "R" and bn % spec.factor:
        raise ValueError(f"bn={bn} not divisible by M={spec.factor} for "
                         f"mode R")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    if _route(a, "matmul"):
        return _mm.matmul_cuda(a, b, bm=bm, bn=bn, bk=bk, pump=spec,
                               out_dtype=out_dtype)
    return ref.matmul(a, b, out_dtype=out_dtype or a.dtype)


def stencil_chain(x: torch.Tensor, stages: int, *, kind: str = "jacobi",
                  coef: float = 0.1,
                  pump: Union[PumpSpec, int, str] = 1) -> torch.Tensor:
    """``stages`` 7-point stages (jacobi or diffusion) over a (d0, d1, d2)
    volume, M interior planes per program (paper Tables 4-5)."""
    f = _as_spec(pump).factor
    if (x.shape[0] - 2) % f:
        raise ValueError("interior plane count must divide the pump factor")
    if _route(x, "stencil_chain"):
        return _st.stencil_chain_cuda(x, stages, kind=kind, coef=coef,
                                      pump=f)
    return ref.stencil_chain(x, stages, kind=kind, coef=coef)


def floyd_warshall(dist: torch.Tensor, *,
                   pump: Union[PumpSpec, int, str] = 1) -> torch.Tensor:
    """All-pairs shortest paths, M dependent pivots per slab (paper
    Table 6)."""
    f = _as_spec(pump).factor
    n = dist.shape[0]
    if n % f:
        raise ValueError(f"n={n} must divide pump factor {f}")
    if _route(dist, "floyd_warshall"):
        return _fw.floyd_warshall_cuda(dist, pump=f)
    return ref.floyd_warshall(dist)


# ------------------------------------------------------- the grouped GEMM --
def grouped_gemm(x: torch.Tensor, w: torch.Tensor, *, bc: int = 16,
                 bf: int = 128, bd: int = 32,
                 pump: Union[PumpSpec, int, str] = 1,
                 group_sizes: Optional[Sequence[int]] = None,
                 tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-expert batched GEMM, the MoE hot spot, with a pump-M contraction
    stream (the reference's ``ops.grouped_gemm``).  Three forms, each summed
    over the whole D in fp32 and rounded once to x's dtype:

    - dense (no ``group_sizes``, no ``tiles``): x (E, C, D) · w (E, D, F)
      -> (E, C, F);
    - ragged, ``group_sizes`` a sequence of per-expert row counts: x is the
      (sum, D) row-major concatenation of the groups and the result keeps
      that layout;
    - ragged, ``tiles`` a table from ``grouped_gemm.tile_table`` on x's
      device with row counts of at most ``bc``: x (rows, D) in the layout
      the table describes, the result (rows, F), zero where no tile covers
      a row.  This is the form a routing made on the card uses.

    The kernel masks a ragged C, F, D or group where the reference pads
    it, so every ``bc`` serves every size.  The default tile is one the
    kernel is built for (the reference's is 128 x 128 x 128)."""
    spec = _as_spec(pump)
    if spec.mode == "R" and bf % spec.factor:
        raise ValueError(f"bf={bf} not divisible by M={spec.factor} in "
                         f"mode R")
    if w.dim() != 3:
        raise ValueError(f"grouped_gemm: w must be (E, D, F), got "
                         f"{tuple(w.shape)}")
    e, d, f = w.shape
    if group_sizes is not None:
        if tiles is not None:
            raise ValueError("grouped_gemm: pass group_sizes or tiles, not "
                             "both")
        sizes = [int(sz) for sz in group_sizes]
        if x.dim() != 2 or x.shape[0] != sum(sizes):
            raise ValueError(f"ragged x has {x.shape[0]} rows, group_sizes "
                             f"sum to {sum(sizes)}")
        if len(sizes) != e:
            raise ValueError(f"{len(sizes)} group sizes for {e} experts")
        tiles = _gg.tile_table(torch.tensor(sizes, device=x.device), bc,
                               sum(-(-sz // bc) for sz in sizes))
    if tiles is not None:
        if x.dim() != 2 or x.shape[1] != d:
            raise ValueError(f"ragged x {tuple(x.shape)} does not chain with "
                             f"w {tuple(w.shape)}")
        if _route(x, "grouped_gemm"):
            return _gg.grouped_gemm_cuda(x, w, tiles, bc=bc, bf=bf, bd=bd,
                                         pump=spec)
        return ref.ragged_grouped_gemm(x, w, tiles)
    if x.dim() != 3 or x.shape[0] != e or x.shape[2] != d:
        raise ValueError(f"grouped_gemm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    if not _route(x, "grouped_gemm"):
        return ref.grouped_gemm(x, w)
    c = x.shape[1]
    tiles = _gg.tile_table(torch.full((e,), c, device=x.device), bc,
                           e * -(-c // bc))
    out = _gg.grouped_gemm_cuda(x.reshape(e * c, d).contiguous(), w, tiles,
                                bc=bc, bf=bf, bd=bd, pump=spec)
    return out.reshape(e, c, f)
