"""Decode attention on Hopper: the wrapper of ``csrc/decode_attention.cu``.

Replaces the carry-form kernel ``repro.compiler.pallas_backend.emit_pallas``
writes for ``repro.core.autopump._decode_attention_graph``.  The kernel is
split over the keys in one launch: each (kv head, batch row) pair's 64-key
tiles are cut into ``splits(...)`` runs of whole tiles, one block each,
and the pair's blocks form a thread block cluster whose rank 0 folds the
blocks' partial softmax states in split order through distributed shared
memory.  Within a block, a ring of two ``cp.async`` transactions and eight
warps, each with its own online softmax over 8 keys of every tile.  q is
bf16 or fp32; the cache is fp32 or bf16 and is read in its own dtype.
``built`` says which pump cases exist for a head dim, group and cache
dtype.  ``launches`` counts the kernel's launches; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from ..core.ir import PumpSpec
from ..core.pump_plan import SMEM_BYTES, SMS
from . import _build
from ._build import DtypeError, InputError, KernelError
from .ref import pos_vector

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LANE_SLOTS = 8            # (head, 4-element chunk) slots a lane holds
PUMPS = ((1, "T"), (2, "T"), (4, "T"), (2, "R"), (4, "R"))
BKV = 64                      # keys of a staged tile
WARPS = 8                     # warps of a block, BKV / WARPS keys of a tile each
RING = 2                      # transactions in flight
MAX_SPLITS = 8                # the portable cluster size

launches = 0
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("decode_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                             i, ctypes.c_float, i, i, p]
        lib.decode_attention_fwd.restype = i
        lib.decode_attention_splits.argtypes = [i, i, i, i, i]
        lib.decode_attention_splits.restype = i
        _lib = lib
    return _lib


def splits(b: int, hkv: int, t: int, d: int, kv_dtype: torch.dtype) -> int:
    """Blocks per (kv head, batch row) pair, each a run of whole 64-key
    tiles (``csrc/decode_attention.cu::splits``): as many as fill the
    ``SMS`` SMs in one wave at the blocks an SM holds with T1's ring (two
    tiles of K and V in the cache dtype), at most ``MAX_SPLITS`` and one per
    tile, then evened out so that every split but the last holds
    ceil(tiles / S) tiles.  A function of the shape alone."""
    tiles = -(-t // BKV)
    ring = RING * BKV * 2 * d * kv_dtype.itemsize
    per_sm = max(1, SMEM_BYTES // ring)
    s = max(1, min(SMS * per_sm // max(b * hkv, 1), MAX_SPLITS, tiles))
    tps = -(-tiles // s)
    return -(-tiles // tps)


def kernel_splits(b: int, hkv: int, t: int, d: int,
                  kv_dtype: torch.dtype) -> int:
    """``splits`` as the built kernel computes it (for checking the two
    agree on the card)."""
    return _kernel().decode_attention_splits(b, hkv, t, d,
                                             DTYPES[kv_dtype])


def lane_slots(group: int, d: int) -> int:
    """(head, chunk) slots a lane holds (``csrc/decode_attention.cu::
    lane_slots``): the group's heads of d / 4 chunks, each rounded up to a
    power of two, over 32 lanes."""
    pitch = 1
    while pitch < d // 4:
        pitch *= 2
    return -(-group * pitch // 32)


def smem_bytes(factor: int, mode: str, group: int, d: int,
               kv_dtype: torch.dtype) -> int:
    """Shared memory of a pump case (``csrc/decode_attention.cu::
    smem_bytes``): the ring of two transactions of K and V panels in the
    cache dtype (``factor`` tiles a transaction in mode T, one in mode R),
    which the fp32 partials reuse after the walk: the eight warps' acc, m
    and l, then the block's m and l."""
    tiles = factor if mode == "T" else 1
    ring = RING * tiles * BKV * 2 * d * kv_dtype.itemsize
    return max(ring, 4 * (WARPS * group * (d + 2) + 2 * group))


def built(factor: int, mode: str, group: int, d: int,
          kv_dtype: torch.dtype) -> bool:
    """True where the kernel is built for pump (``factor``, ``mode``) at
    head dim ``d`` with ``group`` q heads per kv head and a ``kv_dtype``
    cache: a listed pump, a head group whose slots a lane holds, mode R's
    sub-tiles whole 4-element chunks, and a ring that fits 227 KB (at D
    128: T2 only for a bf16 cache, T4 for neither)."""
    if factor == 1:
        mode = "T"
    return (factor, mode) in PUMPS and kv_dtype in DTYPES \
        and d % 4 == 0 and d > 0 and group > 0 \
        and lane_slots(group, d) <= MAX_LANE_SLOTS \
        and (mode == "T" or d % (4 * factor) == 0) \
        and smem_bytes(factor, mode, group, d, kv_dtype) <= SMEM_BYTES


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          pos: Union[int, torch.Tensor], *,
                          scale: Optional[float] = None,
                          pump: Union[PumpSpec, int, Tuple[int, str]] = 1
                          ) -> torch.Tensor:
    """q (B, H, D); caches (B, Hkv, T, D); ``pos`` a scalar or (B,) int:
    keys t <= pos[b] count.  Returns (B, H, D) in q's dtype.  ``pump`` (a
    factor, a ``PumpSpec`` or ``(factor, mode)``) changes how the kernel
    walks the keys, never the values; a case outside ``built`` raises."""
    global launches
    if q.dim() != 3 or k_cache.dim() != 4:
        raise InputError(f"decode_attention: q {tuple(q.shape)} must be 3-D "
                         f"and the cache {tuple(k_cache.shape)} 4-D")
    b, h, d = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape != (b, hkv, t, d) or v_cache.shape != k_cache.shape:
        raise InputError(f"decode_attention: caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not x.is_cuda:
            raise InputError(f"decode_attention: {name} is not a CUDA tensor")
        if x.dtype not in DTYPES:
            raise DtypeError(f"decode_attention: {name} dtype {x.dtype} not "
                             f"supported")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise InputError(f"decode_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    if v_cache.dtype != k_cache.dtype:
        raise DtypeError("decode_attention: k and v caches must share a dtype")
    if not (q.device == k_cache.device == v_cache.device):
        raise InputError("decode_attention: inputs are on different devices")
    if hkv == 0 or h % hkv or d % 4 or d == 0 \
            or lane_slots(h // hkv, d) > MAX_LANE_SLOTS or t == 0:
        raise InputError(f"decode_attention: unsupported shape H={h} "
                         f"Hkv={hkv} T={t} D={d}")
    spec = PumpSpec.of(pump)
    if not built(spec.factor, spec.mode, h // hkv, d, k_cache.dtype):
        raise InputError(f"decode_attention: no kernel for M={spec.factor} "
                         f"mode {spec.mode} at D {d}, group {h // hkv}, "
                         f"cache {k_cache.dtype}; built for {PUMPS} where "
                         f"the ring fits {SMEM_BYTES} B")
    posv = pos_vector(pos, b, q.device)
    if posv.shape != (b,) or posv.dtype != torch.int32:
        raise InputError(f"decode_attention: pos must be a scalar or ({b},) "
                         f"int32, got {tuple(posv.shape)} {posv.dtype}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    scale = d ** -0.5 if scale is None else scale
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel().decode_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            posv.data_ptr(), out.data_ptr(), DTYPES[q.dtype],
            DTYPES[k_cache.dtype], b, h, hkv, t, d, float(scale),
            spec.factor, int(spec.mode == "R"), stream)
    if err:
        raise KernelError(f"decode_attention kernel launch failed: CUDA "
                          f"error {err}")
    launches += 1
    return out
