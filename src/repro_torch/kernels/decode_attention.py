"""Decode attention on Hopper: the wrapper of ``csrc/decode_attention.cu``.

Replaces the carry-form kernel ``repro.compiler.pallas_backend.emit_pallas``
writes for ``repro.core.autopump._decode_attention_graph``.  q is bf16 or
fp32; the cache is fp32 or bf16 and is read in its own dtype.  ``launches``
counts the kernel's launches; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from . import _build
from .ref import pos_vector

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP_DIMS = 1024         # (H / Hkv) * D a block holds in registers

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").decode_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
        _fn = fn
    return _fn


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          pos: Union[int, torch.Tensor], *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, D); caches (B, Hkv, T, D); ``pos`` a scalar or (B,) int:
    keys t <= pos[b] count.  Returns (B, H, D) in q's dtype."""
    global launches
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} must be 3-D "
                         f"and the cache {tuple(k_cache.shape)} 4-D")
    b, h, d = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape != (b, hkv, t, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not x.is_cuda:
            raise ValueError(f"decode_attention: {name} is not a CUDA tensor")
        if x.dtype not in DTYPES:
            raise TypeError(f"decode_attention: {name} dtype {x.dtype} not "
                            f"supported")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    if v_cache.dtype != k_cache.dtype:
        raise TypeError("decode_attention: k and v caches must share a dtype")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("decode_attention: inputs are on different devices")
    if hkv == 0 or h % hkv or d % 4 or (h // hkv) * d > MAX_GROUP_DIMS \
            or t == 0:
        raise ValueError(f"decode_attention: unsupported shape H={h} "
                         f"Hkv={hkv} T={t} D={d}")
    posv = pos_vector(pos, b, q.device)
    if posv.shape != (b,) or posv.dtype != torch.int32:
        raise ValueError(f"decode_attention: pos must be a scalar or ({b},) "
                         f"int32, got {tuple(posv.shape)} {posv.dtype}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    scale = d ** -0.5 if scale is None else scale
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        posv.data_ptr(), out.data_ptr(), DTYPES[q.dtype],
                        DTYPES[k_cache.dtype], b, h, hkv, t, d, float(scale),
                        stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
