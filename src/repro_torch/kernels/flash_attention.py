"""Flash attention (prefill) on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``.  The
kernel takes q, k and v through their strides (the last dim contiguous),
so the model's transposed (B, S, H, D) -> (B, H, S, D) views go in without
a copy, and it masks the ragged edges of S and T itself.  ``launches``
counts the kernel's launches; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

HEAD_DIMS = (32, 64, 128)     # instantiated in the kernel
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, ctypes.c_float, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def _check(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"flash_attention: {name} is not a CUDA tensor")
    if x.dtype not in DTYPES:
        raise TypeError(f"flash_attention: {name} dtype {x.dtype} not in "
                        f"{sorted(map(str, DTYPES))}")
    if x.stride(-1) != 1 or any(st % 4 for st in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} needs a contiguous last "
                         f"dim, strides that are multiples of 4 and a "
                         f"16-byte aligned start; got strides {x.stride()}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, S, D), k / v (B, Hkv, T, D), one dtype (fp32 or bf16) ->
    o (B, H, S, D) in that dtype."""
    global launches
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, "
                             f"got {tuple(x.shape)}")
        _check(name, x)
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, t, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v are on different devices")
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: H={h} not divisible by Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if t == 0:
        raise ValueError("flash_attention: empty key sequence")
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    scale = d ** -0.5 if scale is None else scale
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), DTYPES[q.dtype], b, h, hkv, s, t, d,
                        strides, float(scale), int(bool(causal)), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
