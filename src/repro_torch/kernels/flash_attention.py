"""Flash attention (prefill) on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas`` and
the carry form the reference emits over ``_flash_graph`` (whose final
running max and denominator ``stats=True`` returns).  bf16 runs on the
tensor cores (``mma.sync``, fp32 scores and accumulators, P rounded to bf16
before P·V); fp32 keeps fp32 products on the CUDA cores.  The kernel takes q, k
and v through their strides (the last dim contiguous), so the model's
transposed (B, S, H, D) -> (B, H, S, D) views go in without a copy, and it
masks the ragged edges of S, T and D itself.  ``built`` says which pump
cases exist for a head dim and dtype.  ``launches`` counts the kernel's
launches; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from ..core.ir import PumpSpec
from . import _build
from ._build import DtypeError, InputError, KernelError

MAX_HEAD_DIM = 128             # D % 4 == 0, run in a padded width DP
PADDED_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PUMPS = ((1, "T"), (2, "T"), (4, "T"), (2, "R"), (4, "R"))
BQ = BKV = 64                  # q rows of a block, keys of a staged tile
SMEM_BYTES = 227 * 1024

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p,
                       ctypes.c_float, i, i, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def padded_dim(d: int) -> int:
    """The kernel's padded head width for head dim ``d``."""
    return next(dp for dp in PADDED_DIMS if dp >= d)


def smem_bytes(factor: int, mode: str, d: int, dtype: torch.dtype) -> int:
    """Shared memory of a pump case (``csrc/flash_attention.cu``), with
    ``factor`` tiles a transaction in mode T and one in mode R.  bf16
    (``Ring``): a ring of two transactions (one where two do not fit) of
    64-key K and V tiles, rows DP + 8 elements; q is staged through it.
    fp32 (``smem_bytes_fp32``): q (64 x (DP + 4)), the scores (64 x 65)
    and one transaction of K (rows DP + 4) and V (rows DP)."""
    dp = padded_dim(d)
    tiles = factor if mode == "T" else 1
    if dtype == torch.bfloat16:
        stage = 2 * tiles * 2 * BKV * (dp + 8)
        return (2 if 2 * stage <= SMEM_BYTES else 1) * stage
    return 4 * (BQ * (dp + 4) + BQ * (BKV + 1)) \
        + 4 * tiles * BKV * ((dp + 4) + dp)


def built(factor: int, mode: str, d: int, dtype: torch.dtype) -> bool:
    """True where the kernel is built for pump (``factor``, ``mode``) at
    head dim ``d`` in ``dtype``: a listed pump whose shared memory fits 227
    KB (every bf16 case; fp32 T4 up to D 64)."""
    if factor == 1:
        mode = "T"
    return (factor, mode) in PUMPS and dtype in DTYPES \
        and 4 <= d <= MAX_HEAD_DIM and d % 4 == 0 \
        and smem_bytes(factor, mode, d, dtype) <= SMEM_BYTES


def _check(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise InputError(f"flash_attention: {name} is not a CUDA tensor")
    if x.dtype not in DTYPES:
        raise DtypeError(f"flash_attention: {name} dtype {x.dtype} not in "
                         f"{sorted(map(str, DTYPES))}")
    if x.stride(-1) != 1 or any(st % 4 for st in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise InputError(f"flash_attention: {name} needs a contiguous last "
                         f"dim, strides that are multiples of 4 and a "
                         f"16-byte aligned start; got strides {x.stride()}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = False, scale: Optional[float] = None,
                         pump: Union[PumpSpec, int, Tuple[int, str]] = 1,
                         stats: bool = False):
    """q (B, H, S, D), k / v (B, Hkv, T, D), one dtype (fp32 or bf16) ->
    o (B, H, S, D) in that dtype; with ``stats`` also the fp32 (B, H, S)
    final running max m and denominator l.  ``pump`` (a factor, a
    ``PumpSpec`` or ``(factor, mode)``) changes how the kernel walks the
    keys, never the values; a case outside ``built`` raises."""
    global launches
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise InputError(f"flash_attention: {name} must be 4-D, "
                             f"got {tuple(x.shape)}")
        _check(name, x)
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, t, d) or v.shape != k.shape:
        raise InputError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise DtypeError("flash_attention: q, k and v must share a dtype")
    if not (q.device == k.device == v.device):
        raise InputError("flash_attention: q, k and v are on different devices")
    if hkv == 0 or h % hkv:
        raise InputError(f"flash_attention: H={h} not divisible by Hkv={hkv}")
    if d % 4 or not 4 <= d <= MAX_HEAD_DIM:
        raise InputError(f"flash_attention: head dim {d} is not a multiple "
                         f"of 4 in [4, {MAX_HEAD_DIM}]")
    if t == 0:
        raise InputError("flash_attention: empty key sequence")
    spec = PumpSpec.of(pump)
    if not built(spec.factor, spec.mode, d, q.dtype):
        raise InputError(f"flash_attention: no kernel for M={spec.factor} "
                         f"mode {spec.mode} at D {d} in {q.dtype}; built "
                         f"for {PUMPS} where the panel fits "
                         f"{SMEM_BYTES} B")
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    m = l_ = None
    if stats:
        m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        l_ = torch.empty_like(m)
    if b == 0 or s == 0:
        return (out, m, l_) if stats else out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    scale = d ** -0.5 if scale is None else scale
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), m.data_ptr() if stats else None,
                        l_.data_ptr() if stats else None, DTYPES[q.dtype],
                        b, h, hkv, s, t, d, strides, float(scale),
                        int(bool(causal)), spec.factor,
                        int(spec.mode == "R"), stream)
    if err:
        raise KernelError(f"flash_attention kernel launch failed: CUDA "
                          f"error {err}")
    launches += 1
    return (out, m, l_) if stats else out
