"""Pumped matrix product on Hopper: the wrapper of ``csrc/matmul.cu``.

Replaces ``repro/kernels/matmul.py::matmul_pallas`` (paper Table 3).  One
block per (bm, bn) output tile walks K in stages of kw = bk·M (mode T, M
passes of bk) or kw = bk (mode R, the bn/M sub-tiles issued M times),
double-buffered with cp.async.  fp32 FMA math; bf16 inputs are widened to
fp32; the whole K is summed in fp32 and rounded once to the output dtype.
Ragged M, N and K are masked.  ``launches`` counts the kernel's launches;
nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from ..core.ir import PumpSpec
from . import _build
from ._build import DtypeError, InputError, KernelError

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILES = ((64, 64, 32), (64, 128, 32))       # (bm, bn, bk) instantiated
PUMPS = ((1, "T"), (2, "T"), (4, "T"), (1, "R"), (2, "R"), (4, "R"))

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("matmul").matmul_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p] + [i] * 12 + [p]
        fn.restype = i
        _fn = fn
    return _fn


def _vec(t: torch.Tensor) -> bool:
    """Every 4-element chunk of a row is 16-byte aligned."""
    return t.data_ptr() % 16 == 0 and (t.shape[1] * t.element_size()) % 16 == 0


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, bm: int = 64,
                bn: int = 64, bk: int = 32, pump: Union[PumpSpec, int] = 1,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a (M, K) · b (K, N), contiguous CUDA tensors of one dtype (fp32 or
    bf16); the result in ``out_dtype`` (default a's)."""
    global launches
    pump = PumpSpec.of(pump)
    for name, t in (("a", a), ("b", b)):
        if t.dim() != 2 or not t.is_cuda or not t.is_contiguous():
            raise InputError(f"matmul: {name} must be a contiguous 2-D CUDA "
                             f"tensor, got {tuple(t.shape)} on {t.device}")
    if a.shape[1] != b.shape[0] or a.dtype != b.dtype \
            or a.device != b.device:
        raise InputError(f"matmul: a {tuple(a.shape)} {a.dtype} and b "
                         f"{tuple(b.shape)} {b.dtype} do not match")
    if a.dtype not in DTYPES:
        raise DtypeError(f"matmul: dtype {a.dtype} not supported")
    if (bm, bn, bk) not in TILES or (pump.factor, pump.mode) not in PUMPS:
        raise InputError(f"matmul: no kernel for tile {(bm, bn, bk)} with "
                         f"M={pump.factor} mode {pump.mode}; built for tiles "
                         f"{TILES} and pumps {PUMPS}")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if c.numel() == 0:
        return c.to(out_dtype or a.dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                        DTYPES[a.dtype], bm, bn, bk, pump.factor,
                        int(pump.mode == "R"), int(_vec(a)), int(_vec(b)),
                        int(_vec(c)), stream)
    if err:
        raise KernelError(f"matmul kernel launch failed: CUDA error {err}")
    launches += 1
    return c.to(out_dtype or a.dtype)


def transactions(m: int, n: int, k: int, bm: int = 128, bn: int = 128,
                 bk: int = 128, pump: Union[PumpSpec, int] = 1) -> int:
    """Wide K-panel transactions: ``repro/kernels/matmul.py:110``."""
    pump = PumpSpec.of(pump)
    kw = bk * pump.factor if pump.mode == "T" else bk
    return (m // bm) * (n // bn) * (k // kw)


def compute_tile_bytes(bm: int = 128, bn: int = 128,
                       pump: Union[PumpSpec, int] = 1) -> int:
    """Active compute tile per issue, the paper's DSP count:
    ``repro/kernels/matmul.py:119``."""
    pump = PumpSpec.of(pump)
    bn_eff = bn // pump.factor if pump.mode == "R" else bn
    return bm * bn_eff * 4
