"""Pumped vector addition on Hopper: the wrapper of ``csrc/vecadd.cu``.

Replaces ``repro/kernels/vecadd.py::vecadd_pallas`` (paper Table 2).  A
lane's transaction is W = V·M elements in mode T or W = V in mode R,
issued to the adds as M beats of L = V (T) or V/M (R) lanes; a warp moves
its 32 lanes' transactions as one panel of 32·W contiguous elements, each
access instruction 32 lanes wide, in one pass of the grid.  The ragged
tail is masked in the kernel.  fp32 or bf16.  ``launches`` counts the
kernel's launches; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from ..core.ir import PumpSpec
from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256                 # a block
MAX_TX_BYTES = 128            # the widest transaction a lane holds
LANE_COUNTS = (1, 2, 4, 8, 16, 32, 64)

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("vecadd").vecadd_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def transaction(vector_width: int,
                pump: Union[PumpSpec, int] = 1) -> Tuple[int, int]:
    """(W, L): elements per transaction and lanes per beat."""
    pump = PumpSpec.of(pump)
    if pump.mode == "T":
        return vector_width * pump.factor, vector_width
    return vector_width, vector_width // pump.factor


def vecadd_cuda(x: torch.Tensor, y: torch.Tensor, *, vector_width: int = 8,
                pump: Union[PumpSpec, int] = 1) -> torch.Tensor:
    """z = x + y over 1-D contiguous CUDA tensors of one dtype (fp32 or
    bf16), V = ``vector_width`` and M = ``pump.factor`` powers of two."""
    global launches
    pump = PumpSpec.of(pump)
    for name, t in (("x", x), ("y", y)):
        if t.dim() != 1 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"vecadd: {name} must be a contiguous 1-D CUDA "
                             f"tensor, got {tuple(t.shape)} on {t.device}")
    if x.shape != y.shape or x.dtype != y.dtype or x.device != y.device:
        raise ValueError(f"vecadd: x {tuple(x.shape)} {x.dtype} {x.device} "
                         f"and y {tuple(y.shape)} {y.dtype} {y.device} differ")
    if x.dtype not in DTYPES:
        raise TypeError(f"vecadd: dtype {x.dtype} not supported")
    width, lanes = transaction(vector_width, pump)
    tx_bytes = width * x.element_size()
    if width not in LANE_COUNTS or lanes not in LANE_COUNTS \
            or width % lanes or tx_bytes > MAX_TX_BYTES:
        raise ValueError(f"vecadd: V={vector_width}, M={pump.factor} mode "
                         f"{pump.mode} gives a transaction of {width} and "
                         f"beats of {lanes}; the kernel takes powers of two "
                         f"up to {MAX_TX_BYTES} bytes")
    z = torch.empty_like(x)
    for name, t in (("x", x), ("y", y), ("z", z)):
        if t.data_ptr() % min(16, tx_bytes):
            raise ValueError(f"vecadd: {name} is not aligned to the "
                             f"{min(16, tx_bytes)}-byte vector access")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), y.data_ptr(), z.data_ptr(), x.numel(),
                        DTYPES[x.dtype], width, lanes, stream)
    if err:
        raise RuntimeError(f"vecadd kernel launch failed: CUDA error {err}")
    launches += 1
    return z


def grid_steps(n: int, vector_width: int,
               pump: Union[PumpSpec, int] = 1) -> int:
    """Long-path transactions issued: the transaction-count metric of
    ``repro/kernels/vecadd.py:77``."""
    return n // transaction(vector_width, pump)[0]
