"""Pumped Floyd-Warshall on Hopper: the wrapper of
``csrc/floyd_warshall.cu``.

Replaces ``repro/kernels/floyd_warshall.py::floyd_warshall_pallas`` (paper
Table 6).  One launch per slab of M pivots, n / M in all, alternating
between two buffers; each block stages the M x n pivot panel in shared
memory and applies the M dependent steps to its rows.  Bit-exact against
the sequential plain version.  fp32.  ``launches`` counts the kernel's
launches (n / M per call); nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from ..core.ir import PumpSpec
from ..core.pump_plan import SMEM_BYTES
from . import _build

PUMPS = (1, 2, 4, 8, 16)
ROWS = 8                      # rows per block (the kernel's constant)

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("floyd_warshall").floyd_warshall_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def _factor(pump: Union[PumpSpec, int]) -> int:
    return pump if isinstance(pump, int) else pump.factor


def floyd_warshall_cuda(dist: torch.Tensor, *,
                        pump: Union[PumpSpec, int] = 1) -> torch.Tensor:
    """All-pairs shortest paths over a contiguous fp32 (n, n) CUDA matrix;
    returns a new tensor."""
    global launches
    m = _factor(pump)
    if dist.dim() != 2 or dist.shape[0] != dist.shape[1] \
            or not dist.is_cuda or not dist.is_contiguous():
        raise ValueError(f"floyd_warshall: dist must be a contiguous square "
                         f"CUDA matrix, got {tuple(dist.shape)} on "
                         f"{dist.device}")
    if dist.dtype != torch.float32:
        raise TypeError(f"floyd_warshall: dtype {dist.dtype} not supported "
                        f"(fp32)")
    n = dist.shape[0]
    if m not in PUMPS or n % m:
        raise ValueError(f"floyd_warshall: n={n} with M={m}: the kernel takes "
                         f"M in {PUMPS} dividing n")
    if (m * n + ROWS * m + m) * 4 > SMEM_BYTES:
        raise ValueError(f"floyd_warshall: an {m} x {n} pivot panel exceeds "
                         f"{SMEM_BYTES} bytes of shared memory")
    if n == 0:
        return dist.clone()
    bufs = [torch.empty_like(dist), torch.empty_like(dist)]
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(dist.data_ptr(), bufs[0].data_ptr(),
                        bufs[1].data_ptr(), n, m, stream)
    if err:
        raise RuntimeError(f"floyd_warshall kernel launch failed: CUDA error "
                           f"{err}")
    launches += n // m
    return bufs[(n // m - 1) % 2]


def transactions(n: int, pump: Union[PumpSpec, int] = 1) -> int:
    """Pivot slabs: ``repro/kernels/floyd_warshall.py:73``."""
    return n // _factor(pump)
