"""Pumped Floyd-Warshall on Hopper: the wrapper of
``csrc/floyd_warshall.cu``.

Replaces ``repro/kernels/floyd_warshall.py::floyd_warshall_pallas`` (paper
Table 6).  Blocked: the pivots go in rounds of ``ROUND``, two launches a
round.  The first records, for the round's pivots, each pivot row as it
stands before its step (R) and each pivot column likewise (C) into two
small scratch buffers; the second folds min(d, C[i][k] + R[k][j]) over the
round's pivots, in k order, into every element, TILE x TILE a block, the
C / R chunks staged M pivots a transaction.  Bit-exact against the
sequential plain version.  fp32, any n that M divides.  ``launches``
counts the kernel's launches (``launches_per_call`` per call); nothing
else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from ..core.ir import PumpSpec
from . import _build
from ._build import DtypeError, InputError, KernelError

PUMPS = (1, 2, 4, 8, 16)
ROUND = 64                    # pivots a round (the kernel's constant)
TILE = 128                    # scratch rows are padded to a multiple of it

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("floyd_warshall").floyd_warshall_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def _factor(pump: Union[PumpSpec, int]) -> int:
    return pump if isinstance(pump, int) else pump.factor


def launches_per_call(n: int, pump: Union[PumpSpec, int] = 1) -> int:
    """Kernel launches of one call: two a round of ``ROUND`` pivots, whatever
    the pump."""
    return 2 * -(-n // ROUND)


def floyd_warshall_cuda(dist: torch.Tensor, *,
                        pump: Union[PumpSpec, int] = 1) -> torch.Tensor:
    """All-pairs shortest paths over a contiguous fp32 (n, n) CUDA matrix;
    returns a new tensor."""
    global launches
    m = _factor(pump)
    if dist.dim() != 2 or dist.shape[0] != dist.shape[1] \
            or not dist.is_cuda or not dist.is_contiguous():
        raise InputError(f"floyd_warshall: dist must be a contiguous square "
                         f"CUDA matrix, got {tuple(dist.shape)} on "
                         f"{dist.device}")
    if dist.dtype != torch.float32:
        raise DtypeError(f"floyd_warshall: dtype {dist.dtype} not supported "
                         f"(fp32)")
    n = dist.shape[0]
    if m not in PUMPS or n % m:
        raise InputError(f"floyd_warshall: n={n} with M={m}: the kernel takes "
                         f"M in {PUMPS} dividing n")
    if n == 0:
        return dist.clone()
    out = torch.empty_like(dist)
    ld = -(-n // TILE) * TILE
    rbuf = torch.empty(ROUND * ld, dtype=torch.float32, device=dist.device)
    cbuf = torch.empty_like(rbuf)
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(dist.data_ptr(), out.data_ptr(), rbuf.data_ptr(),
                        cbuf.data_ptr(), n, m, stream)
    if err:
        raise KernelError(f"floyd_warshall kernel launch failed: CUDA error "
                          f"{err}")
    launches += launches_per_call(n, m)
    return out


def transactions(n: int, pump: Union[PumpSpec, int] = 1) -> int:
    """Pivot slabs: ``repro/kernels/floyd_warshall.py:73``."""
    return n // _factor(pump)
