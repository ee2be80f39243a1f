"""Pumped 7-point stencil stages on Hopper: the wrapper of
``csrc/stencil.cu``.

Replaces ``repro/kernels/stencil.py::stencil_step_pallas`` and
``stencil_chain_pallas`` (paper Tables 4-5).  One launch per stage; a
block takes a slab of M interior planes of one (d1, d2) tile with its
halo in shared memory, and copies the boundary.  A chain alternates
between two buffers.  fp32.  ``launches`` counts the kernel's launches
(one per stage); nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from ..core.ir import PumpSpec
from ..core.pump_plan import SMEM_BYTES
from . import _build

KINDS = ("jacobi", "diffusion")
HALO_TILE = 34 * 34           # (32 + 2)^2 cells of one plane in shared memory
MAX_SLABS = 65535             # the grid's z extent, one slab each

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("stencil").stencil_fwd
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, i, i, i, i, i, f, f, p]
        fn.restype = i
        _fn = fn
    return _fn


def _factor(pump: Union[PumpSpec, int]) -> int:
    return pump if isinstance(pump, int) else pump.factor


def stencil_chain_cuda(x: torch.Tensor, stages: int, *, kind: str = "jacobi",
                       coef: float = 0.1,
                       pump: Union[PumpSpec, int] = 1) -> torch.Tensor:
    """``stages`` stages over a contiguous fp32 (d0, d1, d2) CUDA volume, M
    = ``pump`` interior planes per block; returns a new tensor."""
    global launches
    m = _factor(pump)
    if x.dim() != 3 or not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"stencil: x must be a contiguous 3-D CUDA tensor, "
                         f"got {tuple(x.shape)} on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"stencil: dtype {x.dtype} not supported (fp32)")
    if kind not in KINDS:
        raise ValueError(f"stencil: kind {kind!r} not in {KINDS}")
    d0, d1, d2 = x.shape
    if d0 < 2 or (d0 - 2) % m:
        raise ValueError(f"stencil: {d0 - 2} interior planes not divisible "
                         f"by M={m}")
    if (d0 - 2) // m > MAX_SLABS:
        raise ValueError(f"stencil: {(d0 - 2) // m} slabs exceed the grid's "
                         f"{MAX_SLABS}")
    if (m + 2) * HALO_TILE * 4 > SMEM_BYTES:
        raise ValueError(f"stencil: M={m} planes of halo tile exceed "
                         f"{SMEM_BYTES} bytes of shared memory")
    src = x
    bufs = [torch.empty_like(x) for _ in range(min(stages, 2))]
    for s in range(stages):
        dst = bufs[s % 2]
        if d0 == 2 or d1 * d2 == 0:          # no interior plane to launch for
            dst.copy_(src)
        else:
            with torch.cuda.device(x.device):
                stream = torch.cuda.current_stream().cuda_stream
                err = _kernel()(src.data_ptr(), dst.data_ptr(), d0, d1, d2,
                                m, int(kind == "diffusion"), coef, 1.0 / 7.0,
                                stream)
            if err:
                raise RuntimeError(f"stencil kernel launch failed: CUDA "
                                   f"error {err}")
            launches += 1
        src = dst
    return src if stages else x.clone()


def transactions(d0: int, pump: Union[PumpSpec, int] = 1) -> int:
    """Slabs per stage: ``repro/kernels/stencil.py:97``."""
    return (d0 - 2) // _factor(pump)


def slab_bytes(d1: int, d2: int, pump: Union[PumpSpec, int] = 1,
               itemsize: int = 4) -> int:
    """The reference's VMEM slab footprint per grid step, three plane views
    of M planes: ``repro/kernels/stencil.py:103``."""
    return 3 * _factor(pump) * d1 * d2 * itemsize
