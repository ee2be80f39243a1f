"""Pumped 7-point stencil stages on Hopper: the wrapper of
``csrc/stencil.cu``.

Replaces ``repro/kernels/stencil.py::stencil_step_pallas`` and
``stencil_chain_pallas`` (paper Tables 4-5).  One launch per stage.  A
block owns one 256-wide tile of the (d1, d2) plane (32 rows, or 16 or 8
where M's ring needs the room) and streams down d0 over a segment of
interior planes: each plane of the tile, with its halo, is staged once
into a ring of shared-memory slots, M planes a ``cp.async`` transaction
with two transactions in flight, and the block runs M dependent beats
over each transaction.  ``plan`` cuts d0 into segments so that the grid
fills the card's resident blocks in one wave.  The boundary
is copied, and a chain alternates between two buffers.  fp32; the kernel
gives the plain version's bits.  ``launches`` counts the kernel's launches
(one per stage); nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple, Union

import torch

from ..core.ir import PumpSpec
from ..core.pump_plan import SMEM_BYTES, SMS
from . import _build

KINDS = ("jacobi", "diffusion")
TILE_X = 256             # the d2 extent of a block's tile
TILE_ROWS = (32, 16, 8)  # its d1 extent: the most whose ring fits
RING = 2                 # transactions of M planes in flight
MIN_SEG = 40             # planes a segment keeps at least: its neighbours
#                          re-read 2 border planes, so 2 / 40 = 5% at most
MAX_GRID_Y = 65535       # the grid's y extent, one tile row each

launches = 0
_fn = None
_occupancy: Dict[Tuple[int, int], int] = {}


class Plan(NamedTuple):
    """A stage's grid: ``tiles_x`` x ``tiles_y`` tiles of ``TILE_X`` x
    ``rows`` cells, each walked by ``segments`` blocks of ``seg`` interior
    planes (the last may be shorter, a multiple of M all the same)."""
    rows: int
    tiles_x: int
    tiles_y: int
    segments: int
    seg: int


def _lib():
    global _fn
    if _fn is None:
        lib = _build.load("stencil")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.stencil_fwd.argtypes = [p, p, i, i, i, i, i, i, f, f, p]
        lib.stencil_fwd.restype = i
        lib.stencil_blocks_per_sm.argtypes = [i, ctypes.POINTER(i)]
        lib.stencil_blocks_per_sm.restype = i
        _fn = lib
    return _fn


def _factor(pump: Union[PumpSpec, int]) -> int:
    return pump if isinstance(pump, int) else pump.factor


def smem_bytes(pump: Union[PumpSpec, int], rows: int) -> int:
    """Shared memory of a block with ``rows``-row tiles
    (``csrc/stencil.cu::smem_bytes``): a ring of ``RING`` transactions of M
    staged planes, plus the slot of the plane the next beat updates; a
    staged plane is rows + 2 rows of TILE_X + 8 floats (the halo cells and
    a 16-byte aligned interior)."""
    return (RING * _factor(pump) + 1) * (rows + 2) * (TILE_X + 8) * 4


def tile_rows(pump: Union[PumpSpec, int]) -> int:
    """The tile's rows at M = ``pump`` (``csrc/stencil.cu::tile_rows``): the
    most of ``TILE_ROWS`` whose ring fits ``SMEM_BYTES``; 0 if none does."""
    return next((r for r in TILE_ROWS if smem_bytes(pump, r) <= SMEM_BYTES),
                0)


def plan(d0: int, d1: int, d2: int, pump: Union[PumpSpec, int],
         blocks_per_sm: int) -> Plan:
    """The grid of one stage when an SM holds ``blocks_per_sm`` blocks: as
    many segments per tile as the resident blocks allow in one wave, but
    none shorter than ``MIN_SEG`` planes (unless the interior is), each a
    multiple of M planes."""
    m = _factor(pump)
    interior = d0 - 2
    rows = tile_rows(m)
    tiles_x, tiles_y = -(-d2 // TILE_X), -(-d1 // rows)
    want = max(1, min(SMS * blocks_per_sm // (tiles_x * tiles_y),
                      interior // MIN_SEG))
    seg = -(-interior // want)
    seg = -(-seg // m) * m
    return Plan(rows, tiles_x, tiles_y, -(-interior // seg), seg)


def launch_rows(d0: int, d1: int, d2: int,
                pump: Union[PumpSpec, int]) -> int:
    """The tile rows a stage of a (d0, d1, d2) volume launches with at M =
    ``pump``; raises ``ValueError`` where it cannot launch: interior planes
    that M does not divide (as the reference), a ring of 2 M + 1 planes too
    big for shared memory at every tile height, or more tile rows than the
    grid's y extent."""
    m = _factor(pump)
    if d0 < 2 or (d0 - 2) % m:
        raise ValueError(f"stencil: {d0 - 2} interior planes not divisible "
                         f"by M={m}")
    rows = tile_rows(m)
    if not rows:
        raise ValueError(f"stencil: a ring of {RING} x M={m} planes of "
                         f"{TILE_ROWS[-1]}-row tiles ({smem_bytes(m, 8)} B) "
                         f"exceeds {SMEM_BYTES} bytes of shared memory")
    if -(-d1 // rows) > MAX_GRID_Y:
        raise ValueError(f"stencil: {-(-d1 // rows)} tile rows exceed the "
                         f"grid's {MAX_GRID_Y}")
    return rows


def blocks_per_sm(device: torch.device, pump: int) -> int:
    """Blocks of M = ``pump`` an SM of ``device`` holds at once, as the CUDA
    runtime computes it for the built kernel; cached."""
    key = (device.index, pump)
    if key not in _occupancy:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _lib().stencil_blocks_per_sm(pump, ctypes.byref(out))
        if err or out.value < 1:
            raise RuntimeError(f"stencil: no block of M={pump} fits an SM "
                               f"(CUDA error {err})")
        _occupancy[key] = out.value
    return _occupancy[key]


def stencil_chain_cuda(x: torch.Tensor, stages: int, *, kind: str = "jacobi",
                       coef: float = 0.1,
                       pump: Union[PumpSpec, int] = 1) -> torch.Tensor:
    """``stages`` stages over a contiguous fp32 (d0, d1, d2) CUDA volume, M
    = ``pump`` planes per transaction; returns a new tensor."""
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
    launch_rows(d0, d1, d2, m)
    src = x
    bufs = [torch.empty_like(x) for _ in range(min(stages, 2))]
    seg = 0
    for s in range(stages):
        dst = bufs[s % 2]
        if d0 == 2 or d1 * d2 == 0:          # no interior plane to launch for
            dst.copy_(src)
        else:
            seg = seg or plan(d0, d1, d2, m, blocks_per_sm(x.device, m)).seg
            with torch.cuda.device(x.device):
                stream = torch.cuda.current_stream().cuda_stream
                err = _lib().stencil_fwd(src.data_ptr(), dst.data_ptr(), d0,
                                         d1, d2, m, seg,
                                         int(kind == "diffusion"), coef,
                                         1.0 / 7.0, stream)
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
