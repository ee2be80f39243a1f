"""Grouped (per-expert) GEMM on Hopper: the wrapper of
``csrc/grouped_gemm.cu``.

Replaces ``repro/kernels/grouped_gemm.py::grouped_gemm_pallas`` and the
reduce form the reference emits over ``_grouped_gemm_graph``, dense and
ragged.  The kernel walks a tile table: row i is (expert, first row, row
count) of a row tile of x (rows, D), and the blocks of tile i compute those
rows of ``x · w[expert]``; expert -1 marks a surplus tile, whose rows come
out zero.  ``tile_table`` builds the table with tensor ops on the sizes'
device, so a table for a routing made on the card never waits on the host.
bf16 products run on the tensor cores (mma.sync, fp32 accumulation), fp32
ones as fp32 FMAs; either way the whole-D sum is fp32, rounded once to x's
dtype, and ragged rows, D and F are masked.  ``launches`` counts the kernel's launches; nothing else
adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from ..core.ir import PumpSpec
from . import _build
from ._build import DtypeError, InputError, KernelError

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (bc, bf, bd) instantiated per dtype: the 128-row tile only in bf16 (its
# fp32 panels would not fit shared memory at M 4)
TILES = {torch.float32: ((16, 128, 32), (64, 128, 32)),
         torch.bfloat16: ((16, 128, 32), (64, 128, 32), (128, 128, 32))}
PUMPS = ((1, "T"), (2, "T"), (4, "T"), (1, "R"), (2, "R"), (4, "R"))

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("grouped_gemm").grouped_gemm_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i] * 13 + [p]
        fn.restype = i
        _fn = fn
    return _fn


def _vec(t: torch.Tensor) -> bool:
    """16-byte aligned, with rows of whole 16-byte chunks."""
    return t.data_ptr() % 16 == 0 \
        and (t.shape[-1] * t.element_size()) % 16 == 0


def tile_table(sizes: torch.Tensor, bc: int, n_tiles: int) -> torch.Tensor:
    """(n_tiles, 3) int32 tile table on ``sizes``' device for row groups of
    ``sizes`` (E,) rows laid end to end: each group split into tiles of at
    most ``bc`` rows, in expert order, as the reference's group tables
    (``repro/core/autopump.py:696-717``).  Entries past the groups' own
    tiles are surplus tiles (expert -1) that carry on from the last group's
    end in steps of ``bc`` rows, so a table sized for the worst case covers
    a buffer of ``n_tiles · bc`` rows with no host round trip."""
    sizes = sizes.to(torch.long)
    n_e = sizes.shape[0]
    per = (sizes + bc - 1) // bc                   # tiles of each group
    t_end = torch.cumsum(per, 0)
    g_off = torch.cumsum(sizes, 0) - sizes         # first row of each group
    i = torch.arange(n_tiles, device=sizes.device)
    e = torch.searchsorted(t_end, i, right=True)
    real = e < n_e
    ec = e.clamp(max=n_e - 1)
    j = i - (t_end - per)[ec]                      # tile within its group
    spare = i - t_end[-1]
    first = torch.where(real, g_off[ec] + j * bc, sizes.sum() + spare * bc)
    count = torch.where(real, torch.clamp(sizes[ec] - j * bc, max=bc), bc)
    expert = torch.where(real, e, -1)
    return torch.stack([expert, first, count], 1).to(torch.int32)


def grouped_gemm_cuda(x: torch.Tensor, w: torch.Tensor, tiles: torch.Tensor,
                      *, bc: int = 16, bf: int = 128, bd: int = 32,
                      pump: Union[PumpSpec, int] = 1) -> torch.Tensor:
    """x (rows, D) · w[expert] over the tile table ``tiles`` (n, 3) int32,
    whose row counts are at most ``bc``; contiguous CUDA tensors, x and w of
    one dtype (fp32 or bf16).  Returns (rows, F) in x's dtype."""
    global launches
    pump = PumpSpec.of(pump)
    for name, t, dim in (("x", x, 2), ("w", w, 3), ("tiles", tiles, 2)):
        if t.dim() != dim:
            raise InputError(f"grouped_gemm: {name} must be {dim}-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_cuda:
            raise InputError(f"grouped_gemm: {name} is not a CUDA tensor")
        if not t.is_contiguous():
            raise InputError(f"grouped_gemm: {name} must be contiguous")
    if x.shape[1] != w.shape[1] or x.dtype != w.dtype \
            or len({x.device, w.device, tiles.device}) != 1:
        raise InputError(f"grouped_gemm: x {tuple(x.shape)} {x.dtype} and w "
                         f"{tuple(w.shape)} {w.dtype} do not match")
    if tiles.dtype != torch.int32 or tiles.shape[1] != 3:
        raise InputError(f"grouped_gemm: tiles must be (n, 3) int32, got "
                         f"{tuple(tiles.shape)} {tiles.dtype}")
    if x.dtype not in DTYPES:
        raise DtypeError(f"grouped_gemm: dtype {x.dtype} not supported")
    if (bc, bf, bd) not in TILES[x.dtype] \
            or (pump.factor, pump.mode) not in PUMPS:
        raise InputError(f"grouped_gemm: no kernel for tile {(bc, bf, bd)} "
                         f"with M={pump.factor} mode {pump.mode} in "
                         f"{x.dtype}; built for tiles {TILES[x.dtype]} and "
                         f"pumps {PUMPS}")
    rows, d = x.shape
    f = w.shape[2]
    out = torch.empty((rows, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or tiles.shape[0] == 0:
        return out.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                        tiles.data_ptr(), tiles.shape[0], rows, d, f,
                        DTYPES[x.dtype], bc, bf, bd, pump.factor,
                        int(pump.mode == "R"), int(_vec(x)), int(_vec(w)),
                        int(out.data_ptr() % 16 == 0 and f % 4 == 0), stream)
    if err:
        raise KernelError(f"grouped_gemm kernel launch failed: CUDA error "
                          f"{err}")
    launches += 1
    return out


def transactions(e: int, c: int, d: int, f: int, bc: int = 128,
                 bf: int = 128, bd: int = 128,
                 pump: Union[PumpSpec, int] = 1) -> int:
    """Wide contraction-panel transactions of the dense form:
    ``repro/kernels/grouped_gemm.py:83``."""
    pump = PumpSpec.of(pump)
    dw = bd * pump.factor if pump.mode == "T" else bd
    return e * (c // bc) * (f // bf) * (d // dw)
