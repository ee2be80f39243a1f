"""The fused-region map/reduce kernel on Hopper: the wrapper of
``csrc/region_map_reduce.cu``.

Replaces the single-output map/reduce kernel the reference's emitter writes
for any region plan it accepts (``repro/compiler/pallas_backend.py::
emit_pallas``, ``pl.pallas_call`` at :847, body :826-843):

    out[block(g_map)] = Σ over the reduce grid points  tile_op(in0[block], in1[block])

``describe`` turns a plan into a :class:`RegionDesc`, the kernel's
descriptor.  Every block offset is the plan's ``Affine`` folded with the
memory strides into one element offset per operand: a constant, a
coefficient per grid axis and group-table terms (the ragged grouped GEMM's
row and expert tables, their values scaled by the stride).  The index maps
are computed from the descriptor in the kernel, not baked in per shape.
The descriptor goes to the kernel as an int32 tensor on the host (a kernel
parameter); the tables are packed into one int32 device buffer, uploaded
once per descriptor and device.

Tile ops: ``add`` (elementwise ``in0 + in1``) and ``dot`` (``in0 @ in1``
over the last two block dims, leading unit dims squeezed).  Reads are fp32
or bf16 in the operands' dtype, the sums are fp32, the output is rounded
once.  A bf16 ``dot`` whose rows and K-slice are multiples of 16 and whose
columns are a multiple of 8 runs on the tensor cores (``mma_path``);
every other one as fp32 FMAs.  ``launches`` counts the kernel's launches; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.pump_plan import SMEM_BYTES, STAGE_K
from . import _build
from ._build import InputError, KernelError

MAXG = 8            # grid axes the kernel takes
MAXT = 4            # table terms per operand
TILE = 128          # the dot op's widest output tile side (16 threads x 8)
DESC_INTS = 24 + 3 * 22
DTYPES = {"float32": 0, "bfloat16": 1}
ITEMSIZE = {"float32": 4, "bfloat16": 2}
INT32 = 2 ** 31

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("region_map_reduce").region_map_reduce_fwd
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@dataclasses.dataclass(frozen=True)
class Operand:
    """One operand's (or the output's) blocks: a ``rows x cols`` block at
    element offset ``base + Σ coef[s]·g[s] + Σ table[g[axis]]`` with row and
    column strides ``rs`` / ``cs``, in a memory of ``shape``."""

    rows: int
    cols: int
    rs: int
    cs: int
    base: int
    coef: Tuple[int, ...]
    tables: Tuple[Tuple[int, Tuple[int, ...]], ...]   # (axis, scaled values)
    shape: Tuple[int, ...]
    dtype: str

    def depends_on(self, axis: int) -> bool:
        return bool(self.coef[axis]) or any(a == axis for a, _ in self.tables)

    def align(self, extra: Sequence[int] = ()) -> int:
        """The largest element count every block offset is a multiple of."""
        vals = [self.base, *self.coef, *extra,
                *(v for _, t in self.tables for v in t)]
        if self.rows > 1:
            vals.append(self.rs)
        out = 0
        for v in vals:
            out = math.gcd(out, abs(int(v)))
        return out or 1 << 30


def _operand(ba, shape, dtype: str, syms: Sequence[str]
             ) -> Tuple[Optional[Operand], str]:
    rank = len(shape)
    if any(b != 1 for b in ba.block[:-2]):
        return None, (f"block {tuple(ba.block)} has non-unit leading dims; "
                      "the region kernel takes rank-2 blocks")
    strides = [1] * rank
    for d in range(rank - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    base = sum(st * a.const for st, a in zip(strides, ba.offsets))
    coef = tuple(sum(st * a.coeff(s) for st, a in zip(strides, ba.offsets))
                 for s in syms)
    tables = tuple((syms.index(s), tuple(int(v) * st for v in t))
                   for st, a in zip(strides, ba.offsets) for s, t in a.tables)
    if len(tables) > MAXT:
        return None, f"{len(tables)} table terms; the kernel takes {MAXT}"
    rows = ba.block[-2] if rank >= 2 else 1
    rs = strides[-2] if rank >= 2 else 0
    return Operand(rows, ba.block[-1], rs, strides[-1], int(base), coef,
                   tables, tuple(shape), dtype), ""


class RegionDesc:
    """The region kernel's descriptor: op, grid (extents outermost first,
    reduce flags, the ``_pump`` axis or -1), two operands and the output.

    The pump axis is a *beat* axis when it reduces (mode T over a reduction:
    M dependent beats of one transaction) and a *sub-tile* axis when it maps
    (mode R, or mode T over a map axis: one thread or block walks the M
    narrowed output sub-tiles in turn)."""

    OPS = ("add", "dot")

    def __init__(self, op: str, grid: Sequence[int], reduce: Sequence[bool],
                 pump: int, ins: Sequence[Operand], out: Operand):
        self.op, self.grid, self.reduce = op, tuple(grid), tuple(reduce)
        self.pump, self.ins, self.out = pump, tuple(ins), out
        self.dtype = out.dtype
        self.itemsize = ITEMSIZE[self.dtype]
        self.beats = grid[pump] if pump >= 0 and reduce[pump] else 1
        self.subtiles = grid[pump] if pump >= 0 and not reduce[pump] else 1
        self.kc = 0
        if op == "dot":
            bk = ins[0].cols
            kc = min(STAGE_K, bk & -bk)           # a power of two dividing bk
            while kc > 1 and self.smem_bytes(kc) > SMEM_BYTES:
                kc //= 2
            self.kc = kc
        # pack the tables once: (operand, term) -> offset into the buffer
        self.table_values: List[int] = []
        self.table_offsets: List[List[int]] = []
        for o in (*ins, out):
            offs = []
            for _axis, vals in o.tables:
                offs.append(len(self.table_values))
                self.table_values.extend(vals)
            self.table_offsets.append(offs)
        self._packed: Optional[torch.Tensor] = None
        self._tables: Dict[torch.device, torch.Tensor] = {}

    # -- shapes the kernel derives from the descriptor ------------------------
    def smem_bytes(self, kc: int) -> int:
        """Dynamic shared memory of the dot op at K-slice ``kc``: two stages,
        each the left slices of the beats (shared by the sub-tiles, rows
        padded by 16 bytes) and the right slices of every (beat,
        sub-tile) (rows padded by 16 bytes in bf16, where ldmatrix reads
        them)."""
        a, b = self.ins
        lda = kc + 16 // self.itemsize
        ldb = b.cols + (8 if self.itemsize == 2 else 0)
        a_bytes = -(-self.beats * a.rows * lda * self.itemsize // 16) * 16
        b_bytes = -(-self.beats * self.subtiles * kc * ldb
                    * self.itemsize // 16) * 16
        return 2 * (a_bytes + b_bytes)

    @property
    def units(self) -> int:
        """Map points a thread (add) or a CUDA block (dot) owns: the map
        axes, the sub-tile axis excluded (it is walked in turn)."""
        n = 1
        for i, (e, r) in enumerate(zip(self.grid, self.reduce)):
            if not r and i != self.pump:
                n *= e
        return n

    def packed(self) -> torch.Tensor:
        """The descriptor as the kernel reads it: int32 on the host."""
        if self._packed is None:
            g = len(self.grid)
            head = [RegionDesc.OPS.index(self.op), DTYPES[self.dtype], g,
                    self.pump, self.kc, 0, 0, 0]
            head += list(self.grid) + [0] * (MAXG - g)
            head += [int(r) for r in self.reduce] + [0] * (MAXG - g)
            for o, offs in zip((*self.ins, self.out), self.table_offsets):
                head += [o.rows, o.cols, o.rs, o.cs, o.base]
                head += list(o.coef) + [0] * (MAXG - g)
                head += [len(o.tables)]
                head += [a for a, _ in o.tables] + [0] * (MAXT - len(o.tables))
                head += offs + [0] * (MAXT - len(offs))
            assert len(head) == DESC_INTS
            self._packed = torch.tensor(head, dtype=torch.int32)
        return self._packed

    def tables_on(self, device: torch.device) -> torch.Tensor:
        """The packed group tables on ``device``, uploaded once."""
        t = self._tables.get(device)
        if t is None:
            t = self._tables[device] = torch.tensor(
                self.table_values or [0], dtype=torch.int32, device=device)
        return t

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"RegionDesc({self.op}, grid={self.grid}, "
                f"reduce={self.reduce}, pump={self.pump}, kc={self.kc})")


def mma_path(desc: RegionDesc) -> bool:
    """True where the kernel runs ``desc``'s dot on the tensor cores: the
    dispatch of ``csrc/region_map_reduce.cu::launch`` (bf16; rows and the
    K-slice multiples of 16, columns of 8; 16-row warps of NI n8 tiles,
    NI * 8 dividing the columns, at most 4 warps across and 8 in all)."""
    if desc.op != "dot" or desc.itemsize != 2:
        return False
    bm, bn = desc.ins[0].rows, desc.ins[1].cols
    if bm % 16 or desc.kc % 16 or bn % 8:
        return False
    nn = desc.subtiles * bn // 8
    return any((bn // 8) % ni == 0 and nn // ni <= 4
               and (bm // 16) * (nn // ni) <= 8 for ni in (1, 2, 4, 8, 16))


def _span(o: Operand, grid: Sequence[int]) -> Tuple[int, int]:
    """Least and greatest element offset any block of ``o`` touches."""
    lo = hi = o.base
    for c, e in zip(o.coef, grid):
        lo, hi = lo + min(0, c * (e - 1)), hi + max(0, c * (e - 1))
    for _a, vals in o.tables:
        lo, hi = lo + min(vals), hi + max(vals)
    hi += (o.rows - 1) * o.rs + (o.cols - 1) * o.cs
    return lo, hi


def describe(op: str, grid: Sequence[int], reduce: Sequence[bool],
             pump: int, syms: Sequence[str], ins, out
             ) -> Tuple[Optional[RegionDesc], str]:
    """The descriptor of one plan, or ``(None, reason)`` when the kernel
    cannot take it.  ``ins`` / ``out`` are ``(BlockedAccess, memory shape,
    dtype)`` of the two operands and the output."""
    if op not in RegionDesc.OPS:
        return None, f"tile op {op!r} is not one the region kernel takes"
    if len(grid) > MAXG:
        return None, f"{len(grid)} grid axes; the kernel takes {MAXG}"
    dtypes = {dt for _ba, _shape, dt in (*ins, out)}
    if len(dtypes) != 1 or not dtypes <= set(DTYPES):
        return None, (f"dtypes {sorted(dtypes)}; the kernel takes one of "
                      f"{sorted(DTYPES)} for all operands")
    opnds = []
    for ba, shape, dt in (*ins, out):
        o, why = _operand(ba, shape, dt, syms)
        if o is None:
            return None, why
        lo, hi = _span(o, grid)
        if lo < 0 or hi >= INT32:
            return None, f"element offsets [{lo}, {hi}] leave int32"
        opnds.append(o)
    a, b, c = opnds
    desc = RegionDesc(op, grid, reduce, pump, (a, b), c)
    n_red = math.prod(e for e, r in zip(grid, reduce) if r)
    if desc.units >= INT32 or n_red * a.cols >= INT32:
        return None, (f"{desc.units} map points or {n_red} reduce points "
                      "leave the kernel's 32-bit walk")
    if op == "add":
        if not (a.rows == b.rows == c.rows and a.cols == b.cols == c.cols):
            return None, (f"add blocks {a.rows}x{a.cols}, {b.rows}x{b.cols} "
                          f"-> {c.rows}x{c.cols} differ")
        return desc, ""
    if a.cols != b.rows or c.rows != a.rows or c.cols != b.cols:
        return None, (f"dot blocks {a.rows}x{a.cols} @ {b.rows}x{b.cols} -> "
                      f"{c.rows}x{c.cols} do not chain")
    if c.rows > TILE or desc.subtiles * c.cols > TILE:
        return None, (f"dot tile {c.rows} x {desc.subtiles * c.cols} is over "
                      f"the kernel's {TILE} x {TILE}")
    if desc.subtiles > 1 and a.depends_on(pump):
        return None, ("mode-R sub-tiles that move the left operand; the "
                      "kernel shares one left panel across them")
    if desc.smem_bytes(desc.kc) > SMEM_BYTES:
        return None, (f"panel of {desc.smem_bytes(desc.kc)} B at a K-slice "
                      f"of {desc.kc} is over {SMEM_BYTES} B of shared memory")
    return desc, ""


def _granule(o: Operand, contiguous: int, shift: int, itemsize: int,
             ptr: int) -> int:
    """Bytes one cp.async moves for a slice of ``o``: 16 or 4 where every
    row start of every slice is aligned to it, else 0 (plain loads).  A
    slice is ``contiguous`` elements along unit-stride columns, starting
    ``shift`` elements from a block's start."""
    align = o.align([shift]) * itemsize
    if o.cs == 1 and (contiguous * itemsize) % 16 == 0 and align % 16 == 0 \
            and ptr % 16 == 0:
        return 16
    if itemsize == 4:
        return 4
    if o.cs == 1 and contiguous % 2 == 0 and align % 4 == 0 and ptr % 4 == 0:
        return 4
    return 0


def region_map_reduce_cuda(desc: RegionDesc,
                           operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Run ``desc`` on two contiguous CUDA tensors of its memory shapes and
    dtype; returns the output memory (every element written)."""
    global launches
    if len(operands) != 2:
        raise InputError("region_map_reduce: two operands")
    dt = getattr(torch, desc.dtype)
    for k, (t, o) in enumerate(zip(operands, desc.ins)):
        if not t.is_cuda or not t.is_contiguous():
            raise InputError(f"region_map_reduce: operand {k} must be a "
                             f"contiguous CUDA tensor")
        if tuple(t.shape) != o.shape or t.dtype != dt:
            raise InputError(f"region_map_reduce: operand {k} is "
                             f"{tuple(t.shape)} {t.dtype}, the descriptor "
                             f"says {o.shape} {desc.dtype}")
    if operands[0].device != operands[1].device:
        raise InputError("region_map_reduce: operands on different devices")
    a, b = operands
    out = torch.empty(desc.out.shape, dtype=dt, device=a.device)
    packed = desc.packed().clone()
    isz = desc.itemsize
    if desc.op == "add":
        vec = all(o.rows == 1 and o.cs == 1 and o.cols % 4 == 0
                  and o.align() % 4 == 0 for o in (*desc.ins, desc.out)) \
            and all(t.data_ptr() % (4 * isz) == 0 for t in (a, b, out))
        packed[5] = 4 if vec else 0
    else:
        oa, ob = desc.ins
        packed[5] = _granule(oa, desc.kc, desc.kc * oa.cs, isz, a.data_ptr())
        packed[6] = _granule(ob, ob.cols, desc.kc * ob.rs, isz, b.data_ptr())
    tables = desc.tables_on(a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(packed.data_ptr(), a.data_ptr(), b.data_ptr(),
                        out.data_ptr(), tables.data_ptr(), stream)
    if err:
        raise KernelError(f"region_map_reduce kernel launch failed: CUDA "
                          f"error {err}")
    launches += 1
    return out
