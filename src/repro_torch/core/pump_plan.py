"""Hopper constants and the napkin-math step model of one wide transaction.

The reference's ``core/pump_plan.py`` holds TPU v5e constants; these are the
H100 SXM's (NVIDIA data sheet, dense rates at the full 700 W power limit).
The paper's kernels (vecadd, matmul, stencils, Floyd-Warshall) are fp32
math on CUDA cores, so their compute bound is ``PEAK_FLOPS_FP32``; an
fp32 min or add that is not part of an FMA counts once against
``PEAK_OPS_FP32``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

HBM_BW = 3.35e12                  # device memory, bytes/s
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor cores, FLOP/s
PEAK_FLOPS_FP32 = 67e12           # fp32 on CUDA cores, an FMA = 2 FLOPs
PEAK_OPS_FP32 = PEAK_FLOPS_FP32 / 2   # fp32 add, mul or min, one per op
SMEM_BYTES = 227 * 1024           # shared memory one block may use


@dataclasses.dataclass(frozen=True)
class KernelEstimate:
    """Napkin-math descriptors of one transaction (one block's K stage,
    one pivot slab, ...)."""

    block_bytes_in: int            # bytes copied device memory -> SM
    block_bytes_out: int           # bytes written back
    flops_per_block: float         # useful FLOPs
    fixed_overhead_s: float = 1e-6  # per-transaction issue overhead

    @property
    def dma_time(self) -> float:
        return (self.block_bytes_in + self.block_bytes_out) / HBM_BW

    @property
    def compute_time(self) -> float:
        return self.flops_per_block / PEAK_FLOPS_FP32

    def step_time(self, pump: int = 1) -> float:
        """Step time of a pump-M wide transaction (mode T): M blocks' bytes
        in one transaction, whose fixed overhead is paid once."""
        dma = pump * self.dma_time + self.fixed_overhead_s
        compute = pump * self.compute_time
        return max(dma, compute)


def bound_ms(nbytes: float, ops: float, peak: float) -> Tuple[float, str]:
    """Least time (ms) the card could take to move ``nbytes`` once and do
    ``ops`` operations at ``peak`` per second, and which of the two bounds
    it (``"bytes"`` or ``"operations"``)."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")
