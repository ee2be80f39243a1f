"""Hopper constants and the napkin-math step model of one wide transaction.

The reference's ``core/pump_plan.py`` holds TPU v5e constants; these are the
H100 SXM's (NVIDIA data sheet, dense rates at the full 700 W power limit).
The paper's kernels (vecadd, matmul, stencils, Floyd-Warshall) are fp32
math on CUDA cores, so their compute bound is ``PEAK_FLOPS_FP32``; an
fp32 min or add that is not part of an FMA counts once against
``PEAK_OPS_FP32``.

The pump-factor search (``best_pump_factor``) keeps the reference's
effective-rate law but not its capacity rule.  The reference admits M while
``2·M·(in + out)`` bytes fit 64 MB of VMEM; a 128³ fp32 matmul block alone
is 128 KB, so the same rule against an SM's 227 KB would admit no M > 1.
Here the budget is what one CUDA block of the region kernel
(``csrc/region_map_reduce.cu``) really stages in shared memory for one
beat: its *panel*.  The kernel's ``dot`` op stages each operand block in
K-slices of at most ``STAGE_K`` elements, so a beat's panel is
``(rows + cols)·min(bk, STAGE_K)·itemsize`` bytes (``KernelEstimate.
panel_bytes``, which the builders fill in); a pump-M transaction holds M
of them, double-buffered: ``2·M·panel ≤ SMEM_BYTES``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .ir import PumpSpec

HBM_BW = 3.35e12                  # device memory, bytes/s
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor cores, FLOP/s
PEAK_FLOPS_FP32 = 67e12           # fp32 on CUDA cores, an FMA = 2 FLOPs
PEAK_OPS_FP32 = PEAK_FLOPS_FP32 / 2   # fp32 add, mul or min, one per op
SMEM_BYTES = 227 * 1024           # shared memory one block may use
SMS = 132                         # streaming multiprocessors (H100 SXM)
# NVLink 4, one direction (900 GB/s both ways): the link a data-parallel
# gradient all-reduce between H100s rides, in place of the TPU's ICI
LINK_BW = 450e9
STAGE_K = 32                      # widest K-slice the region kernel stages


@dataclasses.dataclass(frozen=True)
class KernelEstimate:
    """Napkin-math descriptors of one transaction (one block's K stage,
    one pivot slab, ...)."""

    block_bytes_in: int            # bytes copied device memory -> SM
    block_bytes_out: int           # bytes written back
    flops_per_block: float         # useful FLOPs
    fixed_overhead_s: float = 1e-6  # per-transaction issue overhead
    # shared-memory bytes one beat of the region kernel stages (its panel);
    # None: the block's own bytes in and out
    panel_bytes: Optional[int] = None

    @property
    def staged_bytes(self) -> int:
        return self.panel_bytes if self.panel_bytes is not None \
            else self.block_bytes_in + self.block_bytes_out

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

    def throughput(self, pump: int = 1) -> float:
        """Blocks/s under the effective-rate law."""
        return pump / self.step_time(pump)


def best_pump_factor(est: KernelEstimate, max_factor: int = 16,
                     smem_budget: int = SMEM_BYTES) -> int:
    """The power of two M <= ``max_factor`` with the best modelled
    throughput whose double-buffered M-beat panel fits one block's shared
    memory: ``2·M·est.staged_bytes <= smem_budget`` (see the module
    docstring).  A larger M wins only by more than 0.1%."""
    best, best_tp = 1, est.throughput(1)
    m = 2
    while m <= max_factor:
        if 2 * m * est.staged_bytes > smem_budget:
            break
        tp = est.throughput(m)
        if tp > best_tp * 1.001:
            best, best_tp = m, tp
        m *= 2
    return best


def plan_kernel_pump(block_bytes_in: int, block_bytes_out: int,
                     flops_per_block: float, mode: str = "T",
                     max_factor: int = 16, smem_budget: int = SMEM_BYTES,
                     axis: int = 0,
                     panel_bytes: Optional[int] = None) -> PumpSpec:
    """``best_pump_factor`` of one kernel's step, as a ``PumpSpec``."""
    est = KernelEstimate(block_bytes_in, block_bytes_out, flops_per_block,
                         panel_bytes=panel_bytes)
    m = best_pump_factor(est, max_factor=max_factor, smem_budget=smem_budget)
    return PumpSpec(factor=m, mode=mode, axis=axis, vmem_budget=smem_budget)


def plan_trainer_pump(grad_bytes: int, step_flops: float, n_chips: int,
                      dp_degree: int, max_factor: int = 64) -> int:
    """Microbatches per gradient synchronization: the reference's law at
    the H100's constants.  A ring all-reduce over ``d = max(dp_degree, 2)``
    data shards moves ``2 (d - 1) / d · grad_bytes`` a card over
    ``LINK_BW``; one microbatch computes ``step_flops / n_chips`` at
    ``PEAK_FLOPS_BF16``.  M doubles (up to ``max_factor``) until the
    collective, paid once per M microbatches, is under 10 % of their
    compute."""
    d = max(dp_degree, 2)
    coll_time = 2 * (d - 1) / d * grad_bytes / LINK_BW
    mb_compute = step_flops / n_chips / PEAK_FLOPS_BF16
    if mb_compute <= 0:
        return 1
    m = 1
    while m < max_factor and coll_time / m > 0.1 * mb_compute * m:
        m *= 2
    return m


def dot_panel_bytes(rows: int, cols: int, depth: int, itemsize: int) -> int:
    """The panel one beat of the region kernel's ``dot`` stages: a
    ``rows x k`` slice of the left block and a ``k x cols`` slice of the
    right one, ``k = min(depth, STAGE_K)``."""
    return (rows + cols) * min(depth, STAGE_K) * itemsize


def bound_ms(nbytes: float, ops: float, peak: float) -> Tuple[float, str]:
    """Least time (ms) the card could take to move ``nbytes`` once and do
    ``ops`` operations at ``peak`` per second, and which of the two bounds
    it (``"bytes"`` or ``"operations"``)."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")
