"""Paper Tables 2, 3, 4-5 and 6 on the card: the pumped kernels in their
original (O) and pumped (DP) variants.

    PYTHONPATH=src python -m repro_torch.launch.paper --mode all

runs every table on the card at sizes far above the 50 MB L2 (vectors of
2^28 fp32, 4096^3 matmul, a (514, 512, 512) volume, Floyd-Warshall at
n 500 and 4096); ``--smoke`` keeps the reference harness's toy sizes, and
``--smoke --device cpu`` runs them on the CPU, where every op takes its
plain version and nothing is timed (``us_per_call`` is nan).

Prints the reference's ``name,us_per_call,derived`` CSV rows
(``benchmarks/{vecadd_table2,matmul_table3,stencil_table45,floyd_table6}.py``)
with the same row names and structural columns.  ``us_per_call`` is the
median of CUDA-event times with L2 flushed before each call; the modeled
columns use the Hopper constants of ``core/pump_plan.py``; every row adds
``bound_us``, the least time the card could take for the row's function.
Each row's output is held to the plain version on the same device before
the row prints.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import device as device_mod
from repro_torch.core.ir import Graph, PumpSpec
from repro_torch.core.multipump import apply_multipump, throughput_model
from repro_torch.core.pump_plan import (HBM_BW, PEAK_FLOPS_FP32,
                                        PEAK_OPS_FP32, KernelEstimate,
                                        bound_ms)
from repro_torch.core.streaming import apply_streaming
from repro_torch.core.symbolic import AccessPattern, Affine, Domain
from repro_torch.kernels import floyd_warshall as fw_mod
from repro_torch.kernels import matmul as mm_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import stencil as st_mod
from repro_torch.kernels import vecadd as va_mod

# kernel vs plain version, relative to the largest |plain value|.  Matmul:
# the kernel sums K products in k order with FMAs, cuBLAS (the plain
# version on the card) in its own blocked order; over K = 4096 normal
# products the two drift apart like a random walk of fp32 roundings, some
# 1e-6 of the largest output, and 1e-5 leaves room for it while a lost K
# panel or a wrong tile moves outputs by O(1) of it.  Stencil: the kernel
# does the plain version's operations in its order with round-to-nearest
# intrinsics, so the two agree bit for bit unless PyTorch rounds a scalar
# constant differently; 1e-6 (8 fp32 ulps at the largest value) allows one
# ulp per stage over 8 stages, while a wrong neighbour moves a cell by
# O(0.1).  Vecadd and Floyd-Warshall do the same single operations in the
# same order and must agree exactly.
RTOL_MATMUL = 1e-5
RTOL_STENCIL = 1e-6

CARD = dict(vecadd_n=1 << 28, mm=4096, volume=(514, 512, 512),
            fw=(500, 4096))
SMOKE = dict(vecadd_n=1 << 14, mm=256, volume=(18, 16, 16), fw=(128,))
ITERS = 10                    # timed calls per row
ITERS_SLOW = 3                # rows of 100 ms and more (Floyd-Warshall 4096)

BM = BN = 64                  # Table 3's tile and K panel
BK = 32


@dataclasses.dataclass
class Row:
    name: str
    us: float                 # nan where nothing was timed (the CPU)
    derived: Dict[str, str]

    def csv(self) -> str:
        fields = ";".join(f"{k}={v}" for k, v in self.derived.items())
        return f"{self.name},{self.us:.3f},{fields}"


class _Run:
    """The device, the timer (None on the CPU) and the rows printed."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.timer = None
        if dev.type == "cuda":
            from repro_torch.launch.timing import Timer
            self.timer = Timer()
        self.rows: List[Row] = []

    def us(self, fn: Callable[[], object], iters: int = ITERS) -> float:
        return float("nan") if self.timer is None \
            else self.timer.ms(fn, iters) * 1e3

    def emit(self, name: str, us: float, derived: Dict[str, object],
             bound: Optional[float] = None) -> None:
        fields = {k: str(v) for k, v in derived.items()}
        if bound is not None:
            fields["bound_us"] = f"{bound * 1e3:.3f}"
        row = Row(name, us, fields)
        self.rows.append(row)
        print(row.csv(), flush=True)

    def generator(self) -> torch.Generator:
        return torch.Generator(device=self.dev).manual_seed(0)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(1, max |want|)."""
    diff = (got.float() - want.float()).abs().max().item()
    return diff / max(1.0, want.float().abs().max().item())


def check(name: str, got: torch.Tensor, want: torch.Tensor,
          rtol: float) -> None:
    """Raise unless the kernel's output is the plain version's (exactly for
    rtol 0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"{name}: got {tuple(got.shape)} {got.dtype}, "
                           f"want {tuple(want.shape)} {want.dtype}")
    if rtol == 0:
        if not torch.equal(got, want):
            raise RuntimeError(f"{name}: differs from the plain version "
                               f"(max abs err "
                               f"{(got - want).abs().max().item():.3g})")
        return
    e = rel_err(got, want)
    if not e <= rtol:
        raise RuntimeError(f"{name}: relative error {e:.3g} > {rtol}")


# ------------------------------------------------------------- Table 2 ----
def ir_metrics(n: int, v: int, mode: str, factor: int):
    """The vecadd graph through the streaming and multi-pump passes:
    (resources, throughput_model), as ``benchmarks/vecadd_table2.py``
    computes them."""
    g = Graph("vecadd")
    g.memory("x", (n,))
    g.memory("y", (n,))
    g.memory("z", (n,))
    dom = Domain.of(("i", 0, n // v))
    acc = AccessPattern(dom, (Affine.of("i", v),), width=v)
    g.compute("add", dom, vector_width=v)
    g.connect("x", "add", acc)
    g.connect("y", "add", acc)
    g.connect("add", "z", acc)
    sg, _ = apply_streaming(g)
    if factor == 1:
        return sg.resources(), throughput_model(sg)
    pg, rep = apply_multipump(sg, factor=factor, mode=mode)
    if not rep.applied:
        raise RuntimeError(f"multipump not applied: {rep.reason}")
    return pg.resources(), throughput_model(pg)


def table2(run: _Run, n: int) -> None:
    gen = run.generator()
    x = torch.randn(n, generator=gen, device=run.dev)
    y = torch.randn(n, generator=gen, device=run.dev)
    gold = ref.vecadd(x, y)
    bound, _ = bound_ms(3 * n * 4, n, PEAK_OPS_FP32)
    for v in (2, 4, 8):
        for label, factor, mode in (("O", 1, "T"), ("DP", 2, "R")):
            spec = PumpSpec(factor=factor, mode=mode)
            name = f"vecadd_v{v}_{label}"

            def fn(v=v, spec=spec):
                return ops.vecadd(x, y, vector_width=v, pump=spec)

            check(name, fn(), gold, 0.0)
            res, tp = ir_metrics(n, v, mode, factor)
            run.emit(name, run.us(fn), {
                "lanes": res["compute_units"],
                "tx": va_mod.grid_steps(n, v, spec),
                "adapters": res["adapters"],
                "throughput_model": f"{tp:.1f}"}, bound)


# ------------------------------------------------------------- Table 3 ----
def modeled_gops(bm: int, bn: int, bk: int, pump: PumpSpec) -> float:
    """The reference's effective-rate model of one wide transaction
    (``benchmarks/matmul_table3.py::modeled_gops``) with Hopper's device
    memory rate and fp32 peak."""
    est = KernelEstimate((bm * bk + bk * bn) * 4, 0, 2.0 * bm * bn * bk)
    if pump.mode == "T":
        return est.flops_per_block * pump.factor \
            / est.step_time(pump.factor) / 1e9
    step = max(est.dma_time + est.fixed_overhead_s,
               est.compute_time * pump.factor)
    return est.flops_per_block / step / 1e9


TABLE3_CASES = (("mmm_32PE_O", BN, PumpSpec(1)),
                ("mmm_32PE_DP", BN, PumpSpec(2, "R")),     # -50 % tile bytes
                ("mmm_64PE_DP", 2 * BN, PumpSpec(2, "R")))  # reinvest: 2x tile


def table3(run: _Run, size: int) -> None:
    gen = run.generator()
    a = torch.randn(size, size, generator=gen, device=run.dev)
    b = torch.randn(size, size, generator=gen, device=run.dev)
    gold = ref.matmul(a, b)
    flops = 2.0 * size ** 3
    bound, _ = bound_ms(3 * size * size * 4, flops, PEAK_FLOPS_FP32)
    for name, bn, spec in TABLE3_CASES:
        def fn(bn=bn, spec=spec):
            return ops.matmul(a, b, bm=BM, bn=bn, bk=BK, pump=spec)

        check(name, fn(), gold, RTOL_MATMUL)
        tile = mm_mod.compute_tile_bytes(BM, bn, spec)
        run.emit(name, run.us(fn), {
            "tile_bytes": tile,
            "tx": mm_mod.transactions(size, size, size, BM, bn, BK, spec),
            "modeled_gops": f"{modeled_gops(BM, bn, BK, spec):.1f}",
            "op_per_tile_byte": f"{flops / tile:.0f}"}, bound)


# ---------------------------------------------------------- Tables 4-5 ----
STENCIL_OPS = {"jacobi": 7, "diffusion": 9}   # fp32 ops per interior cell


def table45(run: _Run, shape) -> None:
    d0, d1, d2 = shape
    interior = (d0 - 2) * (d1 - 2) * (d2 - 2)
    flops_per_stage = 7.0 * interior          # the reference's op count
    for kind in ("jacobi", "diffusion"):
        x = torch.randn(shape, generator=run.generator(), device=run.dev)
        for s in (4, 8):
            gold = ref.stencil_chain(x, s, kind=kind)
            bound, _ = bound_ms(2 * x.numel() * 4,
                                s * STENCIL_OPS[kind] * interior,
                                PEAK_OPS_FP32)
            for label, m in (("O", 1), ("DP", 2)):
                spec = PumpSpec(factor=m)
                name = f"{kind}_S{s}_{label}"

                def fn(s=s, spec=spec):
                    return ops.stencil_chain(x, s, kind=kind, pump=spec)

                check(name, fn(), gold, RTOL_STENCIL)
                slab = st_mod.slab_bytes(d1, d2, spec)
                run.emit(name, run.us(fn), {
                    "slab_bytes": slab,
                    "tx": s * st_mod.transactions(d0, spec),
                    "op_per_slab_byte":
                        f"{s * flops_per_stage / slab:.1f}"}, bound)


# ------------------------------------------------------------- Table 6 ----
def distances(n: int, gen: torch.Generator, dev: torch.device) -> torch.Tensor:
    """Uniform(0.1, 10) edge weights with a zero diagonal, as the reference
    table draws them."""
    d = torch.rand(n, n, generator=gen, device=dev) * 9.9 + 0.1
    return d.fill_diagonal_(0.0)


def table6(run: _Run, sizes: Sequence[int]) -> None:
    for n in sizes:
        d = distances(n, run.generator(), run.dev)
        gold = ref.floyd_warshall(d)
        bound, _ = bound_ms(2 * n * n * 4, 2.0 * n ** 3, PEAK_OPS_FP32)
        iters = ITERS_SLOW if n > 1024 else ITERS
        times = {}
        for label, m in (("O", 1), ("DP", 2)):
            spec = PumpSpec(factor=m)
            name = f"floyd_warshall_n{n}_{label}"

            def fn(spec=spec):
                return ops.floyd_warshall(d, pump=spec)

            check(name, fn(), gold, 0.0)
            times[label] = run.us(fn, iters)
            tx = fw_mod.transactions(n, spec)
            modeled = tx * ((2 * n * 4) / HBM_BW + 1e-6)
            run.emit(name, times[label], {"tx": tx,
                                          "modeled_s": f"{modeled:.2e}"},
                     bound)
        run.emit(f"floyd_warshall_n{n}_speedup", 0.0, {
            "wall_speedup": f"{times['O'] / times['DP']:.2f}x",
            "paper": "1.49x"})


TABLES = {"table2": (table2, "vecadd_n"), "table3": (table3, "mm"),
          "table45": (table45, "volume"), "table6": (table6, "fw")}


def main(argv: Optional[Sequence[str]] = None) -> List[Row]:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.paper")
    ap.add_argument("--mode", default="all",
                    choices=("all", *TABLES))
    ap.add_argument("--smoke", action="store_true",
                    help="the reference harness's toy sizes")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    sizes = SMOKE if args.smoke else CARD
    run = _Run(dev)
    print("name,us_per_call,derived", flush=True)
    for mode, (fn, key) in TABLES.items():
        if args.mode in ("all", mode):
            fn(run, sizes[key])
    return run.rows


if __name__ == "__main__":
    main()
