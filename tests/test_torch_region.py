"""The region kernel's plain version and the Hopper pump planning.

``repro_torch.kernels.ref.region_map_reduce`` computes what
``csrc/region_map_reduce.cu`` computes from a plan's descriptor; it is held
here, exactly on integer-valued inputs, to the reference's emitted kernel
(``repro.compiler.pallas_backend.emit_pallas`` in interpret mode) on the
same plans: vecadd, matmul, the dense and the ragged (group-table) grouped
GEMM, at two shapes each, every pump case M in {1, 2, 4, 8} x {T, R}.

The pump factor the port's ``'auto'`` picks comes from the Hopper
constants and the region kernel's shared-memory panel
(``core/pump_plan.py``); it is checked against factors worked by hand at
the card sizes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import compiler as jcompiler  # noqa: E402
from repro.compiler import pallas_backend as jpb  # noqa: E402
from repro.core.autopump import BUILDERS as JBUILDERS  # noqa: E402
from repro.core.pump_plan import best_pump_factor as tpu_best  # noqa: E402

from repro_torch import compiler  # noqa: E402
from repro_torch.compiler import hopper_backend as hb  # noqa: E402
from repro_torch.core import pump_plan  # noqa: E402
from repro_torch.core.autopump import BUILDERS  # noqa: E402
from repro_torch.core.ir import PumpSpec  # noqa: E402
from repro_torch.core.pump_plan import (KernelEstimate, SMEM_BYTES,  # noqa: E402
                                        best_pump_factor, dot_panel_bytes,
                                        plan_kernel_pump)
from repro_torch.kernels import ref  # noqa: E402

PLANS = {
    "vecadd V8": ("vecadd", (64,), dict(vector_width=8)),
    "vecadd V4": ("vecadd", (128,), dict(vector_width=4)),
    "matmul 32^3": ("matmul", (32, 32, 32),
                    dict(bm=16, bn=16, bk=16, vector_width=8)),
    "matmul 32x16x64": ("matmul", (32, 16, 64),
                        dict(bm=8, bn=8, bk=8, vector_width=8)),
    "dense grouped": ("grouped_gemm", (2, 32, 32, 8),
                      dict(bc=8, bf=8, bd=4, vector_width=8)),
    "ragged grouped": ("grouped_gemm", (3, 16, 32, 16),
                       dict(bc=8, bf=8, bd=4, group_sizes=(8, 0, 24),
                            vector_width=8)),
}


def _single_region(kern, mod):
    (region,) = mod.partition_regions(kern.graph)
    notes = []
    return mod.plan_region(kern.graph, region, notes.append), notes


@pytest.mark.parametrize("mode", ("T", "R"))
@pytest.mark.parametrize("factor", (1, 2, 4, 8))
@pytest.mark.parametrize("label", sorted(PLANS))
def test_plain_region_matches_emit_pallas(label, factor, mode):
    name, args, kw = PLANS[label]
    g, _ = BUILDERS[name](*args, **kw)
    kern = compiler.compile(g, factor=factor, mode=mode, backend="none",
                            cache=False, memoize=False)
    jg, _ = JBUILDERS[name](*args, **kw)
    jkern = jcompiler.compile(jg, factor=factor, mode=mode, backend="none",
                              cache=False, memoize=False)
    plan, notes = _single_region(kern, hb)
    jplan, jnotes = _single_region(jkern, jpb)
    assert notes == jnotes and plan.pallas_ok and jplan.pallas_ok
    desc, why = hb.region_descriptor(kern.graph, plan)
    assert desc is not None, why

    comp = plan.out_compute
    mems = [plan.region.bindings[comp][k][1] for k in range(2)]
    rng = np.random.default_rng(factor * 10 + len(mode))
    data = {m: rng.integers(-4, 5, kern.graph.nodes[m].shape)
            .astype(np.float32) for m in mems}
    got = ref.region_map_reduce(desc, [torch.from_numpy(data[m])
                                       for m in mems])

    region_fn = jpb.emit_pallas(jkern.graph, jplan, interpret=True)
    jmems = {m: jnp.asarray(v) for m, v in data.items()}
    out_node = jkern.graph.nodes[jplan.out_mem]
    jmems[jplan.out_mem] = jnp.zeros(out_node.shape, out_node.dtype)
    want = np.asarray(region_fn(jmems)[jplan.out_mem])
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel's walk: the pump axis is a beat axis when it reduces
    # (mode T over K) and a sub-tile axis otherwise
    if plan.pump > 1:
        reduces = "_pump" in plan.reduce_syms
        assert (desc.beats, desc.subtiles) == \
            ((plan.pump, 1) if reduces else (1, plan.pump))


def test_plain_region_chunks_like_one_pass():
    """The plain version walks the map points in chunks; any chunk size
    gives the same result."""
    name, args, kw = PLANS["ragged grouped"]
    g, _ = BUILDERS[name](*args, **kw)
    kern = compiler.compile(g, factor=2, mode="T", backend="none",
                            cache=False, memoize=False)
    plan, _ = _single_region(kern, hb)
    desc, _ = hb.region_descriptor(kern.graph, plan)
    rng = np.random.default_rng(1)
    ins = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
           for o in desc.ins]
    whole = ref.region_map_reduce(desc, ins)
    assert torch.equal(ref.region_map_reduce(desc, ins, max_elems=1), whole)


# --------------------------------------------------------- pump planning --
def test_vecadd_card_factor_by_hand():
    """vecadd 2^28 fp32 at V 8: a block is 64 B in and 32 B out and stages
    no panel, so 2·M·96 B fits 227 KB for every M up to max_factor; the
    1 µs per transaction dominates the 29 fs of bytes, so the modelled rate
    grows with M and the search stops at max_factor."""
    _g, est = BUILDERS["vecadd"](2 ** 28, vector_width=8)
    assert (est.block_bytes_in, est.block_bytes_out, est.staged_bytes) == \
        (64, 32, 96)
    assert best_pump_factor(est) == 16
    assert best_pump_factor(est, max_factor=8) == 8
    assert best_pump_factor(est, max_factor=4) == 4


def test_matmul_card_factor_by_hand():
    """matmul 4096^3 fp32 at 128^3 blocks: the kernel stages 32-wide K
    slices, so one beat's panel is (128 + 128)·32·4 = 32 KiB and two stages
    of M beats fit 227 KiB for M <= 3.5: M is 2 (the rate at 2 is 1.93x
    the rate at 1).  The reference's TPU rule, 2·M·(in + out) against
    64 MiB of VMEM, would give 16 for the same block: not copied."""
    _g, est = BUILDERS["matmul"](4096, 4096, 4096, bm=128, bn=128, bk=128)
    assert est.panel_bytes == dot_panel_bytes(128, 128, 128, 4) == 32768
    assert 2 * 2 * 32768 <= SMEM_BYTES < 2 * 4 * 32768
    assert best_pump_factor(est) == 2
    assert est.throughput(2) / est.throughput(1) == pytest.approx(1.927,
                                                                  abs=1e-3)
    spec = plan_kernel_pump(est.block_bytes_in, est.block_bytes_out,
                            est.flops_per_block,
                            panel_bytes=est.panel_bytes)
    assert spec == PumpSpec(factor=2, mode="T", axis=0,
                            vmem_budget=SMEM_BYTES)
    # the port's direct matmul tile (64, 64, 32): a 16 KiB panel, M 4
    _g, est64 = BUILDERS["matmul"](4096, 4096, 4096, bm=64, bn=64, bk=32)
    assert est64.panel_bytes == 16384 and best_pump_factor(est64) == 4
    # without the panel the whole 128 KiB block is staged: no M > 1 fits
    whole = KernelEstimate(est.block_bytes_in, 0, est.flops_per_block)
    assert best_pump_factor(whole) == 1
    from repro.core.autopump import BUILDERS as JB
    assert tpu_best(JB["matmul"](4096, 4096, 4096)[1]) == 16


def test_grouped_gemm_card_factor_by_hand():
    """deepseek's expert GEMM, bf16 16x32 / 32x128 blocks: a (16 + 128)·32·2
    = 9 KiB panel fits 227 KiB double-buffered for M <= 12: M is 8."""
    _g, est = BUILDERS["grouped_gemm"](64, 512, 2048, 1408, bc=16, bf=128,
                                       bd=32, itemsize=2)
    assert est.panel_bytes == 9216
    assert best_pump_factor(est) == 8


def test_hopper_constants_drive_the_search(monkeypatch):
    """The search reads the module's constants: a smaller shared memory
    caps M, a slower memory makes the bytes, not the overhead, dominate."""
    _g, est = BUILDERS["matmul"](4096, 4096, 4096, bm=128, bn=128, bk=128)
    assert best_pump_factor(est, smem_budget=4 * 32768 - 1) == 1
    monkeypatch.setattr(pump_plan, "HBM_BW", 1e6)
    assert best_pump_factor(est) == 1
