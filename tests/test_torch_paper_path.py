"""The port's paper-table launcher (``python -m repro_torch.launch.paper``)
on the CPU against the reference harness
(``benchmarks/{vecadd_table2,matmul_table3,stencil_table45,floyd_table6}``):
the same row names in the same order, the same structural columns, and
Table 2's IR metrics from the port's own copies of the IR."""
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.launch import paper  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the columns computed from shapes alone; us_per_call, the modeled columns
# (TPU constants in the reference, Hopper's in the port) and bound_us are not
STRUCTURAL = ("lanes", "tx", "adapters", "throughput_model", "tile_bytes",
              "op_per_tile_byte", "slab_bytes", "op_per_slab_byte", "paper")


def _parse(lines):
    rows = []
    for line in lines:
        if not line or line.startswith("name,") or line.count(",") < 2:
            continue
        name, us, derived = line.split(",", 2)
        rows.append((name, dict(kv.split("=", 1)
                                for kv in derived.split(";"))))
    return rows


@pytest.fixture(scope="module")
def port_rows():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.paper", "--mode", "all",
         "--smoke", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines()[0] == "name,us_per_call,derived"
    return _parse(res.stdout.splitlines())


@pytest.fixture(scope="module")
def reference_rows():
    """The reference tables' rows, with each kernel call replaced by its
    plain jnp reference and the timer by a constant: the names and
    structural columns do not depend on either."""
    from benchmarks import (floyd_table6, matmul_table3, stencil_table45,
                            vecadd_table2)
    from repro.kernels import ref as jax_ref
    plain = types.SimpleNamespace(
        vecadd=lambda x, y, **kw: jax_ref.vecadd(x, y),
        matmul=lambda a, b, **kw: jax_ref.matmul(a, b),
        stencil_chain=lambda x, s, kind, pump: jax_ref.stencil_chain(
            x, s, kind=kind),
        floyd_warshall=lambda d, pump: jax_ref.floyd_warshall(d))
    lines = []
    with pytest.MonkeyPatch.context() as mp:
        for m in (vecadd_table2, matmul_table3, stencil_table45,
                  floyd_table6):
            mp.setattr(m, "ops", plain)
            mp.setattr(m, "time_fn", lambda *a, **k: 1.0)
            mp.setattr(m, "emit", lambda name, us, derived: lines.append(
                f"{name},{us},{derived}"))
            m.main()
    return _parse(lines)


def test_launcher_prints_every_reference_row(port_rows, reference_rows):
    assert [n for n, _ in port_rows] == [n for n, _ in reference_rows]
    assert len(port_rows) == 6 + 3 + 8 + 3


def test_structural_columns_match_reference(port_rows, reference_rows):
    for (name, got), (_, want) in zip(port_rows, reference_rows):
        keys = [k for k in want if k in STRUCTURAL]
        assert keys, name
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}, name


def test_rows_carry_bound_and_hopper_model(port_rows):
    for name, derived in port_rows:
        if name.endswith("_speedup"):
            assert derived["wall_speedup"] == "nanx"   # nothing timed on CPU
            continue
        assert float(derived["bound_us"]) > 0, name
        assert "modeled_tpu_s" not in derived
        if name.startswith("floyd_warshall"):
            assert float(derived["modeled_s"]) > 0


@pytest.mark.parametrize("v", [2, 4, 8])
@pytest.mark.parametrize("mode,factor", [("T", 1), ("R", 2), ("T", 2)])
def test_table2_ir_metrics_match_reference(v, mode, factor):
    from benchmarks.vecadd_table2 import ir_metrics as ref_ir_metrics
    n = 1 << 14
    got_res, got_tp = paper.ir_metrics(n, v, mode, factor)
    want_res, want_tp = ref_ir_metrics(n, v, mode, factor)
    assert got_res == want_res
    assert got_tp == want_tp


def test_launcher_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paper.main(["--mode", "table6", "--smoke"])


def test_row_check_refuses_a_wrong_output():
    want = torch.arange(6.0)
    paper.check("same", want.clone(), want, 0.0)
    with pytest.raises(RuntimeError, match="differs"):
        paper.check("off", want + 1e-3, want, 0.0)
    paper.check("close", want * (1 + 1e-7), want, paper.RTOL_STENCIL)
    with pytest.raises(RuntimeError, match="relative error"):
        paper.check("far", want * 1.01, want, paper.RTOL_MATMUL)


def test_table6_distances_and_plain_version():
    d = paper.distances(16, torch.Generator().manual_seed(0),
                        torch.device("cpu"))
    assert torch.all(d.diagonal() == 0)
    off = d[~torch.eye(16, dtype=torch.bool)]
    assert off.min() >= 0.1 and off.max() <= 10.0
    from repro.kernels import ref as jax_ref
    want = np.asarray(jax_ref.floyd_warshall(jnp.asarray(d.numpy())))
    got = paper.ref.floyd_warshall(d)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bn,factor,mode", [(64, 1, "T"), (64, 2, "R"),
                                            (128, 2, "R"), (64, 2, "T")])
def test_table3_model_is_the_reference_formula(monkeypatch, bn, factor,
                                               mode):
    """With the reference's TPU constants swapped in, the port's Table 3
    model gives the reference's numbers: only the constants differ."""
    from benchmarks import matmul_table3
    from repro.core.ir import PumpSpec as JaxPumpSpec
    from repro.core.pump_plan import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.core import pump_plan
    monkeypatch.setattr(pump_plan, "HBM_BW", HBM_BW)
    monkeypatch.setattr(pump_plan, "PEAK_FLOPS_FP32", PEAK_FLOPS_BF16)
    got = paper.modeled_gops(64, bn, 32, paper.PumpSpec(factor, mode))
    want = matmul_table3.modeled_gops(64, bn, 32, JaxPumpSpec(factor, mode))
    assert got == pytest.approx(want, rel=1e-12)
