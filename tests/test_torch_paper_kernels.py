"""The port's paper kernels (vecadd, matmul, stencil chain, Floyd-Warshall)
on the CPU, where ``ops`` takes their plain versions, against the JAX
package's Pallas kernels in interpret mode, on the same seeded numpy
inputs and over the reference tests' own parameter grids
(``tests/test_kernels.py``).

Tolerances: vecadd and Floyd-Warshall exact (the same single operations in
the same order); bf16 vecadd within one bf16 ulp; matmul exact on
integer-valued inputs (every partial sum is an exact fp32 integer) and
5e-6 of the largest output on normal inputs (the two sum K products in
different orders); stencil 5e-6 (the same order, but XLA may fuse).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.core.ir import PumpSpec  # noqa: E402
from repro_torch.kernels import floyd_warshall as port_fw  # noqa: E402
from repro_torch.kernels import matmul as port_mm  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.kernels import stencil as port_st  # noqa: E402
from repro_torch.kernels import vecadd as port_va  # noqa: E402

MODES = [("T", 1), ("T", 2), ("T", 4), ("R", 2)]


def _launch_counts():
    return (port_va.launches, port_mm.launches, port_st.launches,
            port_fw.launches)


@pytest.fixture(autouse=True)
def _cpu_takes_the_plain_versions():
    before = _launch_counts()
    yield
    assert _launch_counts() == before


def _pumps(mode, m):
    from repro.core.ir import PumpSpec as JaxPumpSpec
    return PumpSpec(factor=m, mode=mode), JaxPumpSpec(factor=m, mode=mode)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------------ vecadd --
@pytest.mark.parametrize("n", [64, 256, 100])
@pytest.mark.parametrize("mode", ["T", "R"])
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vecadd_matches_pallas_kernel(n, mode, m, dtype):
    from repro.kernels import ops as jax_ops
    x, y = _normal(0, n), _normal(1, n)
    port_spec, jax_spec = _pumps(mode, m)
    tdt = getattr(torch, dtype)
    got = port_ops.vecadd(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(y).to(tdt), vector_width=8,
                          pump=port_spec)
    want = jax_ops.vecadd(jnp.asarray(x, dtype), jnp.asarray(y, dtype),
                          vector_width=8, pump=jax_spec)
    assert got.dtype == tdt and got.shape == (n,)
    want32 = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), want32)
    else:   # one bf16 ulp: 2^-7 of the value's binade
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want32),
                                                  2.0 ** -126))) - 7)
        assert np.all(np.abs(got.float().numpy() - want32) <= ulp)


# ------------------------------------------------------------------ matmul --
@pytest.mark.parametrize("shape", [(64, 64, 64), (96, 32, 128),
                                   (100, 70, 50)])
@pytest.mark.parametrize("mode,m", MODES)
def test_matmul_matches_pallas_kernel(shape, mode, m):
    from repro.kernels import ops as jax_ops
    msz, ksz, nsz = shape
    a, b = _normal(0, (msz, ksz)), _normal(1, (ksz, nsz))
    port_spec, jax_spec = _pumps(mode, m)
    got = port_ops.matmul(torch.from_numpy(a), torch.from_numpy(b), bm=32,
                          bn=32, bk=16, pump=port_spec)
    want = np.asarray(jax_ops.matmul(jnp.asarray(a), jnp.asarray(b), bm=32,
                                     bn=32, bk=16, pump=jax_spec))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=5e-6 * np.abs(want).max())


@pytest.mark.parametrize("mode,m", MODES)
def test_matmul_integer_inputs_exact(mode, m):
    from repro.kernels import ops as jax_ops
    rng = np.random.default_rng(2)
    a = rng.integers(-4, 5, (100, 70)).astype(np.float32)
    b = rng.integers(-4, 5, (70, 50)).astype(np.float32)
    port_spec, jax_spec = _pumps(mode, m)
    got = port_ops.matmul(torch.from_numpy(a), torch.from_numpy(b), bm=32,
                          bn=32, bk=16, pump=port_spec)
    want = jax_ops.matmul(jnp.asarray(a), jnp.asarray(b), bm=32, bn=32,
                          bk=16, pump=jax_spec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_matmul_bf16_rounds_once():
    from repro.kernels import ref as jax_ref
    a, b = _normal(0, (64, 64)), _normal(1, (64, 64))
    got = port_ops.matmul(torch.from_numpy(a).bfloat16(),
                          torch.from_numpy(b).bfloat16(), pump=2)
    want = jax_ref.matmul(jnp.asarray(a, jnp.bfloat16),
                          jnp.asarray(b, jnp.bfloat16),
                          out_dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2.0 ** -7,
                               atol=1e-6)


# ----------------------------------------------------------------- stencil --
@pytest.mark.parametrize("kind", ["jacobi", "diffusion"])
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("stages", [1, 3])
def test_stencil_matches_pallas_kernel(kind, m, stages):
    from repro.kernels import ops as jax_ops
    x = _normal(0, (10, 8, 8))
    got = port_ops.stencil_chain(torch.from_numpy(x), stages, kind=kind,
                                 pump=m)
    want = jax_ops.stencil_chain(jnp.asarray(x), stages, kind=kind, pump=m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-6,
                               atol=5e-6)


# ----------------------------------------- the stencil kernel's grid plan --
def test_stencil_tile_rows_and_shared_memory_by_hand():
    """A staged plane is rows + 2 rows of 256 + 8 floats and the ring holds
    2 M + 1 of them: 3 x 34 x 264 x 4 = 107,712 B at M 1 and 5 x 34 x 264 x
    4 = 179,520 at M 2 (32 rows); M 4's 9 planes fit 227 KB only at 16 rows
    (9 x 18 x 264 x 4 = 171,072), M 8's 17 at 8 rows (17 x 10 x 264 x 4 =
    179,520); M 16's 33 fit at none (348,480 at 8 rows)."""
    from repro_torch.core.pump_plan import SMEM_BYTES
    rows = [port_st.tile_rows(m) for m in (1, 2, 4, 8, 16)]
    assert rows == [32, 32, 16, 8, 0]
    assert [port_st.smem_bytes(m, r) for m, r in zip((1, 2, 4, 8), rows)] \
        == [107712, 179520, 171072, 179520]
    assert port_st.smem_bytes(4, 32) > SMEM_BYTES
    assert port_st.smem_bytes(16, 8) == 348480 > SMEM_BYTES


# (d0, d1, d2), M, blocks an SM holds -> (rows, tiles_x, tiles_y, segments,
# seg), worked by hand: 256-wide tiles; segments = min(132 x blocks //
# tiles, interior // 40), at least 1; seg = ceil(interior / segments)
# rounded up to a multiple of M; segments = ceil(interior / seg).
STENCIL_PLANS = [
    ((514, 512, 512), 1, 1, (32, 2, 16, 4, 128)),   # 132 // 32 = 4
    ((514, 512, 512), 2, 1, (32, 2, 16, 4, 128)),
    ((514, 512, 512), 4, 1, (16, 2, 32, 2, 256)),   # 132 // 64 = 2
    ((514, 512, 512), 8, 1, (8, 2, 64, 1, 512)),    # 132 // 128 = 1
    ((514, 512, 512), 1, 3, (32, 2, 16, 12, 43)),   # 396 // 32 = 12 = 512 // 40
    ((514, 512, 512), 2, 3, (32, 2, 16, 12, 44)),   # 43 rounded up to M 2
    ((10, 8, 8), 2, 1, (32, 1, 1, 1, 8)),           # 8 // 40 = 0 -> 1
    ((66, 100, 300), 2, 2, (32, 2, 4, 1, 64)),      # 64 // 40 = 1
    ((65540, 4, 4), 1, 1, (32, 1, 1, 132, 497)),    # 65,538 slabs: one wave
]


@pytest.mark.parametrize("shape,m,bps,want", STENCIL_PLANS)
def test_stencil_plan_by_hand(shape, m, bps, want):
    plan = port_st.plan(*shape, m, bps)
    assert tuple(plan) == want
    interior = shape[0] - 2
    assert plan.seg % m == 0
    assert (plan.segments - 1) * plan.seg < interior <= plan.segments \
        * plan.seg
    assert plan.segments <= max(1, 132 * bps // (plan.tiles_x
                                                 * plan.tiles_y))


def test_stencil_wrapper_raises_where_it_cannot_launch():
    """The shapes the wrapper raised on before still raise (indivisible
    interiors; a ring too big for shared memory, now from M 16 on instead
    of M 49); the grid's y extent bounds tile rows; a volume of more than
    65,535 slabs, which the slab-per-block grid refused, now plans to one
    wave; and a CPU tensor never reaches the kernel."""
    for shape, m in (((9, 8, 8), 2), ((12, 8, 8), 4), ((10, 8, 8), 16),
                     ((51, 8, 8), 49), ((10, 65535 * 8 + 1, 300), 8)):
        with pytest.raises(ValueError):
            port_st.launch_rows(*shape, m)
    assert port_st.launch_rows(10, 8, 8, 8) == 8
    assert port_st.launch_rows(10, 65535 * 8, 300, 8) == 8
    assert port_st.launch_rows(65540, 4, 4, 1) == 32
    with pytest.raises(ValueError, match="CUDA"):
        port_st.stencil_chain_cuda(torch.zeros(10, 8, 8), 1, pump=2)


# ---------------------------------------------------------- floyd-warshall --
@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_floyd_warshall_matches_pallas_kernel(n, m):
    from repro.kernels import ops as jax_ops
    rng = np.random.default_rng(n)
    d = rng.uniform(0.1, 10.0, (n, n)).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    got = port_ops.floyd_warshall(torch.from_numpy(d), pump=m)
    want = jax_ops.floyd_warshall(jnp.asarray(d), pump=m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------- shapes the pump cannot divide --
def _both_raise(port_call, jax_call):
    with pytest.raises(ValueError):
        port_call()
    with pytest.raises(ValueError):
        jax_call()


def test_indivisible_pumps_raise_as_the_reference():
    from repro.core.ir import PumpSpec as JaxPumpSpec
    from repro.kernels import ops as jax_ops
    x = np.zeros(64, np.float32)
    _both_raise(lambda: port_ops.vecadd(torch.from_numpy(x),
                                        torch.from_numpy(x), vector_width=6,
                                        pump=PumpSpec(4, "R")),
                lambda: jax_ops.vecadd(jnp.asarray(x), jnp.asarray(x),
                                       vector_width=6,
                                       pump=JaxPumpSpec(4, "R")))
    a = np.zeros((64, 64), np.float32)
    _both_raise(lambda: port_ops.matmul(torch.from_numpy(a),
                                        torch.from_numpy(a), bm=32, bn=36,
                                        bk=16, pump=PumpSpec(8, "R")),
                lambda: jax_ops.matmul(jnp.asarray(a), jnp.asarray(a),
                                       bm=32, bn=36, bk=16,
                                       pump=JaxPumpSpec(8, "R")))
    v = np.zeros((9, 8, 8), np.float32)
    _both_raise(lambda: port_ops.stencil_chain(torch.from_numpy(v), 1,
                                               pump=2),
                lambda: jax_ops.stencil_chain(jnp.asarray(v), 1, pump=2))
    d = np.zeros((10, 10), np.float32)
    _both_raise(lambda: port_ops.floyd_warshall(torch.from_numpy(d), pump=4),
                lambda: jax_ops.floyd_warshall(jnp.asarray(d), pump=4))


@pytest.mark.parametrize("pump", ["auto", "measure"])
def test_planned_pumps_need_the_compiler(pump, tmp_path, monkeypatch):
    """vecadd and matmul plan 'auto' / 'measure' through the port's compiler
    (its cache in a scratch directory) and agree with the plain versions;
    the stencil and Floyd-Warshall take no planned pump, as in the
    reference."""
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    x = torch.arange(64, dtype=torch.float32)
    y = torch.ones(64)
    assert torch.equal(port_ops.vecadd(x, y, pump=pump), x + y)
    # 64^3 divides the default tile, so 'measure' times the compiled graph;
    # 8^3 does not, so it falls back to the capacity model with a warning
    a = (torch.arange(64 * 64) % 7).float().view(64, 64)
    assert torch.equal(port_ops.matmul(a, a.T, pump=pump), a @ a.T)
    a, b = x.view(8, 8) % 5, y.view(8, 8)
    if pump == "measure":
        with pytest.warns(UserWarning, match="not executable"):
            assert torch.equal(port_ops.matmul(a, b, pump=pump), a @ b)
    else:
        assert torch.equal(port_ops.matmul(a, b, pump=pump), a @ b)
    assert (tmp_path / "compile_cache.json").exists()
    for call in (lambda: port_ops.stencil_chain(x.view(4, 4, 4), 1,
                                                pump=pump),
                 lambda: port_ops.floyd_warshall(x.view(8, 8), pump=pump)):
        with pytest.raises(TypeError, match="compiler"):
            call()


# ------------------------------------------------------ structural metrics --
SPECS = [(1, "T"), (2, "T"), (4, "T"), (2, "R"), (4, "R")]


@pytest.mark.parametrize("factor,mode", SPECS)
def test_structural_metrics_match_reference(factor, mode):
    import repro.kernels.floyd_warshall as ref_fw
    import repro.kernels.matmul as ref_mm
    import repro.kernels.stencil as ref_st
    import repro.kernels.vecadd as ref_va
    port_spec, jax_spec = _pumps(mode, factor)
    for n in (1024, 16384, 1 << 28):
        for v in (2, 4, 8):
            assert port_va.grid_steps(n, v, port_spec) \
                == ref_va.grid_steps(n, v, jax_spec)
    for size in (256, 4096):
        for bm, bn, bk in ((32, 32, 16), (64, 64, 32), (64, 128, 32),
                           (128, 128, 128)):
            assert port_mm.transactions(size, size, size, bm, bn, bk,
                                        port_spec) \
                == ref_mm.transactions(size, size, size, bm, bn, bk,
                                       jax_spec)
            assert port_mm.compute_tile_bytes(bm, bn, port_spec) \
                == ref_mm.compute_tile_bytes(bm, bn, jax_spec)
    for d0, d1, d2 in ((18, 16, 16), (514, 512, 512)):
        assert port_st.transactions(d0, factor) \
            == ref_st.transactions(d0, factor)
        assert port_st.slab_bytes(d1, d2, port_spec) \
            == ref_st.slab_bytes(d1, d2, jax_spec)
    for n in (128, 500, 4096):
        assert port_fw.transactions(n, factor) \
            == ref_fw.transactions(n, factor)


def test_integer_pump_is_mode_t():
    assert port_va.grid_steps(1024, 8, 2) \
        == port_va.grid_steps(1024, 8, PumpSpec(2, "T")) == 64
    assert port_mm.compute_tile_bytes(64, 64, 2) == 64 * 64 * 4
