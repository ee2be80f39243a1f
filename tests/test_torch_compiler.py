"""The port's compiler (``repro_torch.compiler``) against the JAX package's
(``repro.compiler``), on the CPU, at the differential harness's shapes.

- every builder through the reference's ``compile(backend='jax')`` and the
  port's ``compile(backend='torch')``, M in {1, 2, 4} x {T, R}, on the same
  seeded integer-valued inputs: exact where the math is add / mul / min,
  rtol = atol = 5e-6 where exp enters (flash's running max ``m`` included:
  it is never held bit-exact across frameworks, ROADMAP.md queue 3);
- the four builders whose regions reach the region kernel's form through
  the reference's ``compile(backend='pallas', pallas_mode='interpret')`` and
  the port's ``compile(backend='hopper')`` on CPU tensors (which runs the
  kernels' plain versions), M in {1, 2} x {T, R};
- planning parity: regions, grids, blocks, reduce and carry symbols, pump
  and notes equal the reference's, and the emission tiers map ``pallas``
  to ``hopper`` (for a carry region where its kernel is built for the
  plan's pump case and shape, else ``carryloop``);
- the port's numpy executor against the reference's;
- the compile cache: measure and replay, corrupted caches, the memo's
  closure identity, quarantine, the toolchain key;
- ``ops.vecadd / matmul / grouped_gemm`` with ``pump='auto' / 'measure'``
  held to their plain versions.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import compiler as jcompiler  # noqa: E402
from repro.compiler import pallas_backend as jpb  # noqa: E402
from repro.core import executor as jexecutor  # noqa: E402
from repro.core.autopump import BUILDERS as JBUILDERS  # noqa: E402

from repro_torch import compiler  # noqa: E402
from repro_torch.compiler import CompileCache, hopper_backend as hb  # noqa: E402
from repro_torch.compiler import cache as cache_mod  # noqa: E402
from repro_torch.core import executor  # noqa: E402
from repro_torch.core.autopump import BUILDERS, autopump  # noqa: E402
from repro_torch.core.ir import Graph  # noqa: E402
from repro_torch.core.symbolic import AccessPattern, Affine, Domain  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

from differential import FACTORS, MODES, cases as diff_cases  # noqa: E402

CASES0 = diff_cases(0)
CASES1 = diff_cases(1)
ROW3 = ("vecadd", "matmul", "grouped_gemm", "grouped_gemm_ragged",
        "ssd_decode")
TOL = 5e-6


def _tensors(inputs):
    return {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}


def _compare(case, got, want, what):
    for name in case.outputs:
        a, b = np.asarray(got[name], np.float32), np.asarray(want[name])
        if case.exact:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg=f"{what} {name}")


def _port(case, factor, mode, backend):
    g, _ = BUILDERS[case.kernel](*case.args, **case.kwargs)
    return compiler.compile(g, factor=factor, mode=mode, backend=backend,
                            cache=False, memoize=False, device="cpu")


def _ref(case, factor, mode, backend, **kw):
    g, _ = JBUILDERS[case.kernel](*case.args, **case.kwargs)
    return jcompiler.compile(g, factor=factor, mode=mode, backend=backend,
                             cache=False, memoize=False, **kw)


# ------------------------------------------------ backends vs the reference --
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("kernel", sorted(CASES0))
def test_torch_backend_matches_jax_backend(kernel, factor, mode):
    case = CASES0[kernel]
    inputs = case.inputs()
    got = _port(case, factor, mode, "torch")(_tensors(inputs))
    want = _ref(case, factor, mode, "jax")(inputs)
    _compare(case, {k: v.numpy() for k, v in got.items()}, want,
             f"{kernel} M{factor} {mode}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("factor", (1, 2))
@pytest.mark.parametrize("kernel", ROW3)
def test_hopper_backend_matches_pallas_interpret(kernel, factor, mode):
    case = CASES0[kernel]
    inputs = case.inputs()
    kern = _port(case, factor, mode, "hopper")
    got = kern(_tensors(inputs))
    ref_kern = _ref(case, factor, mode, "pallas", pallas_mode="interpret")
    want = ref_kern(inputs)
    _compare(case, {k: v.numpy() for k, v in got.items()}, want,
             f"{kernel} M{factor} {mode}")
    tiers = [e["tier"] for e in kern.report.emission.values()]
    ref_tiers = [e["tier"] for e in ref_kern.report.emission.values()]
    assert ref_tiers == ["pallas"] and tiers == ["hopper"]


# -------------------------------------------------------- planning parity --
def _blocked(ba):
    """A BlockedAccess as plain tuples (the two packages' classes differ)."""
    return (ba.block, ba.grid,
            tuple((a.terms, a.const, a.tables) for a in ba.offsets))


def _plans(kern, mod):
    out = []
    for region in mod.partition_regions(kern.graph):
        notes = []
        plan = mod.plan_region(kern.graph, region, notes.append)
        row = [region.name, region.computes, region.mode, region.pump,
               [(c, m) for c, m, _a in region.outputs], notes]
        if plan is not None:
            row += [plan.grid, plan.reduce_syms, plan.carry_syms,
                    plan.outer_syms, plan.pump, plan.mode, plan.pallas_ok,
                    sorted(plan.carry_narrow.items()),
                    sorted((k, _blocked(v)) for k, v in plan.blocks.items()),
                    [(c, m, _blocked(ba)) for c, m, ba in plan.outputs]]
        out.append(row)
    return out


PARITY = [(si, name) for si, reg in ((0, CASES0), (1, CASES1))
          for name in sorted(reg)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("si,kernel", PARITY)
def test_planning_parity(si, kernel, factor, mode):
    case = (CASES0, CASES1)[si][kernel]
    kern = _port(case, factor, mode, "none")
    ref_kern = _ref(case, factor, mode, "none")
    assert kern.spec.factor == ref_kern.spec.factor
    assert _plans(kern, hb) == _plans(ref_kern, jpb)
    # the emission provenance: the same regions, grids and notes; pallas is
    # hopper here, a carry region's where its kernel is built for the case
    emission, ref_emission = {}, {}
    hb.lower_hopper(kern.graph, emission=emission)
    jpb.lower_pallas(ref_kern.graph, pallas_mode="interpret",
                     emission=ref_emission)
    assert list(emission) == list(ref_emission)
    for name, ref_e in ref_emission.items():
        e = emission[name]
        want = ref_e["tier"]
        if want == "pallas":
            want = "hopper" if not ref_e["carry"] or _carry_built(
                case, e["pump"], e["mode"]) else "carryloop"
        assert e["tier"] == want, (name, e)
        for key in ("pump", "mode", "grid", "reduce", "carry", "outputs"):
            assert e[key] == ref_e[key], key
        assert e["why"][:len(ref_e["why"])] == ref_e["why"]


def _carry_built(case, pump, mode):
    """Whether the carry builder's kernel is built for a plan's pump case
    at the case's (fp32) shape: the kernels' own ``built`` sets."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    f32 = torch.float32
    if case.kernel == "flash_attention":
        return fa.built(pump, mode, case.args[4], f32)
    if case.kernel == "decode_attention":
        h, d = case.args[1], case.args[3]
        return da.built(pump, mode, h // case.kwargs.get("hkv", h), d, f32)
    assert case.kernel == "ssd_scan"
    return ss.built(pump, mode)


@pytest.mark.parametrize("si,kernel", PARITY)
def test_executor_matches_reference(si, kernel):
    case = (CASES0, CASES1)[si][kernel]
    inputs = case.inputs()
    g, _ = BUILDERS[case.kernel](*case.args, **case.kwargs)
    jg, _ = JBUILDERS[case.kernel](*case.args, **case.kwargs)
    got = executor.run(g, dict(inputs))
    want = jexecutor.run(jg, dict(inputs))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ------------------------------------------------------ the hopper tier --
def _chain_graph(n=32, v=4):
    """Two computes through an intermediate memory: z = (x + 1) * 2."""
    g = Graph("chain")
    g.memory("x", (n,))
    g.memory("t", (n,))
    g.memory("z", (n,))
    dom = Domain.of(("i", 0, n // v))
    acc = AccessPattern(dom, (Affine.of("i", v),), width=v)
    add = lambda in0: {"out0": in0 + 1.0}     # noqa: E731
    scale = lambda in0: {"out0": in0 * 2.0}   # noqa: E731
    g.compute("add1", dom, fn=add, tile_fn=add, vector_width=v,
              tile_op="add")
    g.compute("scale", dom, fn=scale, tile_fn=scale, vector_width=v)
    g.connect("x", "add1", acc)
    g.connect("add1", "t", acc)
    g.connect("t", "scale", acc)
    g.connect("scale", "z", acc)
    return g


def test_region_the_kernel_cannot_take_drops_a_tier(tmp_path):
    """A fused two-compute region is no single tile op: it drops to
    blockloop with the reason recorded, and stays exact."""
    kern = compiler.compile(_chain_graph(), factor=2, backend="hopper",
                            cache=CompileCache(tmp_path / "c.json"),
                            memoize=False, device="cpu")
    (em,) = kern.report.emission.values()
    assert em["tier"] == "blockloop"
    assert any("takes one compute" in w for w in em["why"])
    x = torch.arange(32, dtype=torch.float32)
    assert torch.equal(kern({"x": x})["z"], (x + 1.0) * 2.0)


def test_region_descriptor_of_the_ragged_gemm():
    """The ragged grouped GEMM's plan becomes a dot descriptor whose row and
    expert tables are scaled by the memory strides."""
    case = CASES0["grouped_gemm_ragged"]
    kern = _port(case, 2, "T", "none")
    (region,) = hb.partition_regions(kern.graph)
    plan = hb.plan_region(kern.graph, region, lambda _m: None)
    desc, why = hb.region_descriptor(kern.graph, plan)
    assert why == "" and desc.op == "dot" and desc.beats == 2
    x, w = desc.ins
    assert (x.rows, x.cols, w.rows, w.cols) == (8, 8, 8, 8)
    assert [t[1] for t in x.tables] == [tuple(16 * r for r in
                                              (0, 8, 16, 24, 32))]
    assert [t[1] for t in w.tables] == [tuple(16 * 8 * e for e in
                                              (0, 0, 1, 1, 1))]
    assert desc.packed().numel() == 90 and desc.packed().dtype == torch.int32


def test_hopper_rejects_a_tile_over_the_kernels_side():
    g, _ = BUILDERS["matmul"](512, 512, 256, bm=256, bn=128, bk=128)
    kern = compiler.compile(g, factor=1, backend="hopper", cache=False,
                            memoize=False, device="cpu")
    (em,) = kern.report.emission.values()
    assert em["tier"] == "blockloop"
    assert any("over the kernel's 128 x 128" in w for w in em["why"])


# --------------------------------------------------------------- the cache --
def test_autotune_measure_and_cache_replay(tmp_path):
    path = tmp_path / "cache.json"
    g, est = BUILDERS["vecadd"](256, vector_width=8)
    k1 = compiler.compile(g, factor="auto", estimate=est, backend="hopper",
                          autotune="measure", cache=CompileCache(path),
                          memoize=False, device="cpu")
    at = k1.report.autotune
    assert at["policy"] == "measure" and at["replayed"] is False
    assert len(at["timings_us"]) >= 2               # measured >= 2 candidates
    assert at["winner"] == k1.spec.factor
    assert k1.report.measurements == len(at["timings_us"])

    # a fresh memo and cache instance (≙ a fresh process): a disk hit that
    # replays the measured plan with zero measurements
    compiler.clear_memo()
    g2, _ = BUILDERS["vecadd"](256, vector_width=8)
    k2 = compiler.compile(g2, factor="auto", estimate=est, backend="hopper",
                          autotune="measure", cache=CompileCache(path),
                          device="cpu")
    assert k2.report.served_from == "disk"
    assert k2.report.measurements == 0
    assert k2.report.autotune["replayed"] is True
    assert k2.spec.factor == k1.spec.factor
    x = torch.arange(256, dtype=torch.float32)
    assert torch.equal(k2({"x": x, "y": x})["z"], 2 * x)


def test_autotune_measure_requires_executable_backend():
    g, est = BUILDERS["vecadd"](64, vector_width=8)
    with pytest.raises(ValueError):
        compiler.compile(g, estimate=est, backend="none",
                         autotune="measure", cache=False)


def test_autotune_key_distinct_from_capacity_plan(tmp_path):
    path = tmp_path / "cache.json"
    g, est = BUILDERS["vecadd"](256, vector_width=8)
    compiler.compile(g, factor="auto", estimate=est, backend="hopper",
                     cache=CompileCache(path), memoize=False, device="cpu")
    k = compiler.compile(g, factor="auto", estimate=est, backend="hopper",
                         autotune="measure", cache=CompileCache(path),
                         memoize=False, device="cpu")
    assert k.report.served_from is None             # not the heuristic entry
    assert k.report.autotune and k.report.autotune["replayed"] is False


@pytest.mark.parametrize("payload", [
    "{not valid json!!",              # syntactically broken
    '{"version": 1, "entries"',       # truncated mid-write
    json.dumps([1, 2, 3]),            # wrong top-level schema
    json.dumps({"version": 1, "entries": {"k": "not-a-plan"}}),
])
def test_corrupted_cache_falls_back_to_cold_compile(tmp_path, payload):
    path = tmp_path / "cache.json"
    path.write_text(payload)
    g, _ = BUILDERS["vecadd"](64, vector_width=8)
    kern = compiler.compile(g, factor=2, cache=CompileCache(path),
                            memoize=False, device="cpu")
    assert kern.report.served_from is None         # cold, not crashed
    x = torch.arange(64, dtype=torch.float32)
    assert torch.equal(kern({"x": x, "y": x})["z"], x + x)


def test_corrupted_cache_entry_value_is_a_miss(tmp_path):
    path = tmp_path / "cache.json"
    g, _ = BUILDERS["vecadd"](64, vector_width=8)
    compiler.compile(g, factor=2, cache=CompileCache(path), memoize=False,
                     device="cpu")
    blob = json.loads(path.read_text())
    blob["entries"] = {k: {"mode": "T"} for k in blob["entries"]}  # no factor
    path.write_text(json.dumps(blob))
    kern = compiler.compile(g, factor=2, cache=CompileCache(path),
                            memoize=False, device="cpu")
    assert kern.report.served_from is None
    assert kern.spec.factor == 2


def _closure_graph(value, n=8):
    g = Graph("closure")
    g.memory("x", (n,))
    g.memory("z", (n,))
    dom = Domain.of(("i", 0, n))
    acc = AccessPattern(dom, (Affine.of("i"),))
    g.compute("mul", dom, fn=lambda in0: {"out0": in0 * value})
    g.connect("x", "mul", acc)
    g.connect("mul", "z", acc)
    return g


def test_memo_distinguishes_closure_values(tmp_path):
    """Structurally identical graphs whose fn closures capture different
    values (scalars, or tensors whose repr elides the difference) must not
    share a memo entry."""
    compiler.clear_memo()
    cache = CompileCache(tmp_path / "c.json")
    x = torch.ones(2048)
    w1 = torch.zeros(2048)
    w2 = w1.clone()
    w2[1024] = 5.0
    assert repr(w1) == repr(w2)          # the trap this test guards against
    for a, b in ((2.0, 3.0), (w1, w2)):
        k1 = compiler.compile(_closure_graph(a, 2048), factor=1, cache=cache,
                              device="cpu")
        k2 = compiler.compile(_closure_graph(b, 2048), factor=1, cache=cache,
                              device="cpu")
        assert torch.equal(k1({"x": x})["z"], x * a)
        assert torch.equal(k2({"x": x})["z"], x * b)


def test_compile_memo_serves_repeat_requests(tmp_path):
    compiler.clear_memo()
    cache = CompileCache(tmp_path / "cache.json")
    g1, _ = BUILDERS["vecadd"](64, vector_width=8)
    k1 = compiler.compile(g1, factor=2, cache=cache, device="cpu")
    g2, _ = BUILDERS["vecadd"](64, vector_width=8)   # structural rebuild
    k2 = compiler.compile(g2, factor=2, cache=cache, device="cpu")
    assert k2.fn is k1.fn and k2.graph is k1.graph
    assert k2.report.served_from == "memory" and k2.report.cache_hits >= 1
    assert k1.report.served_from is None and k1.report.cache_hits == 0
    fresh = CompileCache(tmp_path / "fresh.json")
    k3 = compiler.compile(g2, factor=2, cache=fresh, device="cpu")
    assert k3.report.served_from == "memory"
    assert (tmp_path / "fresh.json").exists() and len(fresh) == 1


def test_plan_shared_across_backends(tmp_path):
    compiler.clear_memo()
    cache = CompileCache(tmp_path / "c.json")
    g, est = BUILDERS["vecadd"](64, vector_width=8)
    k_none = compiler.compile(g, factor="auto", estimate=est, backend="none",
                              cache=cache, memoize=False)
    k_hop = compiler.compile(g, factor="auto", estimate=est,
                             backend="hopper", cache=cache, memoize=False,
                             device="cpu")
    assert k_hop.report.served_from == "disk"
    assert k_hop.spec.factor == k_none.spec.factor


def test_quarantine_backoff_window_respected(tmp_path):
    import time
    compiler.clear_memo()
    pol = compiler.QuarantinePolicy(base_s=10.0, cap_s=40.0, budget=3)
    assert [pol.window_s(n) for n in (1, 2, 3, 9)] == [10.0, 20.0, 40.0, 40.0]
    cache = CompileCache(tmp_path / "c.json", quarantine=pol)
    g, _ = BUILDERS["vecadd"](64, vector_width=8)
    args = dict(factor=2, backend="hopper", cache=cache, memoize=False,
                device="cpu")
    key = compiler.compile(g, **args).report.cache_key
    qkey = f"{key}:hopper"
    cache.record_failure(qkey, "nonfinite")
    with pytest.raises(compiler.PlanQuarantined):
        compiler.compile(g, **args)
    # another backend of the same plan is not indicted
    assert compiler.compile(g, **dict(args, backend="torch")).backend \
        == "torch"
    # the ledger persists (a fresh store sees it); an expired window
    # requalifies the rung but keeps the count; a success clears it
    assert CompileCache(tmp_path / "c.json").quarantine_entries()[qkey][
        "fails"] == 1
    cache.record_failure(qkey, "nonfinite", now=time.time() - 3600.0)
    assert cache.quarantined(qkey) is None
    assert compiler.compile(g, **args).backend == "hopper"
    assert cache.quarantine_entries()[qkey]["fails"] == 2
    cache.record_success(qkey)
    assert qkey not in CompileCache(tmp_path / "c.json").quarantine_entries()


def test_cache_key_folds_the_toolchain(monkeypatch, tmp_path):
    """The key carries torch's and CUDA's versions, the device and the
    region kernel's source; the default file is the port's own."""
    env = cache_mod._env_fingerprint()
    assert f"torch-{torch.__version__}" in env and "region-" in env
    monkeypatch.delenv("REPRO_TORCH_CACHE_DIR", raising=False)
    path = cache_mod._default_path()
    assert path.parts[-3:] == (".cache", "repro_torch", "compile_cache.json")
    g, _ = BUILDERS["vecadd"](64, vector_width=8)
    k1 = compiler.request_key(g, factor=2)
    monkeypatch.setattr(cache_mod, "_ENV", env + "-other")
    assert compiler.request_key(g, factor=2) != k1


def test_misaligned_pump_factor_warns_in_report(tmp_path):
    g, _ = BUILDERS["vecadd"](64, vector_width=2)
    kern = compiler.compile(g, factor=3, backend="torch",
                            cache=CompileCache(tmp_path / "c.json"),
                            memoize=False, device="cpu")
    assert any("not divisible by pump factor 3" in w
               for w in kern.report.warnings)
    x = torch.arange(64, dtype=torch.float32)
    assert torch.equal(kern({"x": x, "y": torch.ones(64)})["z"], x + 1)


def test_autopump_routes_through_pipeline(tmp_path):
    compiler.clear_memo()
    cache = CompileCache(tmp_path / "cache.json")
    r = autopump("vecadd", 4096, cache=cache)
    assert [rec.name for rec in r.pipeline_report.records][0] == "streaming"
    assert r.pipeline_report.factor == r.spec.factor
    r2 = autopump("vecadd", 4096, cache=cache)
    assert r2.pipeline_report.served_from in ("memory", "disk")
    assert r2.spec == r.spec
    assert compiler.Pipeline.default(factor=2).passes[2].name == "multipump"


# ------------------------------------------------------- planned pumps --
@pytest.mark.parametrize("pump", ["auto", "measure"])
@pytest.mark.parametrize("kernel", ["vecadd", "matmul", "grouped_gemm"])
def test_ops_planned_pump_matches_plain(kernel, pump, tmp_path, monkeypatch):
    """'auto' and 'measure' pick a spec through the compiler (its cache in
    a scratch directory) and the result is the plain version's."""
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    rng = np.random.default_rng(3)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-4, 5, shape).astype(np.float32))

    if kernel == "vecadd":
        x, y = ints(1024), ints(1024)
        got, want = ops.vecadd(x, y, pump=pump), ref.vecadd(x, y)
    elif kernel == "matmul":
        a, b = ints(128, 64), ints(64, 128)
        got, want = ops.matmul(a, b, pump=pump), ref.matmul(a, b)
    else:
        x, w = ints(48, 64), ints(3, 64, 128)
        sizes = [16, 0, 32]
        got = ops.grouped_gemm(x, w, group_sizes=sizes, pump=pump)
        want = ops.grouped_gemm(x, w, group_sizes=sizes)
    assert torch.equal(got, want)
    assert (tmp_path / "compile_cache.json").exists()
