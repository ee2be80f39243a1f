"""The port's plan registry (``repro_torch.compiler.registry``) against the
reference's (``tests/test_registry.py``, ``tests/test_decode.py``), on the
CPU.

- ``BucketPolicy`` equals the reference's on a hypothesis sweep and at
  every pow2 boundary; the five request builders return the reference's
  ``(args, kwargs, pads)``, a ``bfloat16`` request included.
- The measure lifecycle on a private cache: a cold miss measures, a warm
  call is a hit, a fresh registry (after ``clear_memo``) replays with
  ``measure_s == 0``; one plan per bucket; plans capped at the kernels'
  built sets, and ``compile(autotune='measure')`` counts an unbuilt
  candidate as failed.
- Values: flash at and past a bucket boundary, the SSD scan at a length
  that pads (with and without its final state) and decode attention at
  host and tensor positions against the JAX registry at 5e-6; ragged
  plans exact on integer values and never measured.
- Serving: a ``kernel_plan`` typo is rejected; after the ``plan_requests``
  warmup a real forward makes no miss; a tensor ``pos`` keys the full
  cache; a cold miss during a (simulated) CUDA graph capture does not
  measure; a failing plan, and a ragged plan emitted below the
  ``hopper`` tier, fall back to the direct op, counted; the engine serves
  from the registry it captured; the
  port's ``Engine(kernel_plan='measure')`` gives the JAX engine's greedy
  tokens (also under ``'measure'``) and the port's ``'direct'`` route's,
  for qwen3-0.6b and mamba2-1.3b at SMOKE.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis_compat import given, settings, st  # noqa: E402
from repro_torch import compiler  # noqa: E402
from repro_torch.compiler import CompileCache  # noqa: E402
from repro_torch.compiler import registry as port_reg  # noqa: E402
from repro_torch.compiler.registry import (BucketPolicy,  # noqa: E402
                                           PlanRegistry, default_registry,
                                           set_default_registry)
from repro_torch.configs.base import load_arch  # noqa: E402
from repro_torch.kernels import decode_attention as port_da  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402

TOL = dict(rtol=5e-6, atol=5e-6)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """A private compile cache for both packages and fresh default
    registries (process-wide state)."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax-cache"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    compiler.clear_memo()
    old = set_default_registry(None)
    yield
    set_default_registry(old)


def _jax_registry():
    jax = pytest.importorskip("jax")  # noqa: F841
    from repro.compiler import registry as jax_reg
    return jax_reg


def _ints(shape, seed=0, lo=-2, hi=3):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        lo, hi, shape).astype(np.float32))


# ------------------------------------------------------------- bucketing ----
def test_bucket_policy_boundaries():
    pol = BucketPolicy(seq_min=16, batch_min=1, row_block=16)
    assert [pol.bucket_seq(n) for n in (1, 16, 17, 32, 33)] == \
        [16, 16, 32, 32, 64]
    assert pol.bucket_batch(1) == 1 and pol.bucket_batch(3) == 4
    assert [pol.bucket_group(n) for n in (0, 1, 17)] == [0, 16, 32]
    assert pol.seq_grid(100) == [16, 32, 64, 128]
    assert pol.seq_grid(577) == [16, 32, 64, 128, 256, 512, 1024]
    assert pol.bucket_pos(0) == 16
    assert pol.bucket_pos(np.array([3, 40, 7])) == 64
    with pytest.raises(TypeError, match="host"):
        pol.bucket_pos(torch.tensor(3))


def _same_buckets(n: int, multiple: int):
    jax_reg = _jax_registry()
    for kw in ({}, dict(seq_min=8, batch_min=2, row_block=32)):
        ours, ref = BucketPolicy(**kw), jax_reg.BucketPolicy(**kw)
        assert ours.bucket_seq(n, multiple) == ref.bucket_seq(n, multiple)
        assert ours.bucket_batch(n) == ref.bucket_batch(n)
        assert ours.bucket_pos(n) == ref.bucket_pos(n)
        assert ours.bucket_group(n) == ref.bucket_group(n)
        assert ours.seq_grid(max(n, 1), multiple) == \
            ref.seq_grid(max(n, 1), multiple)


@given(n=st.integers(min_value=0, max_value=1 << 16),
       multiple=st.sampled_from([1, 3, 16, 24]))
@settings(max_examples=200, deadline=None)
def test_bucket_policy_matches_reference(n, multiple):
    _same_buckets(n, multiple)


def test_bucket_policy_pow2_boundaries_match_reference():
    for k in range(17):
        for n in ((1 << k) - 1, 1 << k, (1 << k) + 1):
            _same_buckets(n, 1)


REQUESTS = [
    ("flash_request", dict(b=3, h=4, hkv=2, s=13, t=13, d=8, causal=True)),
    ("flash_request", dict(b=8, h=16, hkv=8, s=512, t=512, d=128,
                           causal=True)),
    ("flash_request", dict(b=1, h=2, hkv=2, s=17, t=40, d=16, causal=False,
                           bq=64, bkv=32)),
    ("ssd_request", dict(b=2, l=24, h=2, p=4, n=4, chunk=8, n_groups=1)),
    ("ssd_request", dict(b=8, l=512, h=64, p=64, n=128, chunk=64,
                         n_groups=1, final_state=True)),
    ("decode_request", dict(b=2, h=4, hkv=2, t=21, d=8)),
    ("decode_request", dict(b=8, h=16, hkv=8, t=577, d=128, bkv=64)),
    ("ssd_decode_request", dict(b=3, h=64, p=64, n=128, n_groups=1)),
    ("grouped_request", dict(e=4, d=24, f=40, group_sizes=[5, 0, 17, 1])),
    ("grouped_request", dict(e=3, d=2048, f=1408, group_sizes=[384, 2, 0],
                             bf=64, bd=256)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_request_builders_match_reference(i, dtype):
    jax_reg = _jax_registry()
    name, kw = REQUESTS[i]
    ours = getattr(PlanRegistry(cache=False), name)(dtype=dtype, **kw)
    ref = getattr(jax_reg.PlanRegistry(cache=False), name)(dtype=dtype,
                                                           **kw)
    assert ours == ref


# ----------------------------------------- miss → measure → hit lifecycle --
def test_cold_miss_measure_then_warm_hit_then_replay(tmp_path):
    reg = PlanRegistry(cache=CompileCache(tmp_path / "plans.json"))
    q, k, v = (_ints((1, 2, 13, 8), s) for s in range(3))
    reg.flash_attention(q, k, v, causal=True)
    assert reg.stats.misses == 1 and reg.stats.hits == 0
    assert reg.stats.measure_s > 0
    [plan] = reg.plans()
    assert plan["measured"] and not plan["replayed"]
    assert plan["device"] == "cpu" and plan["args"] == [1, 2, 16, 16, 8]
    reg.flash_attention(q, k, v, causal=True)            # the fast path
    pad = [torch.nn.functional.pad(x, (0, 0, 0, 2)) for x in (q, k, v)]
    reg.flash_attention(*pad, causal=True)               # same bucket
    assert reg.stats.hits == 2 and reg.stats.misses == 1

    compiler.clear_memo()                                # a new process
    reg2 = PlanRegistry(cache=CompileCache(tmp_path / "plans.json"))
    reg2.flash_attention(q, k, v, causal=True)
    [plan2] = reg2.plans()
    assert plan2["replayed"] and plan2["served_from"] == "disk"
    assert plan2["factor"] == plan["factor"]
    assert reg2.stats.measure_s == 0.0 and reg2.stats.compile_s > 0
    reg2.reset()
    assert reg2.plans() == [] and reg2.stats.hits == reg2.stats.misses == 0


def test_same_bucket_different_shapes_share_one_plan():
    reg = PlanRegistry(pump=1, cache=False)
    for s in (9, 12, 16):
        x = _ints((1, 2, s, 8), s)
        reg.flash_attention(x, x[:, :1], x[:, :1], causal=True)
    assert reg.stats.misses == 1 and reg.stats.hits == 2
    assert len(reg.plans()) == 1


def test_plans_stay_inside_the_built_sets():
    """An fp32 cache at D 128 builds decode T1 / R2 / R4 only: its plans
    are capped at M 1 in mode T, a bf16 one at M 2; the scan at M 2."""
    f32, bf16 = torch.float32, torch.bfloat16
    args = (8, 16, 1024, 128)
    kw = dict(bkv=128, hkv=8, dtype="bfloat16", itemsize=2)
    assert port_reg._max_factor("decode_attention", args, kw,
                                "float32") == 1
    assert port_reg._max_factor("decode_attention", args, kw) == 2
    assert port_da.built(2, "T", 2, 128, bf16) \
        and not port_da.built(2, "T", 2, 128, f32)
    assert port_reg._max_factor("ssd_scan", (8, 512, 64, 64, 128), {}) == 2
    assert port_reg._max_factor("flash_attention", (8, 16, 512, 512, 128),
                                dict(dtype="float32")) == 2
    reg = PlanRegistry(cache=False)
    q = torch.zeros(1, 2, 128)
    cache = torch.zeros(1, 1, 40, 128)
    reg.decode_attention(q, cache, cache, 5)
    [plan] = reg.plans()
    assert plan["launch"] == "T1" and plan["measured"]


def test_measure_counts_unbuilt_candidates_as_failed():
    """fp32 flash at D 128 is built for T1 and T2 only: at max_factor 16
    the T4 and T8 candidates keep the carry region at ``carryloop``, so
    they fail instead of being timed."""
    from repro_torch.core.autopump import BUILDERS
    g, est = BUILDERS["flash_attention"](1, 2, 64, 64, 128, bq=16, bkv=8,
                                         itemsize=4, causal=True)
    kern = compiler.compile(g, factor="auto", estimate=est,
                            backend="hopper", autotune="measure",
                            cache=False, memoize=False, device="cpu")
    tuned = kern.report.autotune
    assert set(tuned["timings_us"]) == {"1", "2"}
    assert set(tuned["failed"]) == {"4", "8"}
    assert all("not built" in why for why in tuned["failed"].values())
    assert kern.spec.factor in (1, 2)


# ------------------------------------------------------------------ values --
@pytest.mark.parametrize("s", [13, 16, 17])
def test_flash_bucket_boundary_parity(s):
    jnp = pytest.importorskip("jax").numpy
    jax_reg = _jax_registry()
    b, h, hkv, d = 3, 4, 2, 8
    q, k, v = (_ints((b, hh, s, d), seed=i)
               for i, hh in enumerate((h, hkv, hkv)))
    got = PlanRegistry(pump=1, cache=False).flash_attention(q, k, v,
                                                            causal=True)
    want = jax_reg.PlanRegistry(pump=1, cache=False).flash_attention(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True)
    assert got.shape == (b, h, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _ssd_inputs(b=2, l=24, h=2, p=4, n=4):
    rng = np.random.default_rng(3)
    x = _ints((b, l, h, p), 1)
    dt = torch.from_numpy((rng.integers(0, 3, (b, l, h)) * 0.25 + 0.25)
                          .astype(np.float32))
    a = torch.from_numpy(-(rng.integers(0, 3, (h,)) * 0.25 + 0.25)
                         .astype(np.float32))
    return x, dt, a, _ints((b, l, 1, n), 2), _ints((b, l, 1, n), 4)


@pytest.mark.parametrize("final_state", [False, True])
def test_ssd_bucket_padding_parity(final_state):
    """L 24 buckets to 32 (the reference pads dt = 0 steps; the port runs
    the unpadded length at the plan's pump): the same y and state."""
    jnp = pytest.importorskip("jax").numpy
    jax_reg = _jax_registry()
    ins = _ssd_inputs()
    got = PlanRegistry(pump=1, cache=False).ssd_scan(
        *ins, chunk=8, final_state=final_state)
    want = jax_reg.PlanRegistry(pump=1, cache=False).ssd_scan(
        *(jnp.asarray(x.numpy()) for x in ins), chunk=8,
        final_state=final_state)
    got = got if final_state else (got,)
    want = want if final_state else (want,)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **TOL)


def test_decode_buckets_on_pos_and_matches_reference():
    jnp = pytest.importorskip("jax").numpy
    jax_reg = _jax_registry()
    q = _ints((2, 4, 8), 1)
    kc, vc = _ints((2, 2, 64, 8), 2), _ints((2, 2, 64, 8), 3)
    reg = PlanRegistry(pump=1, cache=False)
    jreg = jax_reg.PlanRegistry(pump=1, cache=False)
    for pos in (3, 20, [3, 40]):
        got = reg.decode_attention(q, kc, vc, pos)
        jpos = jnp.asarray(pos, jnp.int32)
        want = jreg.decode_attention(*(jnp.asarray(x.numpy())
                                       for x in (q, kc, vc)), jpos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sorted(pl["args"][2] for pl in reg.plans()) == [16, 32, 64]
    d = reg.stats.as_dict()
    assert d["decode"] == {"hits": 0, "misses": 3, "fallbacks": 0}
    reg.decode_attention(q, kc, vc, 21)                  # bucket 32: a hit
    assert reg.stats.phase["decode"]["hits"] == 1


def test_tensor_pos_keys_the_full_cache_bucket():
    reg = PlanRegistry(pump=1, cache=False)
    q = _ints((2, 4, 8), 1)
    kc, vc = _ints((2, 2, 40, 8), 2), _ints((2, 2, 40, 8), 3)
    got = reg.decode_attention(q, kc, vc, torch.tensor(7))
    [plan] = reg.plans()
    assert plan["args"][2] == 64                          # bucket_seq(40)
    torch.testing.assert_close(got, port_ops.decode_attention(q, kc, vc, 7),
                               rtol=0, atol=0)


@pytest.mark.parametrize("ragged_pump", [None, "auto"])
def test_ragged_plans_never_measure(ragged_pump):
    """Every fresh routing is a new plan key: it takes the unpumped plan
    (the default) or the capacity model's ('auto'), never a measured one,
    and stays exact."""
    reg = PlanRegistry(cache=False) if ragged_pump is None \
        else PlanRegistry(cache=False, ragged_pump=ragged_pump)
    w = _ints((3, 8, 8), 9)
    for sizes in ([4, 3, 5], [1, 11, 0], [6, 0, 6]):
        x = _ints((sum(sizes), 8), sum(sizes))
        got = reg.grouped_gemm(x, w, group_sizes=sizes)
        want = torch.cat([x[o:o + n] @ w[e] for e, (o, n) in enumerate(
            zip(np.cumsum([0] + sizes[:-1]), sizes)) if n])
        assert torch.equal(got, want)
    assert reg.stats.measure_s == 0.0 and reg.stats.fallbacks == 0
    assert len(reg.plans()) == 3
    assert not any(pl["measured"] for pl in reg.plans())


def test_ragged_plan_below_the_hopper_tier_falls_back(monkeypatch):
    """A ragged plan with a region emitted below ``hopper`` (which would
    run that region as plain PyTorch) is refused: the call falls back to
    the direct grouped GEMM, counted, with the same values."""
    reg = PlanRegistry(cache=False)
    real = compiler.compile

    def lowered(*a, **kw):
        kern = real(*a, **kw)
        emission = {r: dict(e, tier="blockloop")
                    for r, e in kern.report.emission.items()}
        return dataclasses.replace(kern, report=dataclasses.replace(
            kern.report, emission=emission))

    monkeypatch.setattr(compiler, "compile", lowered)
    sizes = [4, 0, 7]
    w = _ints((3, 8, 8), 9)
    x = _ints((sum(sizes), 8), 5)
    with pytest.warns(UserWarning, match="below the hopper tier"):
        got = reg.grouped_gemm(x, w, group_sizes=sizes)
    assert reg.stats.fallbacks == 1
    assert reg.stats.phase["prefill"]["fallbacks"] == 1
    assert torch.equal(got, port_ops.grouped_gemm(x, w, group_sizes=sizes,
                                                  bc=16))


def test_failing_plan_falls_back_to_the_direct_op(monkeypatch):
    reg = PlanRegistry(cache=False)

    def boom(*a, **kw):
        raise RuntimeError("forced compile failure")

    monkeypatch.setattr(reg, "kernel", boom)
    x, dt, a, b_, c_ = _ssd_inputs()
    with pytest.warns(UserWarning, match="direct op"):
        y, st_ = reg.ssd_scan(x, dt, a, b_, c_, chunk=8, final_state=True)
    assert reg.stats.fallbacks == 1
    assert reg.stats.phase["prefill"]["fallbacks"] == 1
    y_d, st_d = port_ops.ssd_scan(x, dt, a, b_, c_, chunk=8,
                                  final_state=True)
    assert torch.equal(y, y_d) and torch.equal(st_, st_d)


@pytest.mark.parametrize("spot_check", ["finite", "diff"])
def test_spot_check_rejects_a_poisoned_plan(spot_check, monkeypatch):
    """A sound plan passes the spot check; one whose output is non-finite
    ('finite') or wrong ('diff', against the numpy executor) is not
    installed, and the call falls back to the direct op, counted."""
    reg = PlanRegistry(pump=1, cache=False, spot_check=spot_check)
    q, k, v = (_ints((1, 2, 16, 8), s) for s in range(3))
    reg.flash_attention(q, k, v, causal=True)
    assert reg.stats.fallbacks == 0 and len(reg.plans()) == 1
    real = compiler.compile

    def poisoned(*a, **kw):
        kern = real(*a, **kw)
        good = kern.fn
        bad = float("nan") if spot_check == "finite" else 1.0
        return dataclasses.replace(kern, fn=lambda m: {
            name: t + bad if name == "o" else t
            for name, t in good(m).items()})

    monkeypatch.setattr(compiler, "compile", poisoned)
    q2, k2, v2 = (_ints((1, 2, 32, 8), s) for s in range(3))
    with pytest.warns(UserWarning, match="spot check"):
        got = reg.flash_attention(q2, k2, v2, causal=True)
    assert reg.stats.fallbacks == 1 and len(reg.plans()) == 1
    assert torch.equal(got, port_ops.flash_attention(q2, k2, v2,
                                                     causal=True))


def test_capture_miss_never_measures(monkeypatch):
    """During a CUDA graph capture a cold miss takes the capacity-model
    plan (memoized), which the fast path does not keep; after the capture
    the call measures its plan."""
    reg = PlanRegistry(cache=False)
    q, k, v = (_ints((1, 2, 16, 8), s) for s in range(3))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.warns(UserWarning, match="capture"):
        reg.flash_attention(q, k, v, causal=True)
    reg.flash_attention(q, k, v, causal=True)
    assert reg.stats.measure_s == 0.0 and reg.stats.misses == 1
    assert [pl["pump"] for pl in reg.plans()] == ["auto"]
    monkeypatch.undo()
    reg.flash_attention(q, k, v, causal=True)
    assert reg.stats.measure_s > 0
    assert sorted(pl["pump"] for pl in reg.plans()) == ["auto", "measure"]


# ----------------------------------------------------------------- serving --
def test_kernel_plan_typo_is_rejected():
    cfg = load_arch("qwen3-0.6b", smoke=True)
    assert cfg.kernel_plan == "direct"
    with pytest.raises(ValueError, match="kernel_plan"):
        dataclasses.replace(cfg, kernel_plan="measured")


@pytest.mark.parametrize("arch,field", [("qwen3-0.6b", "attention_impl"),
                                        ("mamba2-1.3b", "ssm_impl")])
def test_warmup_grid_makes_real_calls_pure_hits(arch, field):
    from repro_torch.models import convert, transformer
    cfg = dataclasses.replace(load_arch(arch, smoke=True),
                              **{field: "pallas"}, kernel_plan="measure")
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(2))
    reg = default_registry()
    reqs = transformer.plan_requests(cfg, 2, 16)
    assert reqs
    report = reg.warmup(reqs, device="cpu")
    assert all(r["measured"] and "error" not in r for r in report)
    before = reg.stats.misses
    with torch.no_grad():
        logits, _ = transformer.forward(cfg, model, toks)
        want, _ = transformer.forward(
            dataclasses.replace(cfg, kernel_plan="direct"), model, toks)
    assert reg.stats.misses == before and reg.stats.hits == cfg.n_layers
    torch.testing.assert_close(logits, want, **TOL)


@pytest.mark.parametrize("arch,field", [("qwen3-0.6b", "attention_impl"),
                                        ("mamba2-1.3b", "ssm_impl")])
def test_engine_measure_matches_reference_engine(arch, field):
    """The port's Engine under kernel_plan='measure' against the JAX
    Engine under 'measure' (its default) and the port's 'direct' route:
    identical greedy tokens; after the warmup, no miss and no fallback."""
    jax = pytest.importorskip("jax")
    from repro.configs.base import load_arch as jax_load_arch
    from repro.models import transformer as jax_tf
    from repro.serve.engine import Engine as JaxEngine
    from repro.serve.engine import ServeConfig as JaxServeConfig
    from repro_torch.models import convert
    from repro_torch.serve.engine import Engine, ServeConfig
    jreg = _jax_registry()
    batch, prompt, new = 2, 8, 6
    jcfg = dataclasses.replace(jax_load_arch(arch, smoke=True),
                               **{field: "pallas"})
    assert jcfg.kernel_plan == "measure"
    params = jax_tf.init_params(jcfg, jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (batch, prompt), dtype=np.int32)
    max_len = prompt + new + 1
    old = jreg.set_default_registry(None)
    try:
        want = JaxEngine(jcfg, params, JaxServeConfig(
            batch=batch, max_len=max_len)).generate(
                jax.numpy.asarray(prompts), new)
    finally:
        jreg.set_default_registry(old)

    pcfg = dataclasses.replace(load_arch(arch, smoke=True),
                               **{field: "pallas"})
    model = convert.from_jax_params(pcfg, jax.tree.map(np.asarray, params))
    tokens = torch.from_numpy(prompts).long()
    eng = Engine(pcfg, model, ServeConfig(batch=batch, max_len=max_len,
                                          kernel_plan="measure"),
                 device="cpu")
    st0 = eng.stats()
    assert st0["warmup_s"] > 0 and st0["plans_warmed"] > 0
    assert st0["warmup_failed"] == 0
    assert st0["warmup_measured"] == st0["plans_warmed"]
    misses = st0["registry"]["misses"]
    got = eng.generate(tokens, new)
    st = eng.stats()["registry"]
    assert st["misses"] == misses and st["fallbacks"] == 0
    # a prefill and ``new`` decode steps, one registry call a layer each
    assert st["hits"] == (1 + new) * pcfg.n_layers
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    direct = Engine(pcfg, model, ServeConfig(batch=batch, max_len=max_len),
                    device="cpu")
    assert direct.stats()["registry"] is None
    assert torch.equal(direct.generate(tokens, new), got)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,field", [("qwen3-0.6b", "attention_impl"),
                                        ("mamba2-1.3b", "ssm_impl")])
def test_engine_warmup_covers_bf16_serving(arch, field, cache_dtype):
    """bf16 weights and activations as served on the card, with either
    cache dtype: the warmup's grid holds every plan the steps look up (the
    SSD decode step runs in the promotion of the activations' and the
    conv cache's dtypes; decode attention's plans are capped at the
    cache's built set)."""
    from repro_torch.models import convert
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = dataclasses.replace(load_arch(arch, smoke=True),
                              **{field: "pallas"}, dtype="bfloat16")
    model = convert.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu", torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(1))
    eng = Engine(cfg, model, ServeConfig(batch=2, max_len=17,
                                         cache_dtype=cache_dtype,
                                         kernel_plan="measure"),
                 device="cpu")
    misses = eng.stats()["registry"]["misses"]
    eng.generate(prompts, 4)
    st = eng.stats()["registry"]
    assert st["misses"] == misses and st["fallbacks"] == 0


def test_engine_serves_from_its_own_registry():
    """The engine's layers plan against the registry it captured and
    warmed, even after the process default is swapped: no miss there, and
    the new default is never touched."""
    from repro_torch.models import convert
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = dataclasses.replace(load_arch("qwen3-0.6b", smoke=True),
                              attention_impl="pallas", kernel_plan="measure")
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, model, ServeConfig(batch=2, max_len=20), device="cpu")
    misses = eng.stats()["registry"]["misses"]
    other = PlanRegistry(cache=False)
    set_default_registry(other)
    eng.generate(torch.zeros((2, 8), dtype=torch.long), 3)
    st_ = eng.stats()["registry"]
    assert st_["misses"] == misses and st_["hits"] == 4 * cfg.n_layers
    assert other.stats.hits == other.stats.misses == 0
    assert default_registry() is other


def test_engine_without_warmup_plans_on_first_use():
    """``ServeConfig(warmup=False)``: no grid at construction, so the first
    calls miss and plan; ``Engine.warmup()`` later plans the rest."""
    from repro_torch.models import convert
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = dataclasses.replace(load_arch("qwen3-0.6b", smoke=True),
                              attention_impl="pallas", kernel_plan="measure")
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, model, ServeConfig(batch=2, max_len=40, warmup=False),
                 device="cpu")
    assert eng.warmup_report == [] and eng.stats()["warmup_s"] == 0
    eng.generate(torch.zeros((2, 8), dtype=torch.long), 2)
    reg = eng.stats()["registry"]
    assert reg["prefill"]["misses"] == 1 and reg["decode"]["misses"] == 1
    report = eng.warmup()              # buckets 16, 32, 64 of each kernel
    assert len(report) == 6 and eng.stats()["registry"]["misses"] == 6


def test_serve_cli_measure_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--new", "4",
                      "--ssm-impl", "pallas", "--kernel-plan", "measure"])
    assert tuple(out.shape) == (2, 4)
    text = capsys.readouterr().out
    assert "2 plans, 2 measured" in text and "fallbacks 0" in text
