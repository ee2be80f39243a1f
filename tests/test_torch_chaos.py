"""Chaos suite of the port: fault injection across its compile→serve path,
held to the port's fault-free run and to the JAX package's run under the
same rule (``tests/test_chaos.py``'s matrix and serving rows), on the CPU.

For each injection point — cache IO error, corrupt plan JSON, a lowering
failure, a measurement timeout, a NaN kernel, a mid-request step fault, a
failing plan on the serving path, the scheduler's sites —
``Engine.generate`` (or ``serve_stream``) still completes, the tokens match
the fault-free run (logits within 5e-6), and the expected counter moves.
Each row also runs the JAX engine on the same params under the same
``FaultRule`` (its own ``repro.testing.faults``): identical tokens, logits
within 1e-5, and equal deltas of the counters both packages count at one
site per event (``ROW_COUNTERS``).  ``faults.injected`` and
``compile.measure_failed`` are compared too, except where a rule fires per
autotune candidate or per execution of a compiled graph (``emission.lower``,
``emission.exec``): the port caps a plan's candidates at its kernel's
built set, and the JAX engine runs a jitted graph, so those call counts
differ by design.  Rows run at qwen3-0.6b and mamba2-1.3b SMOKE, each on
private compile caches, with both packages' rules cleared on the way out.

Then the reference's quarantine backoff, plan-store healing and per-request
warmup isolation on the port, and two tests of the port's own: a step
that fails after some layers wrote their K/V rows in place re-runs on the
bottom rung to the fault-free logits (per-slot lanes at ``pos >= T``
included, and a continuation chunk's side cache), and a ``KernelError``
out of a step (a build failure, or a wrapper's refusal of the tensors a
CUDA route gives it) propagates instead of degrading.  The registry never
serves plain PyTorch in place of a kernel: a ragged plan degraded below
``hopper`` falls back to the direct grouped GEMM, and where the direct op
is the kernel (a CUDA tensor, simulated) a plan that failed its spot
check is refused, not served through the kernel the check rejected.  The
reference's checkpoint, trainer, artifact and tuner rows wait for ROADMAP
queue 1 items 7-8.
"""
import dataclasses
import functools
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import compiler, obs  # noqa: E402
from repro_torch.compiler.registry import (PlanRegistry,  # noqa: E402
                                           set_default_registry)
from repro_torch.configs.base import load_arch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve import scheduler as sched  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

BATCH, PROMPT, NEW, MAXLEN = 2, 8, 4, 16
PARITY = 5e-6            # the port's degraded run vs its fault-free run
JAX_TOL = 1e-5           # the port vs the JAX package under the same rule
ARCHS = {"qwen3-0.6b": "attention_impl", "mamba2-1.3b": "ssm_impl"}
# counters both packages move once per event, compared row by row
ROW_COUNTERS = ("cache.corrupt", "degrade.compile", "cache.quarantine",
                "cache.quarantine_skip", "registry.spotcheck_failed",
                "compile.measure", "registry.measure", "registry.replay",
                "engine.degraded", "engine.fallback_build",
                "serve.degraded_request", "sched.slot_free_fault",
                "sched.preempt_fault", "sched.evict_rows_fault")
# rules that fire per autotune candidate or per compiled-graph execution
PER_CALL_SITES = ("emission.lower", "emission.exec")


def _ctr(name: str) -> int:
    return obs.snapshot(include_views=False)["counters"].get(name, 0)


def _counters(o, names):
    snap = o.snapshot(include_views=False)["counters"]
    return {k: snap.get(k, 0) for k in names}


def _names(site):
    extra = () if site in PER_CALL_SITES else ("faults.injected",
                                               "compile.measure_failed")
    return ROW_COUNTERS + extra


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


@pytest.fixture(autouse=True)
def _chaos_env(tmp_path, monkeypatch):
    """Private persistent caches for both packages, default-registry
    isolation, and clean fault tables on the way out."""
    from repro.compiler import registry as jax_reg
    from repro.testing import faults as jax_faults
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax-cache"))
    old, jold = set_default_registry(None), jax_reg.set_default_registry(None)
    yield
    faults.clear()
    jax_faults.clear()
    set_default_registry(old)
    jax_reg.set_default_registry(jold)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The JAX config, its seeded params, and the port's model on them."""
    from repro.configs.base import load_arch as jax_load_arch
    from repro.models import model as jax_model
    field = ARCHS[arch]
    jcfg = dataclasses.replace(jax_load_arch(arch, smoke=True),
                               **{field: "pallas"})
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    pcfg = dataclasses.replace(load_arch(arch, smoke=True),
                               **{field: "pallas"}, kernel_plan="measure")
    model = convert.from_jax_params(pcfg, jax.tree.map(np.asarray, params))
    return jcfg, params, pcfg, model


def _prompts(vocab) -> np.ndarray:
    return np.random.default_rng(1).integers(0, vocab, (BATCH, PROMPT),
                                             dtype=np.int32)


def _fresh_engine(arch="qwen3-0.6b", warmup: bool = True) -> Engine:
    """A fresh process, simulated: cold kernel memo, a fresh registry on
    the (env-selected) persistent cache, a new engine.  The memo matters:
    a kernel compiled before the rules existed bypasses every seam."""
    compiler.clear_memo()
    set_default_registry(PlanRegistry())
    _jcfg, _params_, pcfg, model = _params(arch)
    return Engine(pcfg, model, ServeConfig(batch=BATCH, max_len=MAXLEN,
                                           warmup=warmup), device="cpu")


def _jax_engine(arch, warmup: bool = True):
    from repro import compiler as jax_compiler
    from repro.compiler import registry as jax_reg
    from repro.serve.engine import Engine as JaxEngine
    from repro.serve.engine import ServeConfig as JaxServeConfig
    jax_compiler.clear_memo()
    jax_reg.set_default_registry(jax_reg.PlanRegistry())
    jcfg, params, _pcfg, _model = _params(arch)
    return JaxEngine(jcfg, params, JaxServeConfig(
        batch=BATCH, max_len=MAXLEN, warmup=warmup))


def _serve(eng):
    toks, lgs = eng.generate(torch.from_numpy(
        _prompts(eng.cfg.vocab_size)).long(), NEW, return_logits=True)
    return toks.numpy(), lgs.numpy()


def _seed_cache(mod):
    """The mangle seam needs a file to corrupt: seed one with a throwaway
    instance, so the engine's default cache still reads it under the
    rules."""
    mod.CompileCache(mod._default_path()).put("seed", {"factor": 1})


def _port_run(arch, site, action, kwargs):
    """The port's engine built and served under the rule: (tokens, logits,
    counter deltas, the engine, the rule)."""
    from repro_torch.compiler import cache as cache_mod
    if site == "cache.json":
        _seed_cache(cache_mod)
    names = _names(site)
    before = _counters(obs, names)
    rule = faults.FaultRule(site, action, **kwargs)
    with faults.inject(rule):
        eng = _fresh_engine(arch)
        toks, lgs = _serve(eng)
    return toks, lgs, _delta(_counters(obs, names), before), eng, rule


def _jax_run(arch, site, action, kwargs, tmp_path):
    """The JAX engine on the same params under the same rule (its own
    harness), on a private cache: (tokens, logits, counter deltas)."""
    from repro import obs as jax_obs
    from repro.compiler import cache as jax_cache
    from repro.testing import faults as jax_faults
    os.environ["REPRO_CACHE_DIR"] = str(tmp_path / f"jax-{site}-{action}")
    if site == "cache.json":
        _seed_cache(jax_cache)
    names = _names(site)
    before = _counters(jax_obs, names)
    with jax_faults.inject(jax_faults.FaultRule(site, action, **kwargs)):
        eng = _jax_engine(arch)
        toks, lgs = eng.generate(jax.numpy.asarray(
            _prompts(eng.cfg.vocab_size)), NEW, return_logits=True)
    return (np.asarray(toks), np.asarray(lgs),
            _delta(_counters(jax_obs, names), before))


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """Fault-free runs of the port, per arch: (tokens, logits)."""
    out = {}
    prev = os.environ.get("REPRO_TORCH_CACHE_DIR")
    prev_reg = set_default_registry(None)
    try:
        for arch in ARCHS:
            os.environ["REPRO_TORCH_CACHE_DIR"] = str(
                tmp_path_factory.mktemp(f"baseline-{arch}"))
            out[arch] = _serve(_fresh_engine(arch))
    finally:
        if prev is None:
            os.environ.pop("REPRO_TORCH_CACHE_DIR", None)
        else:
            os.environ["REPRO_TORCH_CACHE_DIR"] = prev
        set_default_registry(prev_reg)
    return out


def _assert_parity(want, toks, lgs, tol=PARITY):
    np.testing.assert_array_equal(toks, want[0])
    err = float(np.max(np.abs(lgs - want[1])))
    assert err <= tol, f"logit parity {err:.2e} > {tol:.0e}"


def _assert_matches_jax(arch, site, action, kwargs, tmp_path, toks, lgs,
                        deltas):
    jtoks, jlgs, jdeltas = _jax_run(arch, site, action, kwargs, tmp_path)
    _assert_parity((jtoks, jlgs), toks, lgs, JAX_TOL)
    assert deltas == jdeltas, "counter deltas differ from the reference's"


# --------------------------------------------------------- the fault matrix --
MATRIX = [
    pytest.param("cache.load", "io_error", {}, "cache.corrupt",
                 id="cache-io-error"),
    pytest.param("cache.json", "truncate", {}, "cache.corrupt",
                 id="cache-json-truncate"),
    pytest.param("cache.json", "garbage", {}, "cache.corrupt",
                 id="cache-json-garbage"),
    pytest.param("emission.lower", "error", {}, "degrade.compile",
                 id="emission-failure"),
    pytest.param("compile.measure", "timeout", {"times": 1},
                 "compile.measure_failed", id="measure-timeout"),
    pytest.param("emission.exec", "nan", {},
                 "registry.spotcheck_failed", id="nan-kernel"),
]


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("site,action,kwargs,counter", MATRIX)
def test_generate_completes_under_fault(baseline, tmp_path, arch, site,
                                        action, kwargs, counter):
    injected = _ctr("faults.injected")
    before = _ctr(counter)
    toks, lgs, deltas, _eng, rule = _port_run(arch, site, action, kwargs)
    _assert_parity(baseline[arch], toks, lgs)
    assert rule.fired >= 1 and _ctr("faults.injected") > injected, \
        "the fault never fired"
    assert _ctr(counter) > before, \
        f"{counter} did not move under a {site}/{action} fault"
    _assert_matches_jax(arch, site, action, kwargs, tmp_path, toks, lgs,
                        deltas)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_nan_kernel_is_quarantined_and_degraded(baseline, arch):
    """The NaN row in detail: the spot check catches the poisoned hopper
    plan (it runs the compiled graph, where ``emission.exec`` wraps it),
    quarantines that rung, and the recompile steps past it (the
    quarantine gate, not a re-paid compile) to the ``torch`` rung, which
    serves the request; degradation happens at plan time, so no step of
    the request is degraded."""
    from repro_torch.compiler import default_cache
    q_before = _ctr("cache.quarantine")
    skip_before = _ctr("cache.quarantine_skip")
    toks, lgs, _d, eng, _rule = _port_run(arch, "emission.exec", "nan", {})
    _assert_parity(baseline[arch], toks, lgs)
    assert _ctr("cache.quarantine") > q_before
    assert _ctr("cache.quarantine_skip") > skip_before
    entries = default_cache().quarantine_entries()
    assert entries and all(k.endswith(":hopper") for k in entries)
    assert all(e["reason"] == "nonfinite" for e in entries.values())
    plans = list(eng._reg._plans.values())
    assert plans and all(k.backend == "torch" for k in plans)
    assert all(any("spot check rejected" in w for w in k.report.warnings)
               for k in plans)
    assert eng.degraded_requests == 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_midrequest_decode_fault_degrades_one_step(baseline, tmp_path, arch):
    """An exception out of one decode step re-runs that step on the bottom
    rung from the caller's cache: the same tokens, one degraded request."""
    before = _ctr("engine.degraded")
    served = _ctr("serve.degraded_request")
    kwargs = {"after": 1, "times": 1}
    toks, lgs, deltas, eng, rule = _port_run(arch, "engine.decode", "error",
                                             kwargs)
    assert rule.fired == 1
    _assert_parity(baseline[arch], toks, lgs)
    assert eng.degraded_requests == 1
    assert eng.stats()["degraded_requests"] == 1
    assert _ctr("engine.degraded") == before + 1
    assert _ctr("serve.degraded_request") == served + 1
    _assert_matches_jax(arch, "engine.decode", "error", kwargs, tmp_path,
                        toks, lgs, deltas)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_registry_exec_fault_falls_back_one_rung(baseline, tmp_path, arch):
    """A plan that starts failing on the serving path (installed under the
    rule) degrades exactly one rung: the registry wrapper's direct-op
    fallback, counted per phase, not the engine's whole-step fallback."""
    before = _ctr("engine.degraded")
    fb = _ctr("registry.fallback.prefill") + _ctr("registry.fallback.decode")
    kwargs = {"times": 1}
    toks, lgs, deltas, eng, _rule = _port_run(arch, "registry.exec", "error",
                                              kwargs)
    _assert_parity(baseline[arch], toks, lgs)
    assert eng._reg.stats.fallbacks >= 1
    assert _ctr("registry.fallback.prefill") \
        + _ctr("registry.fallback.decode") > fb
    assert _ctr("engine.degraded") == before
    assert eng.degraded_requests == 0
    _assert_matches_jax(arch, "registry.exec", "error", kwargs, tmp_path,
                        toks, lgs, deltas)


def test_registry_exec_wraps_only_plans_installed_under_rules():
    """A plan installed before the rule is never wrapped: its calls do not
    reach the ``registry.exec`` seam."""
    eng = _fresh_engine()
    rule = faults.FaultRule("registry.exec", "error")
    with faults.inject(rule):
        toks, _lgs = _serve(eng)
    assert rule.fired == 0 and eng._reg.stats.fallbacks == 0
    assert toks.shape == (BATCH, NEW)


# ---------------------------------------------- continuous-batching chaos --
def _stream_reqs(mod, vocab):
    return mod.synthetic_workload(4, seed=6, prompt_lens=(4, 8),
                                  new_tokens=(3,), arrival_rate=0.6,
                                  vocab=vocab)


STREAM_MATRIX = [
    pytest.param("engine.prefill", {"after": 1, "times": 1},
                 id="stream-prefill-fault"),
    pytest.param("engine.decode", {"after": 2, "times": 1},
                 id="stream-decode-fault"),
    pytest.param("sched.slot_free", {"times": 1},
                 id="stream-slot-free-fault"),
]


def _jax_stream(arch, site, kwargs, reqs_fn, serve_kw):
    """The JAX engine's faulted stream on the same trace: rid -> tokens,
    the degraded rids, and the counter deltas."""
    from repro import obs as jax_obs
    from repro.serve import scheduler as jax_sched
    from repro.testing import faults as jax_faults
    eng = _jax_engine(arch)
    reqs = reqs_fn(jax_sched, eng.cfg.vocab_size)
    eng.serve_stream(reqs, **serve_kw)             # the clean run first
    names = _names(site)
    before = _counters(jax_obs, names)
    with jax_faults.inject(jax_faults.FaultRule(site, "error", **kwargs)):
        res = eng.serve_stream(reqs, **serve_kw)
    return ({r.rid: np.asarray(r.tokens) for r in res},
            {r.rid for r in res if r.degraded},
            _delta(_counters(jax_obs, names), before))


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("site,kwargs", STREAM_MATRIX)
def test_stream_completes_under_fault(arch, site, kwargs):
    """Scheduler-site injections: whatever fails mid-stream (a grouped
    prefill, a batched decode with queued requests, a slot reclaim), every
    request completes with the fault-free tokens, ``degraded_requests``
    counts the affected requests, and the JAX scheduler under the same
    rule gives the same tokens, degraded requests and counter deltas."""
    eng = _fresh_engine(arch)
    reqs = _stream_reqs(sched, eng.cfg.vocab_size)
    clean = {r.rid: r.tokens for r in eng.serve_stream(reqs)}
    before = eng.degraded_requests
    served = _ctr("serve.degraded_request")
    names = _names(site)
    c0 = _counters(obs, names)
    rule = faults.FaultRule(site, "error", **kwargs)
    with faults.inject(rule):
        res = eng.serve_stream(reqs)
    deltas = _delta(_counters(obs, names), c0)
    assert rule.fired >= 1, "the fault never fired"
    assert len(res) == len(reqs), "a request was dropped under fault"
    for r in res:
        np.testing.assert_array_equal(r.tokens, clean[r.rid],
                                      err_msg=f"rid {r.rid} under {site}")
    n_deg = sum(1 for r in res if r.degraded)
    assert n_deg >= 1, "no request was marked degraded"
    assert eng.degraded_requests == before + n_deg
    assert _ctr("serve.degraded_request") > served
    if site == "sched.slot_free":
        assert _ctr("sched.slot_free_fault") >= 1
        assert len(eng.serve_stream(reqs)) == len(reqs)
    jtoks, jdeg, jdeltas = _jax_stream(arch, site, kwargs, _stream_reqs, {})
    for r in res:
        np.testing.assert_array_equal(r.tokens, jtoks[r.rid])
    assert {r.rid for r in res if r.degraded} == jdeg
    assert deltas == jdeltas


# ------------------------------------------------- overload-control chaos --
def _overload_reqs(mod, vocab):
    """Two low-priority long decodes fill both slots, a high-priority
    arrival forces a preemption, and the 8-token prompts exceed the
    4-token chunk budget, so every admission is chunked."""
    rng = np.random.default_rng(3)

    def toks(n):
        return rng.integers(0, vocab, n, dtype=np.int64)
    return [
        mod.Request(0, toks(8), 6, arrival=0, priority=0),
        mod.Request(1, toks(8), 6, arrival=0, priority=0),
        mod.Request(2, toks(4), 3, arrival=2, priority=5),
        mod.Request(3, toks(8), 2, arrival=3, priority=1),
    ]


OVERLOAD = dict(max_slots=2, prefill_chunk_tokens=4,
                preempt_policy="lowest_priority")
OVERLOAD_MATRIX = [
    pytest.param("engine.prefill_chunk", {"after": 1, "times": 1},
                 id="overload-prefill-chunk-fault"),
    pytest.param("sched.preempt", {"times": 1},
                 id="overload-preempt-fault"),
    pytest.param("sched.evict_rows", {"times": 1},
                 id="overload-evict-rows-fault"),
]


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("site,kwargs", OVERLOAD_MATRIX)
def test_overload_stream_completes_under_fault(arch, site, kwargs):
    """A fault in a prefill chunk (re-run on the bottom rung from the side
    cache) or in the preemption / eviction bookkeeping (absorbed; the lane
    is still parked and requeued) never drops a request: the tokens match
    the fault-free overload run and each request's solo run, the affected
    requests count as degraded, no slot leaks, and the JAX scheduler under
    the same rule agrees."""
    eng = _fresh_engine(arch)
    reqs = _overload_reqs(sched, eng.cfg.vocab_size)
    clean = {r.rid: r for r in eng.serve_stream(reqs, **OVERLOAD)}
    assert sum(r.preemptions for r in clean.values()) >= 1, \
        "the overload trace must exercise preemption"
    before = eng.degraded_requests
    names = _names(site)
    c0 = _counters(obs, names)
    rule = faults.FaultRule(site, "error", **kwargs)
    with faults.inject(rule):
        res = eng.serve_stream(reqs, **OVERLOAD)
    deltas = _delta(_counters(obs, names), c0)
    assert rule.fired >= 1, "the fault never fired"
    assert len(res) == len(reqs), "a request was dropped under fault"
    for r in res:
        np.testing.assert_array_equal(r.tokens, clean[r.rid].tokens,
                                      err_msg=f"rid {r.rid} under {site}")
    for req in reqs:
        solo = eng.generate(torch.from_numpy(req.tokens)[None],
                            req.n_new)[0].numpy()
        np.testing.assert_array_equal(clean[req.rid].tokens, solo,
                                      err_msg=f"rid {req.rid} vs solo")
    n_deg = sum(1 for r in res if r.degraded)
    assert n_deg >= 1, "no request was marked degraded"
    assert eng.degraded_requests == before + n_deg
    if site != "engine.prefill_chunk":
        assert _ctr(f"{site}_fault") >= 1
    res2 = eng.serve_stream(reqs, **OVERLOAD)
    assert [r.tokens.tolist() for r in res2] == \
        [clean[r.rid].tokens.tolist() for r in res2]
    jtoks, jdeg, jdeltas = _jax_stream(arch, site, kwargs, _overload_reqs,
                                       OVERLOAD)
    for r in res:
        np.testing.assert_array_equal(r.tokens, jtoks[r.rid])
    assert {r.rid for r in res if r.degraded} == jdeg
    assert deltas == jdeltas


# ------------------------------------------------------ quarantine/backoff --
def test_quarantine_backoff_window_respected(tmp_path):
    from repro_torch.compiler.cache import CompileCache, QuarantinePolicy
    from repro_torch.core.autopump import BUILDERS

    compiler.clear_memo()
    pol = QuarantinePolicy(base_s=10.0, cap_s=40.0, budget=3)
    assert [pol.window_s(n) for n in (1, 2, 3, 9)] == [10.0, 20.0, 40.0, 40.0]

    cache = CompileCache(tmp_path / "c.json", quarantine=pol)
    g, _ = BUILDERS["vecadd"](64, vector_width=8)
    args = dict(factor=2, backend="hopper", cache=cache, memoize=False,
                device="cpu")
    key = compiler.compile(g, **args).report.cache_key
    qkey = f"{key}:hopper"

    cache.record_failure(qkey, "nonfinite")
    skip = _ctr("cache.quarantine_skip")
    with pytest.raises(compiler.PlanQuarantined):
        compiler.compile(g, **args)
    assert _ctr("cache.quarantine_skip") > skip
    # compile_degraded steps past it without re-recording the failure
    degraded = _ctr("degrade.compile")
    kern = compiler.compile_degraded(g, **args)
    assert kern.backend == "torch"
    assert _ctr("degrade.compile") == degraded + 1
    assert cache.quarantine_entries()[qkey]["fails"] == 1
    assert any("degraded compile" in w for w in kern.report.warnings)
    assert CompileCache(tmp_path / "c.json",
                        quarantine=pol).quarantine_entries()[qkey]["fails"] \
        == 1

    # an expired window requalifies the rung but keeps the failure count
    cache.record_failure(qkey, "nonfinite", now=time.time() - 3600.0)
    assert cache.quarantined(qkey) is None
    assert compiler.compile(g, **args).backend == "hopper"
    assert cache.quarantine_entries()[qkey]["fails"] == 2

    cache.record_success(qkey)
    assert qkey not in cache.quarantine_entries()
    assert qkey not in CompileCache(tmp_path / "c.json").quarantine_entries()


def test_compile_degraded_walks_the_port_rungs(tmp_path):
    """hopper → torch → torch without measured autotune, each step down
    counted with its reason and the failing rung quarantined; every rung
    failing raises the last error."""
    from repro_torch.compiler.cache import CompileCache
    from repro_torch.core.autopump import BUILDERS
    assert compiler.DEGRADATION_LADDER == ("hopper", "blockloop", "gather",
                                           "torch", "direct")
    compiler.clear_memo()
    cache = CompileCache(tmp_path / "c.json")
    g, _ = BUILDERS["vecadd"](64, vector_width=8)
    before = _ctr("degrade.compile")
    with faults.inject(faults.FaultRule("emission.lower", "error")):
        kern = compiler.compile_degraded(g, factor=2, backend="hopper",
                                         cache=cache, device="cpu")
    assert kern.backend == "torch" and _ctr("degrade.compile") == before + 1
    assert [k.rsplit(":", 1)[1] for k in cache.quarantine_entries()] \
        == ["hopper"]
    compiler.clear_memo()
    before = _ctr("degrade.compile")
    with faults.inject(faults.FaultRule("compile.measure", "error")):
        kern = compiler.compile_degraded(g, backend="torch",
                                         autotune="measure", cache=False,
                                         device="cpu")
    assert kern.backend == "torch" and not kern.report.autotune
    assert any("without measured autotune" in w for w in kern.report.warnings)
    assert _ctr("degrade.compile") == before + 1


def test_compile_degraded_raises_when_every_rung_fails(monkeypatch):
    from repro_torch.core.autopump import BUILDERS
    compiler.clear_memo()
    g, _ = BUILDERS["vecadd"](64, vector_width=8)

    def boom(*a, **kw):
        raise RuntimeError("every rung fails")

    monkeypatch.setattr(compiler, "_build", boom)
    before = _ctr("degrade.compile")
    with pytest.raises(RuntimeError, match="every rung fails"):
        compiler.compile_degraded(g, backend="hopper", autotune="measure",
                                  cache=False, device="cpu")
    assert _ctr("degrade.compile") == before + 3


# ------------------------------------------------------- self-healing store --
def test_plan_store_heals_after_corruption_post_warmup(tmp_path):
    """Corrupting the store after a warm run costs one cold re-measure in
    the next process, never an error on the serving path, and the next
    save rewrites a valid file."""
    from repro_torch.compiler import cache as cache_mod

    first = _serve(_fresh_engine())
    path = cache_mod._default_path()
    assert path.exists() and json.loads(path.read_text())["entries"]

    path.write_text("{not json!")
    corrupt = _ctr("cache.corrupt")
    cache_mod._DEFAULT_CACHES.clear()
    toks, lgs = _serve(_fresh_engine())
    _assert_parity(first, toks, lgs)
    assert _ctr("cache.corrupt") > corrupt
    healed = json.loads(path.read_text())
    assert healed["version"] == 2 and healed["entries"]


# ------------------------------------------------------------ warmup/engine --
def test_warmup_isolates_per_request_failures(monkeypatch):
    """One unplannable bucket yields a failure record with the error
    string, not an aborted grid, and the engine still serves afterwards."""
    eng = _fresh_engine(warmup=False)
    failed = _ctr("registry.warmup_failed")

    def boom(*a, **kw):
        raise RuntimeError("injected warmup failure")

    with monkeypatch.context() as m:
        m.setattr(compiler, "compile_degraded", boom)
        report = eng.warmup()
    assert report and all("error" in r for r in report)
    assert all("injected warmup failure" in r["error"] for r in report)
    assert eng.stats()["warmup_failed"] == len(report)
    assert _ctr("registry.warmup_failed") > failed
    out = eng.generate(torch.from_numpy(_prompts(eng.cfg.vocab_size))
                       .long(), 2)
    assert out.shape == (BATCH, 2)


# ------------------------------------------------- the port's own rows ------
def _raise_once(fn, at: int, exc):
    """``fn``, raising ``exc`` on its ``at``-th call (1-based) only."""
    n = [0]

    def wrapped(*a, **kw):
        n[0] += 1
        if n[0] == at:
            raise exc
        return fn(*a, **kw)
    return wrapped


def _clone(cache):
    return {seg: [{k: v.clone() if isinstance(v, torch.Tensor) else v
                   for k, v in layer.items()} for layer in layers]
            for seg, layers in cache.items()}


def _same_cache(a, b):
    for la, lb in zip(sched._layers(a), sched._layers(b)):
        for key in la:
            if not torch.equal(torch.as_tensor(la[key]),
                               torch.as_tensor(lb[key])):
                return False
    return True


@pytest.mark.parametrize("phase", ["decode", "prefill_chunk"])
def test_rerun_after_partial_in_place_writes_is_exact(phase, monkeypatch):
    """A step that fails after some layers wrote their K/V rows in place
    re-runs on the bottom rung from the caller's cache to the fault-free
    logits: bit for bit the bottom rung's clean step from an untouched
    copy (logits and cache), and within 5e-6 of the planned route's.
    ``decode``: a per-slot cache with one lane mid-sequence and one at
    ``pos >= T`` (its row is kept, not written); ``prefill_chunk``: an
    int-pos side cache already holding a prefix."""
    from repro_torch.models import attention
    from repro_torch.models import model as model_mod
    _jcfg, _p, pcfg, model = _params("qwen3-0.6b")
    cfg = dataclasses.replace(pcfg, kernel_plan="direct")
    eng = Engine(cfg, model, ServeConfig(batch=BATCH, max_len=MAXLEN),
                 device="cpu")
    prompts = torch.from_numpy(_prompts(cfg.vocab_size)).long()
    if phase == "decode":
        small, _last = eng.prefill(prompts)
        cache = model_mod.init_cache(cfg, BATCH, MAXLEN, eng.cache_dtype,
                                     eng.device, per_slot_pos=True)
        sched.insert_rows(cache, small, [0, 1], BATCH)
        for layer in sched._layers(cache):
            layer["pos"][1] = MAXLEN + 2            # a lane past the end
        tokens = prompts[:, :1]
        step = eng.decode_token
        target, name, at = attention.ops, "decode_attention", 2
    else:
        cache, _last = eng.prefill(prompts[:1, :4])
        tokens = prompts[:1, 4:]
        step = eng.prefill_chunk
        target, name, at = attention, "chunked_attention", 2
    planned = step(_clone(cache), tokens)
    clean_cfg = eng._fallback(phase == "prefill_chunk")
    with torch.no_grad():
        want, want_cache = model_mod.decode_step(
            clean_cfg, model, {"tokens": tokens}, _clone(cache),
            last_only=phase == "prefill_chunk")
    degraded = _ctr("engine.degraded")
    monkeypatch.setattr(target, name, _raise_once(
        getattr(target, name), at, RuntimeError("mid-step failure")))
    work = _clone(cache)
    if phase == "decode":
        got, got_cache = step(work, tokens)
    else:
        got_cache, got = step(work, tokens)
        want = want[:, -1]
        planned = planned[1]
    assert _ctr("engine.degraded") == degraded + 1
    assert torch.equal(got, want) and _same_cache(got_cache, want_cache)
    if phase == "decode":
        planned = planned[0]
    err = (got.float() - planned.float()).abs().max().item()
    assert err <= PARITY
    if phase == "decode":
        # the lane past the end kept its rows: the re-run wrote none
        for lw, lc in zip(sched._layers(got_cache), sched._layers(cache)):
            assert torch.equal(lw["k"][1], lc["k"][1])


def test_kernel_build_error_propagates_and_is_not_degraded(monkeypatch):
    """A ``KernelBuildError`` out of a step is the machine's setup, not a
    step fault: it propagates out of ``generate`` and no step degrades."""
    from repro_torch.kernels._build import KernelBuildError
    from repro_torch.models import attention
    _jcfg, _p, pcfg, model = _params("qwen3-0.6b")
    cfg = dataclasses.replace(pcfg, kernel_plan="direct")
    eng = Engine(cfg, model, ServeConfig(batch=BATCH, max_len=MAXLEN),
                 device="cpu")
    monkeypatch.setattr(attention.ops, "decode_attention", _raise_once(
        attention.ops.decode_attention, 1, KernelBuildError("nvcc failed")))
    degraded = _ctr("engine.degraded")
    with pytest.raises(KernelBuildError, match="nvcc failed"):
        _serve(eng)
    assert _ctr("engine.degraded") == degraded
    assert eng.degraded_requests == 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_kernel_refusal_on_a_cuda_route_propagates(arch, monkeypatch):
    """A kernel wrapper's refusal (``InputError``: here the CUDA wrapper
    given the tensors of a route marked CUDA) is a ``KernelError``: it
    propagates out of ``generate`` and no step degrades to plain PyTorch
    in place of the kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import InputError, KernelError
    _jcfg, _p, pcfg, model = _params(arch)
    cfg = dataclasses.replace(pcfg, kernel_plan="direct")
    eng = Engine(cfg, model, ServeConfig(batch=BATCH, max_len=MAXLEN),
                 device="cpu")
    monkeypatch.setattr(ops, "_route", lambda x, name: True)
    degraded = _ctr("engine.degraded")
    with pytest.raises(InputError, match="not a CUDA tensor") as info:
        _serve(eng)
    assert isinstance(info.value, KernelError)
    assert isinstance(info.value, ValueError)    # as the wrappers raised
    assert _ctr("engine.degraded") == degraded
    assert eng.degraded_requests == 0


def _ints(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -3, 4, shape).astype(np.float32))


@pytest.mark.parametrize("site,action", [("emission.lower", "error"),
                                         ("emission.exec", "nan")])
def test_ragged_plan_degraded_below_hopper_falls_back(site, action):
    """A fault that drives a ragged grouped-GEMM plan off the ``hopper``
    backend (a lowering failure, or a NaN kernel quarantined by the spot
    check) ends in the registry's fallback to the direct grouped GEMM,
    counted, and never in a run of the ``torch`` rung's graph."""
    from repro_torch.kernels import ops
    compiler.clear_memo()
    reg = PlanRegistry()
    sizes = [4, 0, 7]
    w, x = _ints((3, 8, 8), 9), _ints((sum(sizes), 8), 5)
    fb = _ctr("registry.fallback.prefill")
    rule = faults.FaultRule(site, action)
    with faults.inject(rule), pytest.warns(UserWarning,
                                           match="backend=torch"):
        got = reg.grouped_gemm(x, w, group_sizes=sizes)
    assert rule.fired >= 1
    assert reg.stats.fallbacks == 1
    assert _ctr("registry.fallback.prefill") == fb + 1
    assert all(k.backend == "torch" for k in reg._plans.values())
    assert torch.equal(got, ops.grouped_gemm(x, w, group_sizes=sizes,
                                             bc=16))


def test_plan_failing_its_spot_check_is_refused_on_the_card(baseline,
                                                            monkeypatch):
    """Where the direct op is the hand-written kernel (a CUDA tensor,
    simulated), a plan that failed its spot check is not served: its
    recompile is a ``torch``-rung plan, whose spot check ran no kernel, so
    it is refused once for the process and every call falls back to the
    direct op, counted; a second request compiles nothing again."""
    from repro_torch.compiler import registry
    monkeypatch.setattr(registry, "_runs_kernel", lambda dev: True)
    spot = _ctr("registry.spotcheck_failed")
    fb = _ctr("registry.fallback.prefill") + _ctr("registry.fallback.decode")
    with faults.inject(faults.FaultRule("emission.exec", "nan")):
        eng = _fresh_engine()
        toks, lgs = _serve(eng)
        _assert_parity(baseline["qwen3-0.6b"], toks, lgs)
        reg = eng._reg
        assert _ctr("registry.spotcheck_failed") > spot
        assert not reg._plans and reg._refused
        assert all("backend=torch" in why for why in reg._refused.values())
        assert all("error" in r for r in eng.warmup_report)
        assert reg.stats.fallbacks > 0
        assert _ctr("registry.fallback.prefill") \
            + _ctr("registry.fallback.decode") > fb
        again = {k: _ctr(k) for k in ("registry.spotcheck_failed",
                                      "degrade.compile", "compile.build")}
        toks2, _lgs2 = _serve(eng)
    np.testing.assert_array_equal(toks2, toks)
    assert {k: _ctr(k) for k in again} == again
    assert eng.degraded_requests == 0
