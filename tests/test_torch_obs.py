"""The port's observability spine (``repro_torch.obs``) against the
reference's contract (``tests/test_obs.py``), on the CPU.

The reference's tests on the port's ``obs``, ``StepTimer``, compile
cache, engine and scheduler: spans nest (under exceptions and across
threads too), the Chrome-trace export parses, snapshots are pure
JSON, the cache's health counters fire (``cache.stale_env`` where the
reference counts ``cache.stale_jax_version``), ``StepTimer``'s
percentiles come from ``obs.Histogram``, and one ``Engine.generate`` /
one stream yields the spans, histograms, gauges and views the reference's
do.  Beyond them: ``obs.profile`` with a ``logdir`` writes a
``torch.profiler`` capture; the port's ``Engine.generate`` trace equals
the JAX engine's on the same params (the same ``serve.*`` spans, nesting
and counts, equal ``serve.tokens``, ``engine.degraded`` and histogram
sample counts), on the direct and the plan-registry route; and a warm
registry hit makes no ``obs`` call.

The port's own layer: a span is a user annotation in a recording
``torch.profiler``'s trace, tracing on or off; ``Histogram.between`` reads
samples by their stamps; one traced stream yields the scheduler's and the
engine's step phases in the profiler's trace, one ``sched.host_s`` a step,
first-token parts within their whole, the padded prefill rows, request
spans keyed by rid and ``queue_s <= ttft_s``; and the benchmark's five
readers of these samples read a number inside a window and None from an
empty registry.
"""
import dataclasses
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs.base import load_arch  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402


@pytest.fixture()
def tracer():
    """Fresh enabled tracer installed as the process tracer."""
    tr = Tracer(enabled=True)
    old = obs.set_tracer(tr)
    yield tr
    obs.set_tracer(old)


@pytest.fixture()
def metrics():
    """Fresh metrics registry installed as the process default."""
    reg = MetricsRegistry()
    old = obs.set_default_metrics(reg)
    yield reg
    obs.set_default_metrics(old)


@pytest.fixture()
def private_cache(tmp_path, monkeypatch):
    """A private compile cache, a cold memo and a fresh default registry
    (process-wide state)."""
    from repro_torch import compiler
    from repro_torch.compiler.registry import (PlanRegistry,
                                               set_default_registry)
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    compiler.clear_memo()
    old = set_default_registry(PlanRegistry())
    yield
    set_default_registry(old)


# --------------------------------------------------------------- tracing ----
def test_spans_nest_with_parent_and_depth(tracer):
    with obs.span("outer", cat="t", a=1):
        with obs.span("inner"):
            time.sleep(0.001)

    by_name = {r["name"]: r for r in tracer.spans()}
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer["depth"] == 0 and outer["parent"] is None
    assert inner["depth"] == 1 and inner["parent"] == "outer"
    assert outer["args"] == {"a": 1}
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert inner["dur"] >= 1000.0  # slept 1ms; ts/dur are microseconds


def test_spans_record_and_unwind_on_exception(tracer):
    with pytest.raises(ValueError):
        with obs.span("outer"):
            with obs.span("boom"):
                raise ValueError("x")

    boom = tracer.spans("boom")[0]
    outer = tracer.spans("outer")[0]
    assert boom["args"]["error"] == "ValueError"
    assert outer["args"]["error"] == "ValueError"
    assert boom["parent"] == "outer" and boom["depth"] == 1
    with obs.span("after"):
        pass
    after = tracer.spans("after")[0]
    assert after["depth"] == 0 and after["parent"] is None


def test_mid_span_attrs_and_instants(tracer):
    with obs.span("work") as sp:
        sp.set(factor=4)
        obs.instant("tick", n=1)
    rec = tracer.spans("work")[0]
    assert rec["args"]["factor"] == 4
    events = [r for r in tracer.records if r["type"] == "event"]
    assert events and events[0]["name"] == "tick"


def test_disabled_tracer_is_noop_and_shared(tracer):
    tracer.enabled = False
    handle = obs.span("never")
    with handle as sp:
        sp.set(anything=1)  # must not raise on the null handle
    assert obs.span("never2") is handle  # one shared null object
    obs.instant("never3")
    assert tracer.records == []


def test_spans_carry_distinct_tids_across_threads(tracer):
    def work():
        with obs.span("child_thread"):
            pass

    t = threading.Thread(target=work)
    with obs.span("main_thread"):
        t.start()
        t.join()
    tids = {r["name"]: r["tid"] for r in tracer.spans()}
    assert tids["main_thread"] != tids["child_thread"]
    child = tracer.spans("child_thread")[0]
    assert child["depth"] == 0 and child["parent"] is None


def test_chrome_trace_export_is_valid(tracer, tmp_path):
    with obs.span("outer", cat="serve", k="v"):
        with obs.span("inner"):
            pass
    obs.instant("hit", kind="cache")

    path = tmp_path / "trace.json"
    obs.write_trace(path, metadata={"run": "test"})
    trace = json.loads(path.read_text())

    assert trace["displayTimeUnit"] == "ms"
    assert trace["otherData"] == {"run": "test"}
    events = trace["traceEvents"]
    assert len(events) == 3
    for e in events:
        assert {"name", "cat", "ph", "ts", "pid", "tid", "args"} <= set(e)
        assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] == "X":
            assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
        else:
            assert e["ph"] == "i" and e["s"] == "t"
    assert {e["ph"] for e in events} == {"X", "i"}


# --------------------------------------------------------------- metrics ----
def test_metrics_snapshot_roundtrips(metrics):
    obs.count("c.hits", 3)
    obs.gauge("g.frac", 0.5)
    for v in (1.0, 2.0, 3.0):
        obs.observe("h.lat_s", v)

    snap = obs.snapshot()
    assert snap["counters"]["c.hits"] == 3
    assert snap["gauges"]["g.frac"] == 0.5
    h = snap["histograms"]["h.lat_s"]
    assert h["count"] == 3 and h["min"] == 1.0 and h["max"] == 3.0
    assert h["p50"] == 2.0
    assert json.loads(json.dumps(snap)) == snap

    metrics.reset()
    assert obs.snapshot()["counters"] == {}


def test_histogram_percentiles_and_compaction():
    h = obs.Histogram(max_samples=64)
    for v in range(1, 101):
        h.record(float(v))
    assert h.count == 100 and h.total == sum(range(1, 101))
    assert h.min == 1.0 and h.max == 100.0
    assert len(h.values) <= 64
    p50, p99 = h.percentile(50), h.percentile(99)
    assert 1.0 <= p50 <= p99 <= 100.0
    assert 30.0 <= p50 <= 70.0


def test_views_absorb_existing_stat_objects(metrics):
    obs.register_view("good", lambda: {"hits": 1})
    obs.register_view("bad", lambda: 1 / 0)
    snap = obs.snapshot()
    assert snap["views"]["good"] == {"hits": 1}
    assert "error" in snap["views"]["bad"]
    assert json.loads(json.dumps(snap)) == snap


def test_count_emits_instant_when_tracing(tracer, metrics):
    obs.count("cache.hit", key="k")
    assert metrics.counter("cache.hit").value == 1
    events = [r for r in tracer.records if r["type"] == "event"]
    assert events[0]["name"] == "cache.hit"
    assert events[0]["args"] == {"key": "k"}


def test_formatters(metrics):
    obs.count("cache.hit", 2)
    obs.observe("serve.decode_step_s", 0.001)
    text = obs.format_snapshot(obs.snapshot())
    assert "cache.hit" in text and "serve.decode_step_s" in text
    assert "p99" in text


# ----------------------------------------------------- cache health events --
def test_cache_corrupt_counter(metrics, tmp_path):
    from repro_torch.compiler.cache import CompileCache

    path = tmp_path / "cache.json"
    path.write_text("{ this is not json")
    cache = CompileCache(path)
    assert cache.get("k") is None  # degrade contract unchanged
    assert metrics.counter("cache.corrupt").value == 1


def test_cache_stale_env_counter(metrics, tmp_path):
    """The reference's ``cache.stale_jax_version``: the port's entries are
    stamped with ``_env_fingerprint()`` (the card and the toolchain), and
    an entry stamped under another counts once per load."""
    from repro_torch.compiler.cache import CompileCache, _env_fingerprint

    path = tmp_path / "cache.json"
    cache = CompileCache(path)
    cache.put("fresh", {"factor": 2})
    entries = json.loads(path.read_text())
    entries["entries"]["old"] = {"factor": 4, "env": "torch-0.0.0|older"}
    path.write_text(json.dumps(entries))

    reread = CompileCache(path)
    assert reread.get("fresh")["factor"] == 2
    assert reread.get("fresh")["env"] == _env_fingerprint()
    assert metrics.counter("cache.stale_env").value == 1
    assert metrics.counter("cache.corrupt").value == 0
    assert metrics.counter("cache.hit").value == 2
    assert reread.stats["hits"] == 2 and reread.stats["entries"] == 2


# ---------------------------------------------------------------- timers ----
def test_steptimer_warm_cold_split_and_percentiles():
    from repro_torch.launch.steps import StepTimer

    timer = StepTimer(torch.device("cpu"))
    for _ in range(6):
        timer.run("decode", lambda: time.sleep(0.001))
    st = timer.stats()["decode"]

    assert st["steps"] == 5 and st["cold_s"] > 0
    assert st["steady_mean_s"] is not None
    assert st["cold"]["calls"] == 1
    assert st["cold"]["total_s"] == st["cold_s"]
    assert st["warm"]["calls"] == 5
    assert st["warm"]["p50_s"] <= st["warm"]["p99_s"]
    assert st["steady_p50_s"] == st["warm"]["p50_s"]
    assert st["steady_p99_s"] == st["warm"]["p99_s"]
    assert timer.steady["decode"]  # a view over the histogram samples
    assert isinstance(timer._warm["decode"], obs.Histogram)


# --------------------------------------------------------------- profile ----
def test_profile_without_logdir_is_a_plain_span(tracer):
    with obs.profile("window", tag="x"):
        pass
    rec = tracer.spans("window")[0]
    assert rec["cat"] == "profile"
    assert rec["args"]["profiled"] is False and rec["args"]["tag"] == "x"


def test_profile_with_logdir_writes_a_torch_profiler_capture(tracer,
                                                            tmp_path):
    with obs.profile("window", logdir=str(tmp_path / "prof")):
        torch.ones(8) + 1
    rec = tracer.spans("window")[0]
    assert rec["args"]["profiled"] is True
    capture = json.loads((tmp_path / "prof"
                          / "window.pt.trace.json").read_text())
    assert capture["traceEvents"]


# ------------------------------------------------- end-to-end serve trace ----
def test_engine_generate_produces_nested_trace(tracer, metrics,
                                               private_cache):
    """One Engine.generate() yields warmup / prefill / per-token decode
    spans with monotonic timestamps, TTFT on the generate span, and latency
    histograms in the metrics snapshot."""
    from repro_torch.models import convert
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = dataclasses.replace(load_arch("qwen3-0.6b", smoke=True),
                              attention_impl="pallas",
                              kernel_plan="measure")
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, model, ServeConfig(batch=2, max_len=16),
                 device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 4),
                            generator=torch.Generator().manual_seed(1))
    eng.generate(prompts, 3)

    assert tracer.spans("serve.warmup")
    gen = tracer.spans("serve.generate")[0]
    assert tracer.spans("serve.prefill")
    decodes = sorted(tracer.spans("serve.decode"), key=lambda r: r["ts"])
    assert len(decodes) == 3
    for d in decodes:
        assert d["parent"] == "serve.generate" and d["depth"] == 1
        assert gen["ts"] <= d["ts"]
        assert d["ts"] + d["dur"] <= gen["ts"] + gen["dur"]
    assert all(a["ts"] + a["dur"] <= b["ts"]
               for a, b in zip(decodes, decodes[1:]))
    assert gen["args"]["ttft_s"] > 0
    assert tracer.spans("registry.compile") and tracer.spans(
        "compiler.compile")

    snap = obs.snapshot()
    assert snap["counters"]["serve.tokens"] == 6
    assert snap["histograms"]["serve.ttft_s"]["count"] == 1
    assert snap["histograms"]["serve.decode_step_s"]["count"] == 3
    assert snap["views"]["serve.engine"]["phases"]["decode"]["steps"] >= 1
    assert snap["views"]["serve.engine"]["registry"]["hits"] > 0
    assert snap["counters"]["registry.measure"] == 2
    assert snap["counters"]["emission.tier.hopper"] > 0


def test_engine_view_keeps_no_engine_alive(metrics):
    """The ``serve.engine`` view holds its engine weakly: once the caller
    drops the engine it is freed (its weights with it) and the view reads
    None, which the snapshot leaves out."""
    import gc
    import weakref

    from repro_torch.models import convert
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = load_arch("qwen3-0.6b", smoke=True)
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, model, ServeConfig(batch=2, max_len=16),
                 device="cpu")
    assert obs.snapshot()["views"]["serve.engine"]["degraded_requests"] == 0
    dead = weakref.ref(eng)
    del eng, model
    gc.collect()
    assert dead() is None
    assert "serve.engine" not in obs.snapshot()["views"]


def test_scheduler_metrics_on_two_rate_trace(metrics):
    """The same synthetic workload streamed at a bursty and a trickle
    arrival rate: the slot-occupancy gauge never exceeds max_slots and
    drains to 0, the queue-wait histogram records every request, and the
    bursty trace queues at least as hard as the trickle."""
    from repro_torch.models import convert
    from repro_torch.serve import scheduler as sched
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = dataclasses.replace(load_arch("qwen3-0.6b", smoke=True),
                              attention_impl="xla_chunked",
                              kernel_plan="direct")
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, model, ServeConfig(batch=2, max_len=16, warmup=False),
                 device="cpu")

    def run(rate):
        reqs = sched.synthetic_workload(8, seed=4, prompt_lens=(2, 4),
                                        new_tokens=(2, 4), arrival_rate=rate,
                                        vocab=cfg.vocab_size)
        occs = []
        before = metrics.histogram("sched.queue_wait_steps").count
        res = eng.serve_stream(
            reqs, step_hook=lambda s: occs.append(s["occupancy"]))
        h = metrics.histogram("sched.queue_wait_steps")
        waits = [r.queue_wait_steps for r in res]
        return occs, waits, h.count - before

    occ_burst, waits_burst, n_burst = run(1.0)
    occ_slow, waits_slow, n_slow = run(0.2)

    for occs in (occ_burst, occ_slow):
        assert all(0 <= o <= 2 for o in occs), "occupancy exceeded max_slots"
    assert max(occ_burst) == 2, "the burst never filled the slots"
    snap = obs.snapshot(include_views=False)
    assert snap["gauges"]["sched.slot_occupancy"] == 0
    assert snap["gauges"]["sched.queue_depth"] == 0
    assert n_burst == 8 and n_slow == 8
    assert np.mean(waits_burst) >= np.mean(waits_slow)
    assert max(waits_burst) >= max(waits_slow)
    assert max(waits_burst) > 0, "the burst never exercised the queue"
    assert metrics.histogram("serve.request_ttft_s").count == 16
    assert metrics.histogram("serve.request_tpot_s").count == 16
    assert metrics.histogram("sched.ttft_steps").count == 16


# --------------------------------------------- parity with the reference ----
def _serve_spans(tr):
    """(name, parent, depth) of every ``serve.*`` span, in start order."""
    recs = sorted((r for r in tr.spans() if r["name"].startswith("serve.")),
                  key=lambda r: r["ts"])
    return [(r["name"], r["parent"], r["depth"]) for r in recs]


def _counts(snap):
    return ({k: snap["counters"].get(k, 0)
             for k in ("serve.tokens", "engine.degraded")},
            {k: snap["histograms"][k]["count"]
             for k in ("serve.ttft_s", "serve.decode_step_s")})


@pytest.mark.parametrize("route", [
    dict(attention_impl="xla_chunked", kernel_plan="direct"),
    dict(attention_impl="pallas", kernel_plan="measure")],
    ids=["direct", "measure"])
def test_engine_trace_matches_reference_engine(route, tmp_path, monkeypatch):
    """The port's Engine.generate and the JAX engine's on the same params
    (``convert.from_jax_params``): the same ``serve.*`` spans with the same
    nesting and count, equal ``serve.tokens`` and ``engine.degraded``, and
    equal histogram sample counts, on the direct and the registry route."""
    jax = pytest.importorskip("jax")
    from repro import obs as jax_obs
    from repro.compiler import registry as jax_reg
    from repro.configs.base import load_arch as jax_load_arch
    from repro.models import model as jax_model
    from repro.serve.engine import Engine as JaxEngine
    from repro.serve.engine import ServeConfig as JaxServeConfig
    from repro_torch import compiler
    from repro_torch.compiler import registry as port_reg
    from repro_torch.models import convert
    from repro_torch.serve.engine import Engine, ServeConfig

    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax-cache"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    batch, prompt, new = 2, 6, 4
    jcfg = dataclasses.replace(jax_load_arch("qwen3-0.6b", smoke=True),
                               **route)
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (batch, prompt), dtype=np.int32)

    jtr, jm = jax_obs.Tracer(enabled=True), jax_obs.MetricsRegistry()
    old_tr, old_m = jax_obs.set_tracer(jtr), jax_obs.set_default_metrics(jm)
    old_reg = jax_reg.set_default_registry(jax_reg.PlanRegistry())
    try:
        want = JaxEngine(jcfg, params, JaxServeConfig(
            batch=batch, max_len=16)).generate(jax.numpy.asarray(prompts),
                                               new)
        jsnap = jax_obs.snapshot()
    finally:
        jax_obs.set_tracer(old_tr)
        jax_obs.set_default_metrics(old_m)
        jax_reg.set_default_registry(old_reg)

    pcfg = dataclasses.replace(load_arch("qwen3-0.6b", smoke=True), **route)
    model = convert.from_jax_params(pcfg, jax.tree.map(np.asarray, params))
    ptr, pm = Tracer(enabled=True), MetricsRegistry()
    old_tr, old_m = obs.set_tracer(ptr), obs.set_default_metrics(pm)
    compiler.clear_memo()
    old_reg = port_reg.set_default_registry(port_reg.PlanRegistry())
    try:
        got = Engine(pcfg, model, ServeConfig(batch=batch, max_len=16),
                     device="cpu").generate(torch.from_numpy(prompts).long(),
                                            new)
        psnap = obs.snapshot()
    finally:
        obs.set_tracer(old_tr)
        obs.set_default_metrics(old_m)
        port_reg.set_default_registry(old_reg)

    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    spans = _serve_spans(ptr)
    assert spans == _serve_spans(jtr)
    assert [n for n, _p, _d in spans].count("serve.decode") == new
    assert ("serve.warmup" in dict.fromkeys(n for n, _p, _d in spans)) == \
        (route["kernel_plan"] == "measure")
    assert _counts(psnap) == _counts(jsnap)
    assert psnap["counters"]["serve.tokens"] == batch * new


def test_registry_warm_hit_makes_no_obs_call(monkeypatch, private_cache):
    """A warm registry call is one dict lookup: no ``obs`` call at all
    (hits count in ``RegistryStats``, which the ``plan_registry`` view
    publishes)."""
    from repro_torch.compiler.registry import default_registry
    reg = default_registry()
    q, k, v = (torch.randn(1, 2, 16, 8, generator=torch.Generator()
                           .manual_seed(s)) for s in range(3))
    reg.flash_attention(q, k, v, causal=True)        # cold: compiles
    calls = []
    for name in ("count", "observe", "gauge", "span", "instant"):
        real = getattr(obs, name)
        monkeypatch.setattr(obs, name, lambda *a, _n=name, _r=real, **kw:
                            calls.append(_n) or _r(*a, **kw))
    hits = reg.stats.hits
    for _ in range(3):
        reg.flash_attention(q, k, v, causal=True)
    assert reg.stats.hits == hits + 3
    assert calls == []


# ------------------------------------------- the profiler and the stream ----
def _annotations(prof, tmp_path):
    """The user annotations of a finished ``torch.profiler`` capture:
    name -> list of (start, end) in the trace's microseconds."""
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            out.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


@pytest.mark.parametrize("tracing", [False, True], ids=["off", "on"])
def test_span_is_a_profiler_range(tracing, tmp_path):
    """Under a recording CPU ``torch.profiler`` a span opens a
    ``record_function`` range of its name, tracing on or off; with no
    profiler and tracing off it is the shared no-op handle."""
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer(enabled=tracing)
    old = obs.set_tracer(tr)
    try:
        if not tracing:
            assert obs.span("before") is obs.span("before2")  # the null
        with obs.span("before"):
            pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("outer", cat="t"):
                with obs.span("inner"):
                    torch.ones(4) + 1
        after = obs.span("after")
    finally:
        obs.set_tracer(old)
    ann = _annotations(prof, tmp_path)
    assert "outer" in ann and "inner" in ann and "before" not in ann
    (o0, o1), (i0, i1) = ann["outer"][0], ann["inner"][0]
    assert o0 <= i0 and i1 <= o1
    assert [r["name"] for r in tr.spans()] == (
        ["before", "inner", "outer"] if tracing else [])
    if not tracing:
        assert after is obs.span("after2")  # the profiler is gone


def test_histogram_between_keeps_stamps_through_compaction():
    h = obs.Histogram(max_samples=16)
    for v in range(1, 51):
        h.record(float(v))
    mid = time.perf_counter()
    for v in range(51, 101):
        h.record(float(v))
    kept = h.values
    assert len(kept) <= 16 and h.count == 100
    early = h.between(float("-inf"), mid)
    late = h.between(mid, time.perf_counter())
    assert early + late == kept
    assert early and all(v <= 50 for v in early)
    assert late and all(v > 50 for v in late)
    assert h.between(time.perf_counter(), float("inf")) == []


@pytest.fixture(scope="module")
def traced_stream(tmp_path_factory):
    """One qwen3 SMOKE stream at engine batch 2 over 3 slots, traced and
    under a recording CPU ``torch.profiler``, on a private tracer and
    registry."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import convert
    from repro_torch.serve import scheduler as sched
    from repro_torch.serve.engine import Engine, ServeConfig

    tr, reg = Tracer(enabled=True), MetricsRegistry()
    old_tr, old_m = obs.set_tracer(tr), obs.set_default_metrics(reg)
    try:
        cfg = dataclasses.replace(load_arch("qwen3-0.6b", smoke=True),
                                  attention_impl="xla_chunked",
                                  kernel_plan="direct")
        model = convert.init_params(cfg, torch.Generator().manual_seed(0))
        eng = Engine(cfg, model, ServeConfig(batch=2, max_len=16,
                                             warmup=False), device="cpu")
        reqs = sched.synthetic_workload(
            8, seed=5, prompt_lens=(3, 5), new_tokens=(1, 3),
            arrival_rate=0.6, vocab=cfg.vocab_size)
        snaps = []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            done = eng.serve_stream(reqs, max_slots=3,
                                    step_hook=snaps.append)
        ann = _annotations(prof, tmp_path_factory.mktemp("stream"))
    finally:
        obs.set_tracer(old_tr)
        obs.set_default_metrics(old_m)
    return SimpleNamespace(tr=tr, reg=reg, reqs=reqs, done=done,
                           snaps=snaps, ann=ann)


def test_stream_phases_in_the_profiler_trace(traced_stream):
    """The scheduler's step phases, the engine's steps and their waits sit
    in the profiler's trace as user annotations, each engine step inside
    the scheduler phase that made it."""
    ann = traced_stream.ann
    for name in ("sched.step", "sched.admit", "sched.insert_rows",
                 "sched.decode", "sched.readback", "engine.sync_wait",
                 "serve.prefill", "serve.decode", "serve.stream"):
        assert name in ann, name
    assert len(ann["sched.step"]) == len(traced_stream.snaps)

    def inside(child, parent):
        return all(any(a <= c0 and c1 <= b for a, b in ann[parent])
                   for c0, c1 in ann[child])

    assert inside("serve.decode", "sched.decode")
    assert inside("serve.prefill", "sched.admit")
    assert inside("sched.admit", "sched.step")
    assert inside("engine.sync_wait", "sched.step")


def test_stream_host_time_and_first_token_parts(traced_stream):
    """One ``sched.host_s`` a step; every first token's behind and prefill
    parts within its whole; the engine's enqueue within each synced step;
    ``sched.prefill_rows_padded`` the rows ``_admit`` padded to batch 2."""
    reg, snaps, reqs = traced_stream.reg, traced_stream.snaps, \
        traced_stream.reqs
    host = reg.histogram("sched.host_s").values
    assert len(host) == len(snaps) and min(host) >= 0.0
    first = reg.histogram("sched.first_token_s").values
    behind = reg.histogram("sched.first_token_behind_s").values
    own = reg.histogram("sched.first_token_prefill_s").values
    assert len(first) == len(behind) == len(own) == len(reqs)
    for f, b, p in zip(first, behind, own):
        assert 0.0 <= b <= f and 0.0 < p <= f and b + p <= f
    for phase, wall in (("decode", "serve.decode_step_s"),
                        ("prefill", "engine.prefill_s")):
        enq = reg.histogram(f"engine.{phase}_enqueue_s").values
        walls = reg.histogram(wall).values
        assert len(enq) == len(walls) > 0
        assert all(0.0 < e <= w for e, w in zip(enq, walls))
    plen = {r.rid: r.prompt_len for r in reqs}
    padded = 0
    for snap in snaps:
        groups = {}
        for rid in snap["admitted"]:
            groups[plen[rid]] = groups.get(plen[rid], 0) + 1
        padded += sum(max(2, g) - g for g in groups.values())
    assert padded > 0, "no admission group was padded"
    assert reg.counter("sched.prefill_rows_padded").value == padded
    assert reg.counter("sched.prefill_rows").value == len(reqs)


def test_stream_request_spans_and_ttft_from_submit(traced_stream):
    """A ``sched.request`` span a request, carrying its rid (an async
    event of that id in the Chrome trace); ``queue_s <= ttft_s``, and
    ``serve.request_ttft_s`` holds the requests' ``ttft_s``."""
    tr, done = traced_stream.tr, traced_stream.done
    spans = tr.spans("sched.request")
    assert sorted(s["args"]["rid"] for s in spans) == [r.rid for r in done]
    for s in spans:
        a = s["args"]
        assert 0.0 <= a["queue_s"] <= a["behind_s"]
        assert a["held_s"] >= 0.0 and a["decode_s"] >= 0.0
        assert a["behind_s"] + a["prefill_s"] + a["held_s"] \
            <= s["dur"] / 1e6 + 1e-9
    events = tr.chrome_trace()["traceEvents"]
    ids = sorted(e["id"] for e in events if e["ph"] == "b")
    assert ids == [r.rid for r in done]
    assert all(0.0 <= r.queue_s <= r.ttft_s for r in done)
    assert sorted(traced_stream.reg.histogram(
        "serve.request_ttft_s").values) == sorted(r.ttft_s for r in done)
    admits = tr.spans("sched.admit")
    assert sorted(rid for s in admits for rid in s["args"]["rids"]) == \
        [r.rid for r in done]


# ------------------------------------------------ the benchmark's readers ----
READERS = {
    "decode_host_pct": ({"engine.decode_enqueue_s": [0.01, 0.03],
                         "serve.decode_step_s": [0.04, 0.04]}, 50.0),
    "prefill_host_pct": ({"engine.prefill_enqueue_s": [0.02],
                          "engine.prefill_s": [0.08]}, 25.0),
    "sched_host_ms": ({"sched.host_s": [0.001, 0.003]}, 2.0),
    "ttft_wait_pct": ({"sched.first_token_s": [0.4, 0.6],
                       "sched.first_token_prefill_s": [0.1, 0.15]}, 75.0),
    "setup_plans_s": ({"kernels.build_s": [1.5],
                       "engine.warmup_s": [2.0]}, 3.5),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_benchmark_reader(name, metrics, monkeypatch):
    """Each of the benchmark's readers of these samples, loaded as the
    harness loads it: None from an empty registry, and from its samples
    the number, samples outside its stretch left out (before the window
    for ``setup_plans_s``, inside it for the rest)."""
    from pathlib import Path
    from types import SimpleNamespace
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    from portbench.harness.trace import load_module
    mod = load_module("metrics", name)
    samples, want = READERS[name]
    assert mod.read(SimpleNamespace(t0=0.0, t1=float("inf"))) is None

    def record(noise=None):
        for hist, values in samples.items():
            for v in values:
                obs.observe(hist, 7.0 if noise else v)

    before_window = name == "setup_plans_s"
    record(noise=not before_window)
    t0 = time.perf_counter()
    record(noise=before_window)
    t1 = time.perf_counter()
    record(noise=True)
    assert mod.read(SimpleNamespace(t0=t0, t1=t1)) == pytest.approx(want)
