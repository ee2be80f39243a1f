"""The engine's decode step replayed as one CUDA graph
(``repro_torch.serve.decode_graph``).

On the CPU: the rule that decides when a decode step may replay, the
engine's count of its eager steps with their reasons, and a refused
capture leaving its key eager with the eager answers.  On the card
(marked ``cuda``): a stream with admissions, chunked prefill and a
preemption gives the eager step's tokens and logits bit for bit, with the
same kernel launch counts; a new scheduler captures anew and its old
cache is freed; a fault or a failing replay still degrades the step.
"""
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs.base import load_arch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.serve import decode_graph  # noqa: E402
from repro_torch.serve import scheduler as sched_mod  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

CUDA = torch.device("cuda")


@pytest.fixture
def metrics():
    """A private metrics registry for the test."""
    reg = obs.MetricsRegistry()
    old = obs.set_default_metrics(reg)
    try:
        yield reg
    finally:
        obs.set_default_metrics(old)


def _cache(arch: str, per_slot: bool = True, **cfg_kw):
    """A small cache of ``arch``'s SMOKE config on the meta device;
    ``cfg_kw`` replaces config fields, ``moe`` MoE fields."""
    cfg = load_arch(arch, smoke=True)
    if "moe" in cfg_kw:
        cfg_kw["moe"] = dataclasses.replace(cfg.moe, **cfg_kw["moe"])
    cfg = dataclasses.replace(cfg, **cfg_kw)
    return cfg, model_mod.init_cache(cfg, 2, 16, torch.float32,
                                     torch.device("meta"),
                                     per_slot_pos=per_slot)


# the ragged routes: on the registry's (group sizes on the host) and direct
RAGGED = dict(ragged_dropless=True, inference_capacity_factor=0.0)


# ------------------------------------------------------------- the rule ---
@pytest.mark.parametrize("arch,per_slot,kw,want", [
    ("qwen3-0.6b", True, {}, None),
    ("qwen3-0.6b", True, dict(device=torch.device("cpu")), "device"),
    ("qwen3-0.6b", False, {}, "int_pos"),
    ("qwen3-0.6b", True, dict(mesh=object()), "mesh"),
    ("qwen3-0.6b", True, dict(nan_guard=True), "nan_guard"),
    ("qwen3-0.6b", True, dict(rules=True), "faults"),
    ("mamba2-1.3b", True, {}, "state"),
    ("zamba2-2.7b", True, {}, "state"),
    ("deepseek-v2-lite-16b", True,
     dict(cfg=dict(moe=RAGGED, kernel_plan="measure")), "moe"),
    ("deepseek-v2-lite-16b", True, dict(cfg=dict(moe=RAGGED)), None),
    ("deepseek-v2-lite-16b", True, {}, None),
], ids=["dense", "cpu", "int_pos", "mesh", "nan_guard", "faults", "ssm",
        "hybrid", "moe", "moe_ragged_direct", "moe_capacity"])
def test_engage_rule(arch, per_slot, kw, want):
    """Only a per-slot cache that the step writes in place on a CUDA
    device, unguarded, off any mesh and off the ragged MoE registry route
    (whose group sizes come to the host) may replay; every other step is
    eager with its reason."""
    kw = dict(kw)
    cfg, cache = _cache(arch, per_slot, **kw.pop("cfg", {}))
    rules = kw.pop("rules", False)
    kw.setdefault("device", CUDA)
    with faults.inject(*([faults.FaultRule("engine.decode", "error")]
                         if rules else [])):
        assert decode_graph.eager_reason(cfg, cache, **kw) == want


def _engine(device, nan_guard=False, max_len=48, arch="qwen3-0.6b"):
    cfg = dataclasses.replace(load_arch(arch, smoke=True),
                              attention_impl="pallas", kernel_plan="direct")
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    return Engine(cfg, model, ServeConfig(batch=4, max_len=max_len,
                                          nan_guard=nan_guard),
                  device=device)


def _workload(n=12, seed=7):
    return sched_mod.synthetic_workload(
        n, seed=seed, prompt_lens=(2, 5, 9, 14), new_tokens=(3, 5, 8),
        arrival_rate=2.0, priorities=(0, 1), vocab=256)


STREAM = dict(max_slots=4, prefill_chunk_tokens=4,
              preempt_policy="lowest_priority", step_time_ms=1.0)


def _counters(reg):
    return reg.snapshot(include_views=False)["counters"]


def test_cpu_steps_are_eager_and_counted(metrics):
    """Off the card every decode step is eager: each counted with its
    reason, each sampled 0; a degraded step counts as ``degraded``."""
    eng = _engine("cpu")
    eng.serve_stream(_workload(), **STREAM)
    with faults.inject(faults.FaultRule("engine.decode", "error", times=1)):
        eng.generate(torch.zeros((2, 4), dtype=torch.long), 3)
    ctr = _counters(metrics)
    steps = metrics.histogram("serve.decode_step_s").count
    assert steps > 3
    assert ctr["engine.decode_graph_eager"] == steps
    assert ctr["engine.decode_graph_eager.degraded"] == 1
    assert ctr["engine.decode_graph_eager.device"] == steps - 1
    assert "engine.decode_graph_capture" not in ctr
    assert metrics.histogram("engine.decode_graph").values == [0.0] * steps
    assert eng._decode.replays == 0


def test_failed_capture_stays_eager(metrics, monkeypatch):
    """A key whose capture raises runs eagerly for good, and every step
    still gives the eager answer: the first step of the key runs eagerly,
    the second tries the capture, then runs eagerly, as do all after."""
    want = _engine("cpu").serve_stream(_workload(), collect_logits=True,
                                       **STREAM)

    class Refused:
        def __init__(self):
            raise RuntimeError("no graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Refused)
    eng = _engine("cpu")
    # the rule as on the card; the capture is refused before it begins
    eng._decode = decode_graph.DecodeGraph(CUDA)
    metrics.reset()
    got = eng.serve_stream(_workload(), collect_logits=True, **STREAM)
    ctr = _counters(metrics)
    steps = eng.stats()["phases"]["decode"]["steps"] + 1   # warm + cold
    assert ctr["engine.decode_graph_eager"] == steps
    assert ctr["engine.decode_graph_capture_failed"] == 1
    assert ctr["engine.decode_graph_eager.first_step"] == 1
    assert ctr["engine.decode_graph_eager.capture_failed"] == steps - 1
    assert eng._decode.replays == 0
    assert [c.rid for c in got] == [c.rid for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_array_equal(g.logits, w.logits)


# ------------------------------------------------------------- the card ---
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "-m cuda tests/test_torch_decode_graph.py)")
    return CUDA


def _serve(eng, reqs, mods=None, **kw):
    """A stream's completions and the kernels' launch deltas."""
    from repro_torch.kernels import decode_attention, flash_attention
    mods = mods or (decode_attention, flash_attention)
    before = [m.launches for m in mods]
    done = eng.serve_stream(reqs, collect_logits=True, **kw)
    torch.cuda.synchronize()
    return done, {m.__name__: m.launches - n for m, n in zip(mods, before)}


@pytest.fixture(scope="module")
def streams(card):
    """The stream served with graph replays and eagerly (``nan_guard``),
    each engine's counters kept."""
    out = {}
    for name, guard in (("graph", False), ("eager", True)):
        reg = obs.MetricsRegistry()
        old = obs.set_default_metrics(reg)
        try:
            eng = _engine(card, nan_guard=guard)
            done, launched = _serve(eng, _workload(), **STREAM)
        finally:
            obs.set_default_metrics(old)
        out[name] = dict(done=done, launched=launched,
                         counters=_counters(reg), replays=eng._decode.replays)
        del eng
        gc.collect()
    return out


@pytest.mark.cuda
def test_stream_replays_give_eager_tokens_and_logits(streams):
    g, e = streams["graph"], streams["eager"]
    assert g["counters"]["engine.decode_graph_capture"] == 1
    assert g["counters"]["engine.decode_graph_eager"] == \
        g["counters"]["engine.decode_graph_eager.first_step"] == 1
    assert g["replays"] > 5 and e["replays"] == 0
    assert e["counters"]["engine.decode_graph_eager.nan_guard"] > 5
    assert sum(c.preemptions for c in g["done"]) >= 1
    assert g["counters"]["sched.prefill_chunk"] >= 1
    assert [c.rid for c in g["done"]] == [c.rid for c in e["done"]]
    for cg, ce in zip(g["done"], e["done"]):
        np.testing.assert_array_equal(cg.tokens, ce.tokens)
        np.testing.assert_array_equal(cg.logits, ce.logits)
        assert cg.preemptions == ce.preemptions


@pytest.mark.cuda
def test_replays_count_the_eager_launches(streams):
    g, e = streams["graph"], streams["eager"]
    assert g["launched"] == e["launched"]
    assert g["launched"]["repro_torch.kernels.decode_attention"] > 0


def _run(sched, steps):
    for _ in range(steps):
        sched.run_step()


def _until_replayed(sched, bound=20):
    """Steps until the engine has replayed its graph once since now."""
    dg = sched.engine._decode
    replays = dg.replays
    for _ in range(bound):
        sched.run_step()
        if dg.replays > replays:
            return
    raise AssertionError(f"no replay in {bound} steps")


@pytest.mark.cuda
def test_new_scheduler_recaptures_and_frees_the_old_cache(card, metrics):
    eng = _engine(card, max_len=4096)
    first = sched_mod.Scheduler(eng, max_slots=4)
    first.submit(_workload(8))
    _until_replayed(first)
    assert _counters(metrics)["engine.decode_graph_capture"] == 1
    cache_bytes = sum(leaf.numel() * leaf.element_size()
                      for layer in decode_graph._layers(first.cache)
                      for leaf in layer.values())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(card)
    del first
    gc.collect()
    assert held - torch.cuda.memory_allocated(card) >= cache_bytes
    second = sched_mod.Scheduler(eng, max_slots=4)
    second.submit(_workload(8, seed=8))
    _until_replayed(second)
    ctr = _counters(metrics)
    assert ctr["engine.decode_graph_capture"] == 2
    assert ctr["engine.decode_graph_eager.first_step"] == 2


@pytest.mark.cuda
def test_fault_and_failing_replay_degrade_the_step(card, streams, metrics,
                                                   monkeypatch):
    """An ``engine.decode`` fault, and a replay that raises, each re-run
    the step on the bottom rung from the caller's cache; replays go on
    after, and every request completes with the eager stream's tokens."""
    eng = _engine(card)
    sched = sched_mod.Scheduler(eng, collect_logits=True, **{
        k: v for k, v in STREAM.items() if k != "step_time_ms"})
    sched.submit(_workload())
    _until_replayed(sched)
    with faults.inject(faults.FaultRule("engine.decode", "error", times=1)):
        _run(sched, 1)
    real = torch.cuda.CUDAGraph.replay
    calls = []

    def fail_once(self):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("replay failed")
        return real(self)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", fail_once)
    replays = eng._decode.replays
    _run(sched, 1)
    assert eng._decode.replays == replays
    while sched.pending or sched.queue or sched.active:
        sched.run_step()
    assert eng._decode.replays > replays
    ctr = _counters(metrics)
    assert ctr["engine.degraded"] == 2
    assert ctr["engine.decode_graph_eager.degraded"] == 2
    done = [sched.completed[r] for r in sorted(sched.completed)]
    want = streams["eager"]["done"]
    assert [c.rid for c in done] == [c.rid for c in want]
    for got, ref in zip(done, want):
        np.testing.assert_array_equal(got.tokens, ref.tokens)
        np.testing.assert_allclose(got.logits, ref.logits, rtol=0,
                                   atol=1e-5)


def _published_deepseek(device, nan_guard=False):
    """deepseek-v2-lite SMOKE as published (gates unnormalised, YaRN with
    its ramp inside the rope dims) on the direct ragged route."""
    from repro_torch.configs.base import RopeScaling
    cfg = load_arch("deepseek-v2-lite-16b", smoke=True)
    cfg = dataclasses.replace(
        cfg, attention_impl="pallas", kernel_plan="direct",
        moe=dataclasses.replace(cfg.moe, norm_topk_prob=False, **RAGGED),
        rope_scaling=RopeScaling(factor=40.0, mscale=0.707,
                                 mscale_all_dim=0.707))
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    return Engine(cfg, model, ServeConfig(batch=4, max_len=48,
                                          nan_guard=nan_guard),
                  device=device)


@pytest.mark.cuda
def test_moe_stream_replays_give_eager_tokens_and_logits(card):
    """The direct ragged MoE route replays: a deepseek SMOKE stream gives
    the eager stream's tokens and logits bit for bit, with the same
    grouped GEMM launches and the same expert tally."""
    from repro_torch.kernels import grouped_gemm
    out = {}
    for name, guard in (("graph", False), ("eager", True)):
        reg = obs.MetricsRegistry()
        old = obs.set_default_metrics(reg)
        try:
            eng = _published_deepseek(card, nan_guard=guard)
            # a recording profiler folds the tally into samples every step
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                done, launched = _serve(eng, _workload(),
                                        mods=(grouped_gemm,), **STREAM)
        finally:
            obs.set_default_metrics(old)
        tally = {h: reg.histogram(f"moe.{h}").values
                 for h in ("decode_calls", "decode_rows",
                           "decode_experts_hit", "prefill_experts_hit")}
        out[name] = dict(done=done, launched=launched, tally=tally,
                         counters=_counters(reg), replays=eng._decode.replays)
        del eng
        gc.collect()
    g, e = out["graph"], out["eager"]
    assert g["counters"]["engine.decode_graph_capture"] == 1
    assert g["replays"] > 5 and e["replays"] == 0
    assert g["launched"] == e["launched"]
    assert g["launched"]["repro_torch.kernels.grouped_gemm"] > 0
    assert g["tally"] == e["tally"]
    assert len(g["tally"]["decode_experts_hit"]) > g["replays"]
    assert [c.rid for c in g["done"]] == [c.rid for c in e["done"]]
    for cg, ce in zip(g["done"], e["done"]):
        np.testing.assert_array_equal(cg.tokens, ce.tokens)
        np.testing.assert_array_equal(cg.logits, ce.logits)
