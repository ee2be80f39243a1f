"""The port's offline tuner (``repro_torch.tune``) on the CPU: the
reference's ``tests/test_tune.py`` ported, and the port's own rules.

The reference's 17 tests, on the port's tuner, ledger, artifact and
engine:

* grid enumeration: deterministic, deduped groups; shards partitioning
  the grid; two decode positions in one bucket keyed as one measurement;
* the lease ledger with explicit clocks: claim, heartbeat, complete,
  expiry reclaim rejecting the dead owner's late writes, release, a
  corrupt ledger degrading to empty; and a real two-process SIGKILL whose
  shard the survivor reclaims;
* the artifact: a complete fleet pass and a replica that preloads it and
  warms up with zero measurements, the step-time seed from its timings,
  partial-result salvage and a replica that measures only the gap,
  ``verify_entry``'s four reasons, one tampered entry costing one
  measurement, a stale toolchain rejecting every entry; ``prune``'s GC and
  a read-only store.

The port's own: the grid of qwen3 and mamba2 SMOKE has the JAX package's
groups, member specs and dedupe counts (the keys differ by the toolchain
fingerprint, so structure is compared, not hashes);
``measure_request_key`` is the key the registry compiles each request of
those grids under, at every cache dtype; a replica of either model from a
complete artifact measures nothing and serves the locally warmed engine's
tokens; an entry timed on another kind of device is ``stale``; and two
workers in one process never hold the card lock at once.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import compiler, obs  # noqa: E402
from repro_torch.compiler.cache import CompileCache  # noqa: E402
from repro_torch.compiler.registry import (PlanRegistry,  # noqa: E402
                                           set_default_registry)
from repro_torch.configs.base import load_arch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.testing import faults  # noqa: E402
from repro_torch.tune import artifact as artifact_mod  # noqa: E402
from repro_torch.tune import grid as grid_mod  # noqa: E402
from repro_torch.tune.lease import LeaseLedger  # noqa: E402
from repro_torch.tune.worker import TunerWorker, run_fleet  # noqa: E402

ARCH = "qwen3-0.6b"
ARCHS = {"qwen3-0.6b": "attention_impl", "mamba2-1.3b": "ssm_impl"}
BATCH, MAXLEN = 2, 16


def _ctr(name: str) -> int:
    return obs.snapshot(include_views=False)["counters"].get(name, 0)


def _cfg(arch=ARCH):
    return dataclasses.replace(load_arch(arch, smoke=True),
                               **{ARCHS[arch]: "pallas"})


def _model(arch=ARCH):
    return convert.init_params(_cfg(arch), torch.Generator().manual_seed(0))


def _fleet(tmp_path, arch=ARCH, **kw):
    kw.setdefault("out_path", tmp_path / "plans.artifact.json")
    kw.setdefault("n_shards", 1)
    return run_fleet(_cfg(arch), BATCH, MAXLEN,
                     ledger_path=tmp_path / "ledger.json",
                     store_path=tmp_path / "tuner_cache.json",
                     device="cpu", **kw)


def _replica(artifact_path, cache_dir, monkeypatch, arch=ARCH) -> Engine:
    """A fresh replica, simulated: a cold kernel memo, its own empty
    persistent cache, a fresh default registry, and the artifact preloaded
    at warmup."""
    compiler.clear_memo()
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(cache_dir))
    set_default_registry(PlanRegistry())
    return Engine(_cfg(arch), _model(arch),
                  ServeConfig(batch=BATCH, max_len=MAXLEN,
                              kernel_plan="measure",
                              plan_artifact=str(artifact_path)),
                  device="cpu")


def _prompts(vocab):
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, vocab, (BATCH, 8))).long()


@pytest.fixture(autouse=True)
def _tune_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax-cache"))
    compiler.clear_memo()
    old = set_default_registry(None)
    yield
    faults.clear()
    set_default_registry(old)


# ------------------------------------------------------------------- grid --
def test_grid_is_deterministic_and_deduped():
    cfg = _cfg()
    a = grid_mod.enumerate_work(cfg, BATCH, MAXLEN)
    b = grid_mod.enumerate_work(cfg, BATCH, MAXLEN)
    assert [g.key for g in a] == [g.key for g in b]
    assert a, "smoke grid enumerated no work"
    for g in a:
        # every member of a group shares the representative's key
        assert all(item.key == g.key for item in g.items)
        assert g.representative is g.items[0]
    # groups are distinct measurements
    assert len({g.key for g in a}) == len(a)


def test_grid_shards_partition_everything():
    groups = grid_mod.enumerate_work(_cfg(), BATCH, MAXLEN)
    shards = grid_mod.shard_groups(groups, 3)
    flat = [g.key for lst in shards.values() for g in lst]
    assert sorted(flat) == sorted(g.key for g in groups)
    keys = grid_mod.shard_keys(shards)
    assert set(keys) == set(shards)
    assert all(keys[s] == [g.key for g in shards[s]] for s in shards)


def test_grid_dedupes_equal_decode_buckets():
    """Two decode positions in the same bucket key one measurement."""
    from repro_torch.compiler import measure_request_key
    from repro_torch.compiler.registry import _max_factor
    from repro_torch.core.autopump import BUILDERS
    reg = PlanRegistry()
    keys = []
    for t in (9, 12):      # both bucket to the same padded decode shape
        args, kwargs, _ = reg.decode_request(b=BATCH, h=2, hkv=1, t=t,
                                             d=16, dtype="float32")
        g, est = BUILDERS["decode_attention"](*args, **kwargs)
        keys.append(measure_request_key(
            g, est, max_factor=_max_factor("decode_attention", args,
                                           kwargs)))
    assert keys[0] == keys[1]


def _structure(groups):
    """A grid's groups as (kernel, member specs) in order: what the two
    packages share (their keys differ by the toolchain fingerprint, and
    the port's decode specs carry the cache dtype)."""
    return [(g.representative.kernel,
             [sorted((k, v) for k, v in it.spec if k != "kv_dtype")
              for it in g.items]) for g in groups]


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("batch,max_len", [(BATCH, MAXLEN), (8, 577)])
def test_grid_matches_reference_groups(arch, batch, max_len):
    """The port's grid has the JAX package's groups, member specs and
    dedupe counts for the same config and serving shape."""
    pytest.importorskip("jax")
    from repro.configs.base import load_arch as jax_load_arch
    from repro.tune import grid as jax_grid
    jcfg = dataclasses.replace(jax_load_arch(arch, smoke=True),
                               **{ARCHS[arch]: "pallas"})
    jax_before = _ctr("tune.grid_groups")
    want = jax_grid.enumerate_work(jcfg, batch, max_len)
    got = grid_mod.enumerate_work(_cfg(arch), batch, max_len)
    assert _structure(got) == _structure(want)
    assert [len(g.items) for g in got] == [len(g.items) for g in want]
    assert _ctr("tune.grid_groups") - jax_before == len(got)
    # every decode descriptor carries the engine's cache dtype
    for g in got:
        for it in g.items:
            assert (dict(it.spec).get("kv_dtype") == "float32") == \
                (it.kernel == "decode_attention")


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_measure_request_key_is_the_registry_compile_key(arch, cache_dtype):
    """Every request of the grid, warmed through the serving registry the
    way ``Engine.warmup`` warms it, compiles under exactly the key the
    tuner enumerated (so a replica hits every artifact entry)."""
    from repro_torch.models import transformer
    # the engine's normalization: its prefill starts on a fresh cache
    cfg = dataclasses.replace(_cfg(arch), fresh_prefill_kernel=True)
    dtype = getattr(torch, cache_dtype)
    groups = grid_mod.enumerate_work(cfg, BATCH, MAXLEN,
                                     cache_dtype=cache_dtype)
    reg = PlanRegistry(cache=False)
    reqs = transformer.plan_requests(cfg, BATCH, MAXLEN, cached=True,
                                     cache_dtype=dtype)
    report = reg.warmup(reqs, device="cpu")
    assert report and not any("error" in r for r in report)
    plans = {(k[0], k[1], k[2], k[5]): kern.report.cache_key
             for k, kern in reg._plans.items()}
    items = [it for g in groups for it in g.items]
    assert len(items) == len(reqs)
    for it in items:
        got = plans[(it.kernel, it.args, it.kwargs, it.max_factor)]
        assert got == it.key, it


# ------------------------------------------------------------------ lease --
def test_lease_claim_heartbeat_complete(tmp_path):
    led = LeaseLedger(tmp_path / "ledger.json", ttl_s=10.0)
    led.init_shards({"shard-0": ["k0"], "shard-1": ["k1"]})
    assert led.states() == {"pending": 2}

    got = led.claim("a", now=100.0)
    assert got == ("shard-0", ["k0"])
    assert led.claim("b", now=100.0) == ("shard-1", ["k1"])
    # nothing claimable while both leases are live
    assert led.claim("c", now=101.0) is None

    assert led.heartbeat("a", "shard-0", now=105.0) is True
    assert led.complete("a", "shard-0", now=106.0) is True
    assert led.complete("b", "shard-1", now=106.0) is True
    assert led.all_done()
    assert led.done_keys() == ["k0", "k1"]
    # init after completion is a no-op: finished work is never reopened
    led.init_shards({"shard-0": ["k0"], "shard-1": ["k1"]})
    assert led.states() == {"done": 2}


def test_lease_expiry_reclaim_blocks_double_publish(tmp_path):
    """Worker a dies mid-lease, worker b reclaims after expiry, and a's
    late heartbeat and completion are rejected: the reclaimed shard can
    only be published once."""
    led = LeaseLedger(tmp_path / "ledger.json", ttl_s=10.0)
    led.init_shards({"shard-0": ["k0"]})
    assert led.claim("a", now=100.0) == ("shard-0", ["k0"])

    # before expiry the lease holds; at expiry it is claimable
    assert led.claim("b", now=105.0) is None
    reclaimed = _ctr("tune.lease_reclaimed")
    assert led.claim("b", now=110.5) == ("shard-0", ["k0"])
    assert _ctr("tune.lease_reclaimed") > reclaimed

    # the dead worker wakes up late: every mutation is rejected
    lost = _ctr("tune.lease_lost")
    assert led.heartbeat("a", "shard-0", now=111.0) is False
    assert led.complete("a", "shard-0", now=111.0) is False
    assert _ctr("tune.lease_lost") >= lost + 2
    # the new owner still completes normally
    assert led.complete("b", "shard-0", now=112.0) is True
    assert led.snapshot()["shard-0"]["attempts"] == 2


def test_lease_release_returns_shard_to_pool(tmp_path):
    led = LeaseLedger(tmp_path / "ledger.json", ttl_s=10.0)
    led.init_shards({"shard-0": ["k0"]})
    assert led.claim("a", now=100.0) is not None
    led.release("a", "shard-0")
    assert led.states() == {"pending": 1}
    assert led.claim("b", now=101.0) == ("shard-0", ["k0"])
    # release by a non-owner is a no-op
    led.release("a", "shard-0")
    assert led.snapshot()["shard-0"]["owner"] == "b"


def test_lease_corrupt_ledger_degrades_to_empty(tmp_path):
    path = tmp_path / "ledger.json"
    led = LeaseLedger(path, ttl_s=10.0)
    led.init_shards({"shard-0": ["k0"]})
    path.write_text("{not json!")
    before = _ctr("tune.ledger_corrupt")
    assert led.snapshot() == {}
    assert _ctr("tune.ledger_corrupt") > before
    # init_shards rebuilds it: nothing measured lives here, so no loss
    led.init_shards({"shard-0": ["k0"]})
    assert led.states() == {"pending": 1}


# -------------------------------------------------------- tune-smoke round --
def test_tune_smoke_artifact_replica_zero_measurements(tmp_path, monkeypatch):
    """One fleet pass measures the deduped grid and publishes a complete
    verified artifact; a fresh replica preloading it warms up with zero
    autotune measurements and still serves."""
    cfg = _cfg()
    art = tmp_path / "plans.artifact.json"
    out = _fleet(tmp_path, n_shards=2, worker_id="tuner-a")
    assert out["artifact"]["complete"] is True
    assert out["artifact"]["entries"] == out["groups"] >= 1
    assert set(out["ledger"]) == {"done"}
    assert out["worker"]["measured"] == out["groups"]
    assert not out["worker"]["failed"]

    measured_before = _ctr("registry.measure")
    eng = _replica(art, tmp_path / "replica-cache", monkeypatch)
    stats = eng.stats()
    assert stats["artifact"]["verified"] == stats["artifact"]["total"] >= 1
    assert stats["artifact"]["rejected"] == 0
    # the acceptance bar: the artifact-loaded replica measures nothing
    assert stats["warmup_measured"] == 0
    assert stats["warmup_failed"] == 0
    assert _ctr("registry.measure") == measured_before

    # and it serves; the step-time estimate comes from the artifact's
    # measured timings
    toks = eng.generate(_prompts(cfg.vocab_size), 3)
    assert tuple(toks.shape) == (BATCH, 3)
    seed_ms = eng.measured_step_time_ms()
    assert seed_ms is not None and seed_ms > 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_replica_from_artifact_serves_the_local_warmup_tokens(
        tmp_path, monkeypatch, arch):
    """For qwen3 and mamba2: a replica from a complete artifact makes no
    measurement, and serves the tokens and logits of an engine that
    measured its grid locally."""
    cfg = _cfg(arch)
    out = _fleet(tmp_path, arch, n_shards=2)
    assert out["artifact"]["complete"] is True
    measured = _ctr("registry.measure")
    eng = _replica(tmp_path / "plans.artifact.json",
                   tmp_path / "replica-cache", monkeypatch, arch)
    assert eng.stats()["warmup_measured"] == 0
    assert _ctr("registry.measure") == measured
    assert eng.stats()["plans_warmed"] == out["work_items"]
    toks, lgs = eng.generate(_prompts(cfg.vocab_size), 4,
                             return_logits=True)

    compiler.clear_memo()
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "local"))
    set_default_registry(PlanRegistry())
    local = Engine(cfg, _model(arch),
                   ServeConfig(batch=BATCH, max_len=MAXLEN,
                               kernel_plan="measure"), device="cpu")
    assert local.stats()["warmup_measured"] == out["groups"]
    want, wlgs = local.generate(_prompts(cfg.vocab_size), 4,
                                return_logits=True)
    assert torch.equal(toks, want)
    torch.testing.assert_close(lgs, wlgs, rtol=0, atol=5e-6)


def test_step_time_seeds_from_measured_timings(tmp_path, monkeypatch):
    """serve_stream with step_time_ms=None seeds the scheduler clock from
    the measured plan timings, not the 1.0 ms constant."""
    from repro_torch.serve import scheduler as sched_mod
    cfg = _cfg()
    _fleet(tmp_path)
    eng = _replica(tmp_path / "plans.artifact.json",
                   tmp_path / "replica-cache", monkeypatch)
    # before any served step the estimate already exists: the floor from
    # the artifact's measured winner timings
    assert (eng.measured_step_time_ms() or 0) > 0
    reqs = sched_mod.synthetic_workload(2, seed=0, prompt_lens=(4,),
                                        new_tokens=(2,),
                                        arrival_rate=1.0,
                                        vocab=cfg.vocab_size)
    before = _ctr("sched.step_time_seeded")
    res = eng.serve_stream(reqs)
    assert len(res) == 2
    assert _ctr("sched.step_time_seeded") > before


# --------------------------------------------------------------- artifact --
def _partial(tmp_path):
    """A full fleet pass, then a store holding all but the last group: the
    store of a fleet killed before its last measurement."""
    cfg = _cfg()
    _fleet(tmp_path, out_path=None)
    groups = grid_mod.enumerate_work(cfg, BATCH, MAXLEN)
    store = CompileCache(tmp_path / "tuner_cache.json")
    partial = CompileCache(tmp_path / "partial_cache.json")
    for g in groups[:-1]:
        partial.put(g.key, store.get(g.key))
    return groups, partial


def test_publish_salvages_partial_store(tmp_path):
    """Publish never demands completeness: the measured entries ship
    (complete false, the gap listed)."""
    groups, partial = _partial(tmp_path)
    lost = groups[-1].key
    salvaged = _ctr("artifact.salvaged")
    art = tmp_path / "partial.artifact.json"
    summary = artifact_mod.publish(partial, groups, art)
    assert summary["complete"] is False
    assert summary["missing"] == 1
    assert summary["entries"] == len(groups) - 1
    assert _ctr("artifact.salvaged") > salvaged

    doc = artifact_mod.load(art)
    assert doc["complete"] is False and doc["missing"] == [lost]
    assert lost not in doc["entries"]
    # every shipped entry is manifest-valid
    for key, plan in doc["entries"].items():
        assert artifact_mod.verify_entry(key, plan,
                                         doc["manifest"][key]) is None


def test_partial_artifact_replica_measures_only_the_gap(tmp_path,
                                                        monkeypatch):
    groups, partial = _partial(tmp_path)
    art = tmp_path / "partial.artifact.json"
    artifact_mod.publish(partial, groups, art)

    measured_before = _ctr("registry.measure")
    eng = _replica(art, tmp_path / "replica-cache", monkeypatch)
    stats = eng.stats()
    assert stats["warmup_failed"] == 0
    # exactly one fresh measurement: the one missing bucket; everything
    # the artifact covered replays
    assert _ctr("registry.measure") - measured_before == 1
    assert stats["warmup_measured"] >= 1


def test_verify_entry_reasons():
    env = "torch-test"
    plan = {"factor": 2, "mode": "T", "env": env}
    man = {"sha256": artifact_mod.entry_hash(plan), "env": env}
    assert artifact_mod.verify_entry("k", plan, man, env=env) is None
    assert artifact_mod.verify_entry("k", plan, None, env=env) == "missing"
    assert artifact_mod.verify_entry("k", "junk", man, env=env) == "invalid"
    assert artifact_mod.verify_entry("k", {"mode": "T"}, man,
                                     env=env) == "invalid"
    tampered = dict(plan, factor=8)
    assert artifact_mod.verify_entry("k", tampered, man, env=env) == "corrupt"
    stale = dict(plan, env="torch-0.0.0")
    man_stale = {"sha256": artifact_mod.entry_hash(stale)}
    assert artifact_mod.verify_entry("k", stale, man_stale,
                                     env=env) == "stale"
    # the port's device rule: an entry timed on another kind of device
    # than the replica serves on is stale; a manifest without a device
    # (a plan that was never timed) passes
    timed = dict(man, device="NVIDIA H100 80GB HBM3")
    assert artifact_mod.verify_entry("k", plan, timed, env=env,
                                     device="cpu") == "stale"
    assert artifact_mod.verify_entry("k", plan, timed, env=env,
                                     device="NVIDIA H100 80GB HBM3") is None
    assert artifact_mod.verify_entry("k", plan, man, env=env,
                                     device="cpu") is None


def test_artifact_timed_on_another_device_is_stale(tmp_path, monkeypatch):
    """The manifest records the device each plan was timed on (here the
    CPU); a replica that serves on another kind of device rejects every
    entry as stale and measures its grid locally."""
    out = _fleet(tmp_path)
    doc = json.loads((tmp_path / "plans.artifact.json").read_text())
    assert {m["device"] for m in doc["manifest"].values()} == {"cpu"}
    for man in doc["manifest"].values():
        man["device"] = "NVIDIA H100 80GB HBM3"
    (tmp_path / "card.artifact.json").write_text(json.dumps(doc))
    eng = _replica(tmp_path / "card.artifact.json",
                   tmp_path / "replica-cache", monkeypatch)
    stats = eng.stats()
    assert stats["artifact"]["verified"] == 0
    assert stats["artifact"]["reasons"] == {"stale": out["groups"]}
    assert stats["warmup_measured"] == out["groups"]
    assert stats["warmup_failed"] == 0


def test_tampered_artifact_degrades_per_entry(tmp_path, monkeypatch):
    """Bitrot in one entry (a hash mismatch): the replica rejects that
    entry (quarantining its artifact provenance), preloads the rest,
    re-measures the rejected bucket locally, and serves."""
    from repro_torch.compiler import default_cache
    cfg = _cfg()
    art = tmp_path / "plans.artifact.json"
    _fleet(tmp_path)
    doc = json.loads(art.read_text())
    bad_key = sorted(doc["entries"])[0]
    doc["entries"][bad_key]["factor"] = 999      # sha256 now mismatches
    art.write_text(json.dumps(doc))

    rejected = _ctr("artifact.rejected")
    measured = _ctr("registry.measure")
    eng = _replica(art, tmp_path / "replica-cache", monkeypatch)
    stats = eng.stats()
    assert stats["artifact"]["rejected"] == 1
    assert stats["artifact"]["reasons"] == {"corrupt": 1}
    assert stats["artifact"]["verified"] == stats["artifact"]["total"] - 1
    assert _ctr("artifact.rejected") > rejected
    assert _ctr("registry.measure") - measured == 1
    # provenance quarantined under the :artifact suffix, never the
    # backend rung, so the local re-measure is not gated
    q = default_cache().quarantine_entries()
    assert f"{bad_key}:artifact" in q
    assert stats["warmup_failed"] == 0
    toks = eng.generate(_prompts(cfg.vocab_size), 3)
    assert tuple(toks.shape) == (BATCH, 3)


def test_stale_env_artifact_rejected_as_stale(tmp_path, monkeypatch):
    art = tmp_path / "plans.artifact.json"
    _fleet(tmp_path)
    doc = json.loads(art.read_text())
    for key, plan in doc["entries"].items():
        plan["env"] = "torch-0.0.0-other-build"
        # keep the hash valid so the env check is what rejects
        doc["manifest"][key]["sha256"] = artifact_mod.entry_hash(plan)
    art.write_text(json.dumps(doc))
    eng = _replica(art, tmp_path / "replica-cache", monkeypatch)
    stats = eng.stats()
    assert stats["artifact"]["verified"] == 0
    assert stats["artifact"]["rejected"] == stats["artifact"]["total"]
    assert set(stats["artifact"]["reasons"]) == {"stale"}
    # a full local warmup still happened
    assert stats["warmup_failed"] == 0
    assert stats["plans_warmed"] >= 1


# ------------------------------------------------------------ cache prune --
def test_cache_prune_gc(tmp_path):
    cache = CompileCache(tmp_path / "c.json")
    now = time.time()
    cache.put("fresh", {"factor": 1})
    cache.put("aged", {"factor": 1, "created": now - 1000.0})
    cache.put("stale", {"factor": 1, "env": "torch-0.0.0-other"})
    cache.record_failure("flaky", "boom", now=now)
    until = cache.quarantine_entries()["flaky"]["until"]

    pruned = _ctr("cache.pruned")
    ev = cache.prune(max_age_s=500.0, now=now)
    assert ev["stale_env"] == 1 and ev["aged"] == 1
    assert ev["quarantine"] == 0          # window still open: kept
    assert _ctr("cache.pruned") > pruned
    assert cache.get("fresh") is not None
    assert cache.get("aged") is None and cache.get("stale") is None
    assert "flaky" in cache.quarantine_entries()

    # a second prune past the backoff window forgives the quarantine row
    ev2 = cache.prune(now=until + 1.0)
    assert ev2["quarantine"] == 1 and ev2["aged"] == 0
    assert cache.quarantine_entries() == {}
    assert cache.get("fresh") is not None

    # cold re-read: the evictions persisted to disk
    cold = CompileCache(tmp_path / "c.json")
    assert cold.get("fresh") is not None and cold.get("aged") is None


def test_cache_prune_survives_readonly_store(tmp_path):
    cache = CompileCache(tmp_path / "missing" / "c.json")
    assert cache.prune(max_age_s=1.0) == {"stale_env": 0, "aged": 0,
                                          "corrupt": 0, "quarantine": 0}


def test_put_many_is_one_write(tmp_path, monkeypatch):
    """``put_many`` installs a batch under one locked merge-write, stamped
    like ``put``'s entries, and merges with what another writer left."""
    from repro_torch.compiler.cache import _env_fingerprint
    path = tmp_path / "c.json"
    CompileCache(path).put("other", {"factor": 1})
    cache = CompileCache(path)
    saves = []
    real = cache._save
    monkeypatch.setattr(cache, "_save",
                        lambda *a, **k: (saves.append(1), real(*a, **k)))
    cache.put_many({"a": {"factor": 2}, "b": {"factor": 4, "env": "x"}})
    assert len(saves) == 1
    cold = CompileCache(path)
    assert cold.get("other")["factor"] == 1
    assert cold.get("a")["env"] == _env_fingerprint()
    assert cold.get("b")["env"] == "x" and "created" in cold.get("a")


# ------------------------------------------- two-process SIGKILL reclaim --
_DOOMED_WORKER = """
import sys, time
from repro_torch.tune.lease import LeaseLedger
led = LeaseLedger(sys.argv[1], ttl_s=0.5)
got = led.claim("doomed")
print("CLAIMED", got[0] if got else "nothing", flush=True)
time.sleep(600)      # park mid-lease until SIGKILLed
"""


def test_sigkill_mid_lease_survivor_completes(tmp_path):
    """A second OS process claims a shard and is SIGKILLed mid-lease.
    After the TTL the in-process survivor reclaims it, finishes the whole
    grid, and publishes a complete artifact whose every entry verifies
    against its manifest: no lost work, no double publish."""
    cfg = _cfg()
    ledger_path = tmp_path / "ledger.json"
    groups = grid_mod.enumerate_work(cfg, BATCH, MAXLEN)
    assert len(groups) >= 2, "need >=2 shards for a meaningful kill"
    shards = grid_mod.shard_groups(groups, 2)
    led = LeaseLedger(ledger_path, ttl_s=0.5)
    led.init_shards(grid_mod.shard_keys(shards))

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.Popen([sys.executable, "-c", _DOOMED_WORKER,
                             str(ledger_path)],
                            stdout=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("CLAIMED shard-"), line
        dead_shard = line.split()[1]
        proc.kill()                      # SIGKILL: no cleanup, no release
        proc.wait(timeout=30)
        assert proc.returncode == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert led.snapshot()[dead_shard]["owner"] == "doomed"

    time.sleep(0.6)                      # let the dead lease expire
    reclaimed = _ctr("tune.lease_reclaimed")
    out = _fleet(tmp_path, n_shards=2, worker_id="survivor", ttl_s=0.5)
    assert _ctr("tune.lease_reclaimed") > reclaimed
    assert led.all_done()
    assert led.snapshot()[dead_shard]["owner"] == "survivor"
    assert led.snapshot()[dead_shard]["attempts"] == 2
    assert out["artifact"]["complete"] is True
    assert out["artifact"]["entries"] == len(groups)

    doc = artifact_mod.load(tmp_path / "plans.artifact.json")
    assert sorted(doc["entries"]) == sorted(g.key for g in groups)
    for key, plan in doc["entries"].items():
        assert artifact_mod.verify_entry(key, plan,
                                         doc["manifest"][key]) is None


# -------------------------------------------------------------- card lock --
def test_two_workers_never_hold_the_card_lock_at_once(tmp_path):
    """Two workers on one ledger, store and device, each in its own
    thread: the card lock serializes their measurements (no two intervals
    overlap), the waiting worker keeps its lease alive, and together they
    drain the grid."""
    TTL = 1.5
    cfg = _cfg("mamba2-1.3b")
    groups = grid_mod.enumerate_work(cfg, BATCH, 64)
    shards = grid_mod.shard_groups(groups, 4)
    assert len(shards) >= 2
    led = LeaseLedger(tmp_path / "ledger.json", ttl_s=TTL)
    led.init_shards(grid_mod.shard_keys(shards))
    holding = []
    overlap = []

    def hook(_item):
        # hold the card past the other worker's TTL / 3, so it waits and
        # heartbeats while this one measures
        holding.append(1)
        if len(holding) > 1:
            overlap.append(True)
        time.sleep(TTL / 3 + 0.05)
        holding.pop()

    reports = {}

    def run(wid):
        w = TunerWorker(wid, LeaseLedger(tmp_path / "ledger.json",
                                         ttl_s=TTL),
                        CompileCache(tmp_path / "store.json"), shards,
                        device="cpu", measure_hook=hook)
        reports[wid] = w.run()

    threads = [threading.Thread(target=run, args=(f"w{i}",))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not overlap
    assert led.all_done()
    ivs = sorted(iv for r in reports.values() for iv in r.intervals)
    assert len(ivs) == len(groups)
    for (_a0, a1), (b0, _b1) in zip(ivs, ivs[1:]):
        assert b0 >= a1, "two measurements overlapped on the card"
    assert all(r.intervals for r in reports.values()), \
        "one worker never measured"
    assert sum(r.lock_wait_s for r in reports.values()) > TTL / 3
    assert not any(r.shards_lost for r in reports.values())
    assert not any(r.failed for r in reports.values())
