"""Continuous batching in the port against the JAX package: the scheduler's
numpy parts, per-slot decode, continuation prefill and whole request
streams (SMOKE configs, fp32, on the CPU, where the ops take their plain
versions).

* ``synthetic_workload`` gives the reference's traces field for field, and
  ``SlotManager`` keeps the reference's guards.
* Per-slot decode: per-slot caches filled through both packages'
  ``insert_rows`` from prefills of different lengths, then decode steps at
  ragged positions; logits and every cache leaf within 1e-5, for qwen3,
  deepseek-v2-lite (MLA, the ragged MoE route against the reference's
  dense dropless one), mamba2 and zamba2, on the kernel and plain routes.
* Continuation prefill: ``Engine.prefill_chunk`` in uneven chunks (one
  shorter than the conv window) against the JAX engine's, within 1e-5, and
  against one whole prefill.
* Streams: the same workload through the JAX engine's ``serve_stream`` and
  the port's, at an explicit ``step_time_ms``: the ``step_hook`` snapshots
  equal at every step, tokens identical, logits within 1e-5; FIFO, chunked
  and an overload trace (preemption, ``max_queue``, deadlines) for qwen3,
  a short trace for each of the other three.
* A freed lane's ``pos`` runs past ``max_len`` without error or change.
* ``launch.serve --arrival-rate`` prints the stream lines.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.configs.base import load_arch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.serve import engine as port_engine  # noqa: E402
from repro_torch.serve import scheduler as port_sched  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# a Mamba-2 state at the SSM slice's rtol (tests/test_torch_ssm.py)
STATE_TOL = dict(rtol=2e-5, atol=1e-5)
BATCH, MAX_LEN = 4, 32
RAGGED = dict(ragged_dropless=True, inference_capacity_factor=0.0)
DENSE = dict(ragged_dropless=False, inference_capacity_factor=0.0)

# (arch, route): (port config fields, reference config fields); deepseek's
# kernel route is the ragged grouped GEMM against the reference's dense
# dropless route (its jitted engine always takes that one)
ROUTES = {
    ("qwen3-0.6b", "pallas"): ({"attention_impl": "pallas"},) * 2,
    ("qwen3-0.6b", "plain"): ({"attention_impl": "xla_chunked"},) * 2,
    ("deepseek-v2-lite-16b", "pallas"): ({"moe": RAGGED}, {"moe": DENSE}),
    ("deepseek-v2-lite-16b", "plain"): ({"moe": DENSE},) * 2,
    ("mamba2-1.3b", "pallas"): ({"ssm_impl": "pallas"},) * 2,
    ("mamba2-1.3b", "plain"): ({"ssm_impl": "xla"},) * 2,
    ("zamba2-2.7b", "pallas"): (
        {"attention_impl": "pallas", "ssm_impl": "pallas"},) * 2,
    ("zamba2-2.7b", "plain"): (
        {"attention_impl": "xla_chunked", "ssm_impl": "xla"},) * 2,
}
CASES = sorted(ROUTES)


@pytest.fixture(autouse=True)
def _private_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax-cache"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))


def _ref_module(arch):
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro.configs.{name}")


def _configure(cfg, fields):
    fields = dict(fields)
    moe = fields.pop("moe", None)
    if moe is not None:
        cfg = dataclasses.replace(cfg,
                                  moe=dataclasses.replace(cfg.moe, **moe))
    return dataclasses.replace(cfg, **fields)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's ``init_params(SMOKE)`` as (JAX params, port model)."""
    from repro.models import transformer as jax_tf
    params = jax_tf.init_params(_ref_module(arch).SMOKE,
                                jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return params, convert.from_jax_params(load_arch(arch, smoke=True), tree)


@functools.lru_cache(maxsize=None)
def _engines(arch, route):
    """(JAX engine on direct plans, port engine) on the same weights, batch
    ``BATCH``, ``MAX_LEN``; cached, since the JAX engine's compiled steps
    are most of the cost."""
    from repro.serve.engine import Engine, ServeConfig
    pf, jf = ROUTES[arch, route]
    params, model = _weights(arch)
    jeng = Engine(_configure(_ref_module(arch).SMOKE, jf), params,
                  ServeConfig(batch=BATCH, max_len=MAX_LEN, warmup=False,
                              kernel_plan="direct"))
    peng = port_engine.Engine(
        _configure(load_arch(arch, smoke=True), pf), model,
        port_engine.ServeConfig(batch=BATCH, max_len=MAX_LEN), device="cpu")
    return jeng, peng


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _assert_caches_match(pcache, jcache, err=""):
    """Every leaf of the port's cache (lists of per-layer dicts) against the
    reference's (leaves stacked over layers)."""
    assert sorted(pcache) == sorted(jcache)
    for name, layers in pcache.items():
        for i, layer in enumerate(layers):
            for key, got in layer.items():
                want = np.asarray(jcache[name][key][i])
                got = got.numpy() if isinstance(got, torch.Tensor) \
                    else np.asarray(got)
                np.testing.assert_allclose(
                    got, want, err_msg=f"{err} {name}[{i}].{key}",
                    **(STATE_TOL if key == "state" else TOL))


# ------------------------------------------------------------- workload ---
WORKLOADS = [
    dict(n_requests=12, seed=7, arrival_rate=0.4),
    dict(n_requests=16, seed=4, arrival_rate=0.5),
    dict(n_requests=9, seed=0, arrival_rate=1.0, prompt_lens=(2, 5, 9)),
    dict(n_requests=64, seed=4, arrival_rate=3.0, prompt_lens=(2, 16),
         prompt_len_weights=(0.9, 0.1), deadlines_ms=(5, None),
         priorities=(0, 1)),
    dict(n_requests=30, seed=13, arrival_rate=0.35,
         prompt_lens=(2, 4, 8, 16), new_tokens=(2, 4, 6),
         prompt_len_weights=(0.35, 0.3, 0.2, 0.15),
         deadlines_ms=(10, 20, None), priorities=(0, 1, 2)),
    dict(n_requests=16, seed=23, prompt_lens=(128, 256, 512),
         new_tokens=(16, 32), arrival_rate=0.5, vocab=151936),
]


@pytest.mark.parametrize("kw", WORKLOADS, ids=lambda kw: f"seed{kw['seed']}"
                         f"-rate{kw['arrival_rate']}")
def test_synthetic_workload_matches_reference(kw):
    from repro.serve import scheduler as jax_sched
    got = port_sched.synthetic_workload(**kw)
    want = jax_sched.synthetic_workload(**kw)
    assert len(got) == len(want) == kw["n_requests"]
    for g, w in zip(got, want):
        assert (g.rid, g.n_new, g.arrival, g.priority, g.deadline_ms) == \
            (w.rid, w.n_new, w.arrival, w.priority, w.deadline_ms)
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.tokens.dtype == w.tokens.dtype
        assert g.prompt_len == w.prompt_len


def test_workload_and_slot_manager_guards():
    with pytest.raises(ValueError, match="arrival_rate"):
        port_sched.synthetic_workload(2, arrival_rate=0.0)
    with pytest.raises(ValueError, match="prompt_len_weights"):
        port_sched.synthetic_workload(2, prompt_len_weights=(1.0,))
    with pytest.raises(ValueError):
        port_sched.synthetic_workload(2, priorities=())
    with pytest.raises(ValueError, match="max_slots"):
        port_sched.SlotManager(0)
    sm = port_sched.SlotManager(2)
    s0, s1 = sm.alloc(10), sm.alloc(11)
    assert (s0, s1) == (0, 1) and sm.free_count == 0 and sm.occupancy == 2
    with pytest.raises(RuntimeError, match="no free slots"):
        sm.alloc(12)
    sm.free(s0)
    with pytest.raises(RuntimeError, match="double-freed"):
        sm.free(s0)
    assert sm.alloc(12) == s0          # a freed lane is reused
    sm._free.append(s1)                # a corrupted free list is caught
    with pytest.raises(RuntimeError, match="double-allocated"):
        sm.alloc(13)


# ------------------------------------------------------ per-slot decode ---
@pytest.mark.parametrize("arch,route", CASES)
def test_per_slot_decode_matches_reference(arch, route):
    """Lanes at depths 5, 0 (free), 3 and 3, filled through each package's
    ``insert_rows``, then 3 decode steps of the whole slot cache."""
    from repro.models import model as jax_model
    from repro.serve import scheduler as jax_sched
    jeng, peng = _engines(arch, route)
    jbig = jax_model.init_cache(jeng.cfg, BATCH, MAX_LEN, jnp.float32,
                                per_slot_pos=True)
    pbig = port_model.init_cache(peng.cfg, BATCH, MAX_LEN, torch.float32,
                                 "cpu", per_slot_pos=True)
    assert pbig["blocks"][0]["pos"].dtype == torch.int32
    for seed, (plen, slots) in enumerate(((5, [0]), (3, [3, 2]))):
        toks = _tokens(seed, (len(slots), plen))
        jsmall, _ = jeng.prefill(jnp.asarray(toks))
        jbig = jax_sched.insert_rows(jbig, jsmall, slots, len(slots))
        psmall, _ = peng.prefill(torch.from_numpy(toks))
        before = [t.data_ptr() for t in port_sched._layers(pbig)[0].values()]
        assert port_sched.insert_rows(pbig, psmall, slots, len(slots)) is pbig
        # in place: the big cache keeps its tensors
        assert before == [t.data_ptr()
                          for t in port_sched._layers(pbig)[0].values()]
    _assert_caches_match(pbig, jbig, "after insert")
    for step in range(3):
        toks = _tokens(10 + step, (BATCH, 1))
        jl, jbig = jeng._decode_token(jbig, {"tokens": jnp.asarray(toks)})
        pl, pbig = peng.decode_token(pbig, torch.from_numpy(toks))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   err_msg=f"step {step}", **TOL)
    _assert_caches_match(pbig, jbig, "after decode")
    seg0 = next(iter(pbig))
    assert pbig[seg0][0]["pos"].tolist() == [8, 3, 6, 6]


@pytest.mark.parametrize("arch", sorted({arch for arch, _ in CASES}))
def test_decode_step_builds_one_slot_step(arch, monkeypatch):
    """A per-slot decode step builds its cache write, masks and next ``pos``
    once (``layers.slot_step``) for every layer: one call a step, none in
    the layers, and every layer's new ``pos`` is the one tensor it made."""
    from repro_torch.models import attention, transformer
    _, peng = _engines(arch, "pallas")
    calls = []
    real = transformer.slot_step
    monkeypatch.setattr(transformer, "slot_step",
                        lambda *a: calls.append(a) or real(*a))
    monkeypatch.setattr(attention, "slot_step", None)   # a layer's own: off
    cache = port_model.init_cache(peng.cfg, BATCH, MAX_LEN, torch.float32,
                                  "cpu", per_slot_pos=True)
    for layer in port_sched._layers(cache):
        layer["pos"].copy_(torch.tensor([0, 7, MAX_LEN - 1, MAX_LEN + 3]))
    _, cache = peng.decode_token(cache, torch.from_numpy(
        _tokens(0, (BATCH, 1))).long())
    assert len(calls) == 1
    poses = [layer["pos"] for layer in port_sched._layers(cache)]
    assert all(p is poses[0] for p in poses)
    assert poses[0].tolist() == [1, 8, MAX_LEN, MAX_LEN + 4]


def test_per_slot_positions_are_decode_only():
    _, peng = _engines("qwen3-0.6b", "plain")
    cache = port_model.init_cache(peng.cfg, 2, MAX_LEN, torch.float32, "cpu",
                                  per_slot_pos=True)
    with pytest.raises(ValueError, match="decode-only"):
        peng.decode_token(cache, torch.zeros(2, 3, dtype=torch.long))


# ------------------------------------------------- continuation prefill ---
CHUNKS = (5, 2, 1, 4)      # the 2 and the 1 are shorter than the conv window


@pytest.mark.parametrize("arch,route", CASES)
def test_prefill_chunk_matches_reference(arch, route):
    jeng, peng = _engines(arch, route)
    toks = _tokens(3, (2, sum(CHUNKS)))
    jcache = jeng._cache_factory(2)
    pcache = port_model.init_cache(peng.cfg, 2, MAX_LEN, torch.float32,
                                   "cpu")
    lo = 0
    for n in CHUNKS:
        chunk = toks[:, lo:lo + n]
        jcache, jlast = jeng.prefill_chunk(jcache, jnp.asarray(chunk))
        pcache, plast = peng.prefill_chunk(pcache, torch.from_numpy(chunk))
        lo += n
        np.testing.assert_allclose(plast.numpy(), np.asarray(jlast),
                                   err_msg=f"chunk ending at {lo}", **TOL)
    _assert_caches_match(pcache, jcache)
    # the same prompt in one fresh prefill
    whole, wlast = peng.prefill(torch.from_numpy(toks))
    np.testing.assert_allclose(plast.numpy(), wlast.numpy(), **TOL)
    for got, want in zip(port_sched._layers(pcache),
                         port_sched._layers(whole)):
        assert got["pos"] == want["pos"] == lo
        for key in got:
            if key != "pos":
                np.testing.assert_allclose(
                    got[key].numpy(), want[key].numpy(),
                    **(STATE_TOL if key == "state" else TOL))


# -------------------------------------------------------------- streams ---
def _serve(eng, reqs, **kw):
    snaps = []
    completed, shed = eng.serve_stream(reqs, step_hook=snaps.append,
                                       collect_logits=True, return_shed=True,
                                       step_time_ms=1.0, **kw)
    return snaps, completed, shed


STREAMS = {
    "qwen3-fifo": ("qwen3-0.6b", "pallas", dict(
        n_requests=8, seed=11, prompt_lens=(3, 5, 8), new_tokens=(1, 3, 5),
        arrival_rate=0.5), {}),
    "qwen3-chunked": ("qwen3-0.6b", "plain", dict(
        n_requests=6, seed=21, prompt_lens=(3, 9, 17), new_tokens=(2, 4),
        arrival_rate=0.6), dict(prefill_chunk_tokens=5)),
    "qwen3-overload": ("qwen3-0.6b", "pallas", dict(
        n_requests=18, seed=7, prompt_lens=(2, 5, 9, 14),
        new_tokens=(1, 3, 5), arrival_rate=2.0,
        prompt_len_weights=(0.4, 0.3, 0.2, 0.1), deadlines_ms=(8, 30, None),
        priorities=(0, 1)), dict(max_slots=2, prefill_chunk_tokens=4,
                                 preempt_policy="lowest_priority",
                                 max_queue=6, deadline_aware=True)),
    "mamba2": ("mamba2-1.3b", "pallas", dict(
        n_requests=5, seed=2, prompt_lens=(3, 9), new_tokens=(2, 4),
        arrival_rate=0.7), dict(prefill_chunk_tokens=4)),
    "deepseek": ("deepseek-v2-lite-16b", "pallas", dict(
        n_requests=4, seed=5, prompt_lens=(4, 7), new_tokens=(2, 3),
        arrival_rate=0.8), dict(prefill_chunk_tokens=4)),
    "zamba2": ("zamba2-2.7b", "pallas", dict(
        n_requests=4, seed=6, prompt_lens=(4, 7), new_tokens=(2, 3),
        arrival_rate=0.8), dict(prefill_chunk_tokens=4)),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_stream_matches_reference_scheduler(case):
    from repro.serve import scheduler as jax_sched
    arch, route, wl, kw = STREAMS[case]
    jeng, peng = _engines(arch, route)
    wl = dict(wl, vocab=peng.cfg.vocab_size)
    jsnaps, jdone, jshed = _serve(jeng, jax_sched.synthetic_workload(**wl),
                                  **kw)
    psnaps, pdone, pshed = _serve(peng, port_sched.synthetic_workload(**wl),
                                  **kw)
    assert len(psnaps) == len(jsnaps)
    for p, j in zip(psnaps, jsnaps):
        assert p == j, f"step {j['step']}"
    assert [(r.rid, r.reason, r.shed_step) for r in pshed] == \
        [(r.rid, r.reason, r.shed_step) for r in jshed]
    assert [r.rid for r in pdone] == [r.rid for r in jdone]
    for p, j in zip(pdone, jdone):
        np.testing.assert_array_equal(p.tokens, j.tokens,
                                      err_msg=f"rid {j.rid}")
        np.testing.assert_allclose(p.logits, j.logits, err_msg=f"rid {j.rid}",
                                   **TOL)
        assert (p.admitted_step, p.done_step, p.preemptions, p.ttft_steps) \
            == (j.admitted_step, j.done_step, j.preemptions, j.ttft_steps)
    if case == "qwen3-overload":
        assert sum(r.preemptions for r in pdone) >= 1 and pshed
        assert {r.reason for r in pshed} <= {"queue_full",
                                             "deadline_unmeetable"}
    if "prefill_chunk_tokens" in kw:
        assert any(s["prefilling"] for s in psnaps), "no chunked prefill"


# ----------------------------------------------- lanes past the cache ---
@pytest.mark.parametrize("route", ["pallas", "plain"])
def test_free_lane_past_max_len_keeps_decoding(route):
    """A long trace on a short cache: idle lanes keep stepping their pos
    past ``max_len`` (they decode garbage every step); nothing raises and
    every request still equals its solo run."""
    cfg = _configure(load_arch("qwen3-0.6b", smoke=True),
                     ROUTES["qwen3-0.6b", route][0])
    eng = port_engine.Engine(cfg, _weights("qwen3-0.6b")[1],
                             port_engine.ServeConfig(batch=2, max_len=8),
                             device="cpu")
    reqs = port_sched.synthetic_workload(
        6, seed=9, prompt_lens=(2, 3), new_tokens=(3, 5),
        arrival_rate=0.15, vocab=cfg.vocab_size)
    deepest = []
    sched = port_sched.Scheduler(
        eng, collect_logits=True, step_hook=lambda _: deepest.append(
            int(sched.cache["blocks"][0]["pos"].max())))
    done = {r.rid: r for r in sched.run(reqs)}
    assert max(deepest) > 8, "no lane ran past max_len"
    for r in reqs:
        toks, logits = eng.generate(torch.from_numpy(r.tokens)[None],
                                    r.n_new, return_logits=True)
        np.testing.assert_array_equal(done[r.rid].tokens, toks.numpy()[0])
        np.testing.assert_allclose(done[r.rid].logits, logits.numpy()[:, 0],
                                   rtol=0, atol=5e-6)


# -------------------------------------------------------------- the CLI ---
def test_serve_cli_stream_mode(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                      "--arrival-rate", "2.0", "--max-slots", "2",
                      "--requests", "10", "--prompt-len", "6", "--new", "3",
                      "--prefill-chunk-tokens", "4", "--preempt",
                      "lowest_priority", "--max-queue", "3",
                      "--deadline-ms", "4"])
    text = capsys.readouterr().out
    assert "[serve] qwen3-smoke on cpu" in text and "streamed" in text
    assert "[serve] slots: peak occupancy 2/2" in text
    assert "[serve] SHED:" in text and "queue_full=" in text
    assert all(len(r.tokens) == 3 for r in res)
