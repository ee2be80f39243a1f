"""The reference's scheduler harness (``tests/test_scheduler.py`` and
``tests/test_scheduler_properties.py``) ported against the port's own
engine: qwen3 SMOKE, fp32, on the CPU.

* Invariants over a 200-step trace: no slot leak or double allocation,
  FIFO admission, conservation after every step (and a lost request fails
  loud); the overload trace (chunked prefill, preemption, deadlines, a
  bounded queue) with every request completed or shed with a named reason.
* Parity: every streamed request's tokens equal its solo
  ``Engine.generate`` run and its logits agree within 5e-6; chunked prefill
  changes no token; a preempted request resumes bit-exact; the registry
  route under ``kernel_plan='measure'`` serves the stream with no miss
  after its warmup and the same parity.
* Each property of the reference's property file as a ``hypothesis`` test
  and as a seeded sweep.

No wall-clock assertion here: the reference's 1.3x throughput bar
(``tests/test_scheduler.py:264``) is checked on the card, in
``chip_smoke.py``.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import load_arch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve import scheduler as sched  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from hypothesis_compat import given, settings, st  # noqa: E402

ARCH = "qwen3-0.6b"
PARITY = 5e-6
_ENGINES = {}


def _engine(batch=4, max_len=32, **fields):
    """A port engine on seeded SMOKE weights (plain attention unless
    ``fields`` say otherwise), built once per shape; a plain function, not
    a fixture, so the ``@given`` tests reach it under hypothesis too."""
    key = (batch, max_len, tuple(sorted(fields.items())))
    if key not in _ENGINES:
        cfg = dataclasses.replace(load_arch(ARCH, smoke=True),
                                  **{"attention_impl": "xla_chunked",
                                     **fields})
        model = convert.init_params(cfg, torch.Generator().manual_seed(0))
        _ENGINES[key] = Engine(cfg, model, ServeConfig(
            batch=batch, max_len=max_len, warmup=False), device="cpu")
    return _ENGINES[key]


def _solo(eng, r):
    toks, logits = eng.generate(torch.from_numpy(np.asarray(r.tokens))[None],
                                r.n_new, return_logits=True)
    return toks.numpy()[0], logits.numpy()[:, 0]


# ------------------------------------------------------------ invariants ---
class InvariantChecker:
    """step_hook that re-derives every scheduler invariant each step."""

    def __init__(self, n_requests: int, max_slots: int):
        self.n, self.max_slots = n_requests, max_slots
        self.steps = 0
        self.admitted_order = []
        self.ever_active = set()
        self.max_occupancy = 0

    def __call__(self, snap):
        self.steps += 1
        occ = snap["occupancy"]
        assert 0 <= occ <= self.max_slots, snap
        assert occ == len(snap["active"]), "occupancy vs active desync"
        assert occ + snap["free"] == self.max_slots, "slot leak"
        rids = list(snap["active"].values())
        assert len(rids) == len(set(rids)), \
            f"request in two slots at step {snap['step']}: {snap['active']}"
        self.admitted_order.extend(snap["admitted"])
        self.ever_active.update(rids)
        self.max_occupancy = max(self.max_occupancy, occ)
        assert (snap["pending"] + len(snap["queue"]) + occ
                + snap["completed"]) == self.n, snap

    def finish(self, results, requests):
        assert len(results) == self.n, "not every request completed"
        assert self.admitted_order == sorted(self.admitted_order), \
            f"FIFO admission violated: {self.admitted_order}"
        assert set(self.admitted_order) == {r.rid for r in requests}
        assert len(self.admitted_order) == self.n
        assert self.ever_active <= {r.rid for r in requests}
        for r in results:
            assert r.queue_wait_steps >= 0
            assert r.admitted_step >= 0 and r.done_step >= r.admitted_step


def test_invariants_over_200_step_trace():
    eng = _engine()
    reqs = sched.synthetic_workload(70, seed=3, prompt_lens=(2, 4),
                                    new_tokens=(2, 4, 6), arrival_rate=0.28,
                                    vocab=eng.cfg.vocab_size)
    chk = InvariantChecker(len(reqs), max_slots=4)
    res = eng.serve_stream(reqs, step_hook=chk)
    chk.finish(res, reqs)
    assert chk.steps >= 200, f"trace too short: {chk.steps} steps"
    assert chk.max_occupancy == 4, "the trace never filled the slots"
    assert any(r.queue_wait_steps > 0 for r in res), \
        "the trace never exercised the queue"


def test_conservation_violation_fails_loud():
    eng = _engine()
    reqs = sched.synthetic_workload(4, seed=0, prompt_lens=(2,),
                                    new_tokens=(2,), arrival_rate=1.0,
                                    vocab=eng.cfg.vocab_size)
    s = sched.Scheduler(eng)
    s.submit(reqs)
    s._total += 1  # a lost request
    with pytest.raises(RuntimeError, match="conservation"):
        while s.pending or s.queue or s.active:
            s.run_step()


def test_request_and_option_validation():
    eng = _engine()
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.serve_stream([sched.Request(0, np.zeros(40, np.int32), 8)])
    with pytest.raises(ValueError, match="n_new"):
        eng.serve_stream([sched.Request(0, np.zeros(4, np.int32), 0)])
    with pytest.raises(ValueError, match="preempt_policy"):
        sched.Scheduler(eng, preempt_policy="steal_everything")
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        sched.Scheduler(eng, prefill_chunk_tokens=0)
    with pytest.raises(ValueError, match="max_queue"):
        sched.Scheduler(eng, max_queue=0)
    with pytest.raises(ValueError, match="step_time_ms"):
        sched.Scheduler(eng, step_time_ms=0.0)


class OverloadChecker(InvariantChecker):
    """The invariants with sheds, preemption re-admissions, the queue bound
    and the chunked-prefill snapshot key."""

    def __init__(self, n_requests, max_slots, max_queue=None):
        super().__init__(n_requests, max_slots)
        self.max_queue = max_queue
        self.admissions, self.preemptions = {}, {}
        self.saw_prefilling = False

    def __call__(self, snap):
        self.steps += 1
        occ = snap["occupancy"]
        assert 0 <= occ <= self.max_slots and occ == len(snap["active"])
        assert occ + snap["free"] == self.max_slots, "slot leak"
        rids = list(snap["active"].values())
        assert len(rids) == len(set(rids)), snap
        if self.max_queue is not None:
            assert len(snap["queue"]) <= self.max_queue, snap
        assert set(snap["prefilling"]) <= set(snap["active"]), snap
        self.saw_prefilling |= bool(snap["prefilling"])
        for rid in snap["admitted"]:
            self.admissions[rid] = self.admissions.get(rid, 0) + 1
        for rid in snap["preempted"]:
            self.preemptions[rid] = self.preemptions.get(rid, 0) + 1
        self.max_occupancy = max(self.max_occupancy, occ)
        assert (snap["pending"] + len(snap["queue"]) + occ
                + snap["completed"] + snap["shed"]) == self.n, snap

    def finish(self, completed, shed, requests):
        done, dropped = {r.rid for r in completed}, {s.rid for s in shed}
        assert done | dropped == {r.rid for r in requests}
        assert not (done & dropped), "request both completed and shed"
        assert not (dropped & set(self.admissions)), \
            "a shed request was admitted into a slot"
        for r in completed:
            assert self.admissions.get(r.rid) == 1 + r.preemptions
            assert self.preemptions.get(r.rid, 0) == r.preemptions
        for s in shed:
            assert s.reason in ("queue_full", "deadline_unmeetable"), s


def test_overload_invariants_200_steps_with_preemption():
    eng = _engine()
    reqs = sched.synthetic_workload(
        130, seed=13, prompt_lens=(2, 4, 8, 16), new_tokens=(2, 4, 6),
        arrival_rate=0.35, vocab=eng.cfg.vocab_size,
        prompt_len_weights=(0.35, 0.3, 0.2, 0.15),
        deadlines_ms=(10, 20, None), priorities=(0, 1, 2))
    chk = OverloadChecker(len(reqs), max_slots=2, max_queue=8)
    completed, shed = eng.serve_stream(
        reqs, max_slots=2, step_hook=chk, prefill_chunk_tokens=4,
        preempt_policy="lowest_priority", max_queue=8,
        deadline_aware=True, return_shed=True, step_time_ms=1.0)
    chk.finish(completed, shed, reqs)
    assert chk.steps >= 200, f"trace too short: {chk.steps} steps"
    assert chk.max_occupancy == 2
    assert chk.saw_prefilling, "chunked prefill never engaged"
    assert sum(chk.preemptions.values()) >= 1, "no preemption"
    assert shed, "the trace never shed"
    assert set(chk.preemptions) <= {r.rid for r in completed}


# ---------------------------------------------------------------- parity ---
@pytest.mark.parametrize("impl", ["pallas", "xla_chunked"])
def test_stream_token_parity_vs_solo(impl):
    eng = _engine(attention_impl=impl)
    reqs = sched.synthetic_workload(8, seed=11, prompt_lens=(3, 5, 8),
                                    new_tokens=(1, 3, 5), arrival_rate=0.5,
                                    vocab=eng.cfg.vocab_size)
    res = {r.rid: r for r in eng.serve_stream(reqs, collect_logits=True)}
    for r in reqs:
        got = res[r.rid]
        assert got.tokens.shape == (r.n_new,)
        assert got.logits.shape == (r.n_new, eng.cfg.vocab_size)
        toks, logits = _solo(eng, r)
        np.testing.assert_array_equal(got.tokens, toks, err_msg=f"{r.rid}")
        err = float(np.max(np.abs(got.logits - logits)))
        assert err <= PARITY, f"rid {r.rid}: logit drift {err:.2e}"


def test_chunked_prefill_token_parity():
    eng = _engine()
    reqs = sched.synthetic_workload(6, seed=21, prompt_lens=(3, 9, 17),
                                    new_tokens=(2, 4), arrival_rate=0.6,
                                    vocab=eng.cfg.vocab_size)
    plain = {r.rid: r.tokens for r in eng.serve_stream(reqs)}
    for chunk in (4, 5):                    # aligned and ragged boundaries
        chunked = {r.rid: r for r in eng.serve_stream(
            reqs, prefill_chunk_tokens=chunk)}
        for r in reqs:
            np.testing.assert_array_equal(chunked[r.rid].tokens,
                                          plain[r.rid],
                                          err_msg=f"rid {r.rid} chunk {chunk}")
    long_req = max(reqs, key=lambda r: r.prompt_len)
    np.testing.assert_array_equal(plain[long_req.rid],
                                  _solo(eng, long_req)[0])


def test_preempted_request_resumes_bit_exact():
    eng = _engine()
    rng = np.random.default_rng(0)
    toks = lambda n: rng.integers(0, eng.cfg.vocab_size, n, dtype=np.int64)
    reqs = [sched.Request(0, toks(4), 10, arrival=0, priority=0),
            sched.Request(1, toks(4), 10, arrival=0, priority=0),
            # a high-priority arrival once both slots are busy
            sched.Request(2, toks(4), 2, arrival=2, priority=5)]
    completed, shed = eng.serve_stream(
        reqs, max_slots=2, preempt_policy="lowest_priority",
        return_shed=True)
    assert not shed
    res = {r.rid: r for r in completed}
    assert sum(r.preemptions for r in completed) >= 1, "no preemption"
    for r in reqs:
        np.testing.assert_array_equal(res[r.rid].tokens, _solo(eng, r)[0],
                                      err_msg=f"rid {r.rid}")


def test_admission_control_sheds_with_named_reasons():
    eng = _engine()
    rng = np.random.default_rng(1)
    toks = lambda n: rng.integers(0, eng.cfg.vocab_size, n, dtype=np.int64)
    reqs = [sched.Request(i, toks(4), 6, arrival=0) for i in range(8)]
    # rid 8's deadline no admission can meet; it arrives after the burst,
    # so the bounded queue has room and the reason is the deadline
    reqs.append(sched.Request(8, toks(8), 8, arrival=2, deadline_ms=1.0))
    completed, shed = eng.serve_stream(
        reqs, max_slots=2, max_queue=3, deadline_aware=True,
        return_shed=True, step_time_ms=1.0)
    reasons = {s.rid: s.reason for s in shed}
    assert reasons.get(8) == "deadline_unmeetable"
    assert "queue_full" in set(reasons.values())
    assert len(completed) + len(shed) == len(reqs)


def test_step_time_comes_from_measured_decode_steps():
    eng = _engine(batch=2, max_len=16, attention_impl="pallas")
    eng.generate(torch.zeros(2, 4, dtype=torch.long), 5)
    steps = eng.timer.steady["decode"]
    assert len(steps) >= 3
    assert eng.measured_step_time_ms() == pytest.approx(
        float(np.median(steps)) * 1e3)


def test_stream_parity_registry_route(tmp_path, monkeypatch):
    """``kernel_plan='measure'`` on a private cache and registry: the
    stream runs on warm plans (no miss or fallback after the warmup, hits
    in prefill and decode) with solo parity."""
    from repro_torch import compiler
    from repro_torch.compiler.registry import (PlanRegistry,
                                               set_default_registry)
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    compiler.clear_memo()
    old = set_default_registry(PlanRegistry())
    try:
        cfg = dataclasses.replace(load_arch(ARCH, smoke=True),
                                  attention_impl="pallas",
                                  kernel_plan="measure")
        model = convert.init_params(cfg, torch.Generator().manual_seed(0))
        eng = Engine(cfg, model, ServeConfig(batch=2, max_len=16),
                     device="cpu")
        warm = eng.stats()["registry"]
        assert eng.stats()["plans_warmed"] > 0
        reqs = sched.synthetic_workload(3, seed=2, prompt_lens=(4, 8),
                                        new_tokens=(2, 3), arrival_rate=0.8,
                                        vocab=cfg.vocab_size)
        res = {r.rid: r for r in eng.serve_stream(reqs, collect_logits=True)}
        st = eng.stats()["registry"]
        assert st["misses"] == warm["misses"], "cold after warmup"
        assert st["fallbacks"] == warm["fallbacks"] == 0
        assert st["decode"]["hits"] > warm["decode"]["hits"]
        assert st["prefill"]["hits"] > warm["prefill"]["hits"]
        for r in reqs:
            toks, logits = _solo(eng, r)
            np.testing.assert_array_equal(res[r.rid].tokens, toks)
            err = float(np.max(np.abs(res[r.rid].logits - logits)))
            assert err <= PARITY, f"rid {r.rid}: logit drift {err:.2e}"
    finally:
        set_default_registry(old)


# ------------------------------------------------------------ properties ---
def _workload(seed, rate, vocab):
    return sched.synthetic_workload(
        18, seed=seed, prompt_lens=(2, 5, 9, 14), new_tokens=(1, 3, 5),
        arrival_rate=rate, vocab=vocab,
        prompt_len_weights=(0.4, 0.3, 0.2, 0.1),
        deadlines_ms=(8, 30, None), priorities=(0, 1))


def _check_conservation(seed, rate):
    """Completed and shed each exactly once, admissions = 1 + preemptions,
    a shed request never in a slot, the queue within its bound."""
    eng = _engine(batch=2)
    reqs = _workload(seed, rate, eng.cfg.vocab_size)
    chk = OverloadChecker(len(reqs), max_slots=2, max_queue=6)
    completed, shed = eng.serve_stream(
        reqs, max_slots=2, step_hook=chk, prefill_chunk_tokens=4,
        preempt_policy="lowest_priority", max_queue=6, deadline_aware=True,
        return_shed=True, step_time_ms=1.0)
    chk.finish(completed, shed, reqs)


def _check_chunk_parity(seed, chunk):
    """Any chunk budget gives the unchunked tokens."""
    eng = _engine(batch=2)
    reqs = sched.synthetic_workload(
        5, seed=seed, prompt_lens=(3, 9, 15), new_tokens=(2, 4),
        arrival_rate=0.7, vocab=eng.cfg.vocab_size)
    plain = {r.rid: r.tokens for r in eng.serve_stream(reqs)}
    for r in eng.serve_stream(reqs, prefill_chunk_tokens=chunk):
        np.testing.assert_array_equal(
            r.tokens, plain[r.rid],
            err_msg=f"seed={seed} chunk={chunk} rid={r.rid}")


@given(seed=st.integers(min_value=0, max_value=1 << 12),
       rate=st.sampled_from([1.5, 2.0, 3.0]))
@settings(max_examples=8, deadline=None)
def test_conservation_property(seed, rate):
    _check_conservation(seed, rate)


@given(seed=st.integers(min_value=0, max_value=1 << 12),
       chunk=st.integers(min_value=2, max_value=9))
@settings(max_examples=6, deadline=None)
def test_chunk_parity_property(seed, chunk):
    _check_chunk_parity(seed, chunk)


@pytest.mark.parametrize("seed,rate", [(0, 2.0), (7, 1.5), (23, 3.0)])
def test_conservation_sweep(seed, rate):
    _check_conservation(seed, rate)


@pytest.mark.parametrize("seed,chunk", [(1, 4), (2, 7)])
def test_chunk_parity_sweep(seed, chunk):
    _check_chunk_parity(seed, chunk)
