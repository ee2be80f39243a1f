"""Continuous-batching scheduler over the port's ``Engine``: the port of
``repro.serve.scheduler``.

A fixed budget of ``max_slots`` decode lanes over one preallocated cache is
kept busy by interleaving independent requests through it, instead of
draining one batch at a time.  Each scheduler step runs

    arrivals -> shed sweep -> preemption -> admission -> prefill chunks
             -> batched decode

* **Slots**: ``max_slots`` lanes over one per-slot cache
  (``models.model.init_cache(per_slot_pos=True)``: every ``pos`` is an int32
  (B,) tensor on the card, so each row advances at its own depth).  A
  free-list allocator with double-allocation and double-free guards; a freed
  lane keeps decoding masked-out garbage until an admission overwrites it.
* **Admission** into freed slots by ``(-priority, [deadline,] arrival,
  rid)``, pure FIFO without priorities or deadlines.  Prompts are grouped by
  exact length and prefilled on a fresh int-pos cache, padded to the engine
  batch, then copied into their lanes by :func:`insert_rows`.
* **Chunked prefill** (``prefill_chunk_tokens``): a longer prompt is
  admitted at once but prefilled over several steps on a private int-pos
  side cache (``Engine.prefill_chunk``), at most ``prefill_chunk_tokens``
  prefill tokens a step over all lanes; the finished side cache is copied
  into the lane, which then decodes.
* **Preemption** (``preempt_policy``): a queued request that strictly beats
  an active lane (higher priority, or deadline-aware a strictly earlier
  deadline) evicts it.  The lane's rows are zeroed, its emitted tokens are
  parked and it is requeued; its resume prefills ``prompt ++
  emitted[:-1]``, which restores the cache its next decode step needs, so
  its tokens are those of the uninterrupted run.  At most one preemption a
  step and ``max_preemptions`` a request keep it livelock-free.
* **Admission control**: ``max_queue`` sheds an arrival that would overflow
  the queue (reason ``queue_full``); ``deadline_aware`` sheds a queued
  request whose deadline even an admission this step could not meet
  (``deadline_unmeetable``).  Preempted requests are never shed.
* **Decode**: one ``Engine.decode_token`` over the whole slot cache a step.

Time is virtual: arrivals are in scheduler steps, so a seeded
:func:`synthetic_workload` replays exactly, and ``deadline_ms`` maps onto
steps through ``step_time_ms``.

Sampling (``temperature > 0``) follows the reference's key chains: each
lane carries its own key, ``PRNGKey(seed)`` at admission, kept across
preemption and resume; the lane's first token is drawn with that key, and
each decode step splits it and draws with the second half, so a streamed
request samples the tokens of its solo ``generate``.

Divergences from the reference, each for a reason: a step draws its tokens
on the device and copies ``(max_slots,)`` token ids to the host, the
``(max_slots, V)`` logits only under ``collect_logits`` (greedy: the
argmax, the same token as the reference's numpy argmax, both taking the
first maximum); a sampled step draws every lane at once, one ``(L, V)``
draw with a key per row (``prng.categorical_rows``), where the reference
draws one ``(1, V)`` categorical per lane: bit for bit the same draws,
since a row's counters depend only on its place in ``(1, V)``; the cache
is lists of per-layer dicts per segment (plus ``shared_attn``), which
:func:`insert_rows` and the eviction walk, copying rows into the
preallocated tensors in place; a request's ``ttft_s`` starts when it is
submitted, or, submitted ahead of its arrival step, when that step takes
it in, so it holds the queue wait and the prefill (the reference starts a
grouped admission's after its prefill).

Robustness and metrics, the reference's: the ``sched.slot_free``,
``sched.preempt`` and ``sched.evict_rows`` fault seams each count their
``*_fault`` counter and mark the request degraded, and the bookkeeping
completes regardless (the lane is freed exactly once, the victim
requeued, its rows zeroed), so no lane leaks.  A request whose prefill,
chunk or decode step the engine degraded (``Engine._run_step``) completes
with ``CompletedRequest.degraded`` and counts in the engine's
``degraded_requests`` and ``serve.degraded_request``.  The stream runs in a
``serve.stream`` span; sheds count ``sched.shed.<reason>``; each completion
records ``serve.request_ttft_s`` (the ``ttft_s`` above),
``serve.request_tpot_s`` and ``sched.ttft_steps``, each admission
``sched.queue_wait_steps``, and each step sets the ``sched.slot_occupancy``
and ``sched.queue_depth`` gauges.  Every prefill counts its request rows
in ``sched.prefill_rows`` and the rows padding it to the engine batch in
``sched.prefill_rows_padded``.

The host's share of the loop, always on: each step records ``sched.host_s``,
its wall less the time inside the engine's ``prefill``, ``prefill_chunk``
and ``decode_token``; each first token records, at the end of the step
that made it, ``sched.first_token_s`` (submit to that end, the span a
client's TTFT covers), ``sched.first_token_behind_s`` (submit to the start
of the request's own prefill) and ``sched.first_token_prefill_s`` (that
prefill, chunks summed).  With tracing on or a ``torch.profiler``
recording, ``sched.step`` spans each step, over ``sched.admit`` (one an
admission group, carrying its ``rids``: the group's ``serve.prefill``,
then ``sched.insert_rows``), ``sched.prefill_chunks``, ``sched.decode``
(over ``serve.decode``) and ``sched.readback`` (the copy of the tokens to
the host); with tracing on, each request is a ``sched.request`` span from
submit to completion (``Tracer.record_span``), carrying its ``rid``, the
seconds it queued, waited behind others, prefilled, was held after its
prefill and decoded, and its preemptions.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import model as model_mod
from repro_torch.testing import faults

from . import prng

PREEMPT_POLICIES = ("longest_remaining", "lowest_priority")


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request of a stream.  ``arrival`` is in scheduler
    steps; ``tokens`` the (S,) prompt; higher ``priority`` wins admission
    and preemption; ``deadline_ms`` is a completion deadline after arrival
    (None: best effort)."""
    rid: int
    tokens: np.ndarray
    n_new: int
    arrival: int = 0
    priority: int = 0
    deadline_ms: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.tokens).shape[-1])


@dataclasses.dataclass
class CompletedRequest:
    """A served request's tokens and latency accounting."""
    rid: int
    tokens: np.ndarray                      # (n_new,) generated tokens
    arrival: int
    admitted_step: int
    done_step: int
    queue_wait_steps: int                   # admitted_step - arrival
    ttft_s: float                           # submit -> first token (wall)
    tpot_s: float                           # mean inter-token wall time
    degraded: bool = False                  # a step ran off the planned route
    logits: Optional[np.ndarray] = None     # (n_new, V) fp32 when collected
    preemptions: int = 0                    # times evicted and resumed
    ttft_steps: int = 0                     # arrival -> first token (steps)
    queue_s: float = 0.0                    # submit -> its own prefill (wall)


@dataclasses.dataclass(frozen=True)
class ShedRequest:
    """A request refused by admission control, with its reason
    (``queue_full`` or ``deadline_unmeetable``); it never held a slot."""
    rid: int
    arrival: int
    shed_step: int
    reason: str
    prompt_len: int
    n_new: int


class SlotManager:
    """Free-list allocator over ``n`` decode lanes; a double allocation or a
    double free raises at once."""

    def __init__(self, n: int):
        if n <= 0:
            raise ValueError(f"max_slots must be positive, got {n}")
        self.n = n
        self._free: List[int] = list(range(n - 1, -1, -1))  # pop() -> slot 0
        self.owner: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> int:
        return self.n - len(self._free)

    def alloc(self, rid: int) -> int:
        if not self._free:
            raise RuntimeError("slot allocation with no free slots")
        slot = self._free.pop()
        if slot in self.owner:
            raise RuntimeError(
                f"slot {slot} double-allocated (owned by request "
                f"{self.owner[slot]}, requested by {rid})")
        self.owner[slot] = rid
        return slot

    def free(self, slot: int) -> None:
        if slot not in self.owner:
            raise RuntimeError(f"slot {slot} double-freed (no owner)")
        del self.owner[slot]
        self._free.append(slot)


def synthetic_workload(n_requests: int, *, seed: int = 0,
                       prompt_lens: Sequence[int] = (4, 8),
                       new_tokens: Sequence[int] = (2, 4),
                       arrival_rate: float = 0.5,
                       vocab: int = 100,
                       prompt_len_weights: Optional[Sequence[float]] = None,
                       deadlines_ms: Optional[Sequence] = None,
                       priorities: Optional[Sequence[int]] = None
                       ) -> List[Request]:
    """A seeded request trace, the reference's draw for draw.

    ``arrival_rate < 1``: geometric gaps of mean ``1/rate - 1`` steps;
    ``> 1``: Bernoulli gaps of mean ``1/rate`` (about ``rate`` arrivals a
    step, the overload regime).  Prompt and completion lengths come from the
    given sets (``prompt_len_weights`` skews the prompt lengths);
    ``deadlines_ms`` and ``priorities`` draw each request's deadline (None
    entries: best effort) and priority after the base draws, so a trace
    without them is unchanged."""
    if arrival_rate <= 0.0:
        raise ValueError(f"arrival_rate must be positive, got {arrival_rate}")
    if prompt_len_weights is not None \
            and len(prompt_len_weights) != len(prompt_lens):
        raise ValueError("prompt_len_weights must match prompt_lens")
    rng = np.random.default_rng(seed)
    reqs, t = [], 0
    for rid in range(n_requests):
        if rid and arrival_rate < 1.0:
            t += int(rng.geometric(arrival_rate)) - 1
        elif rid and arrival_rate > 1.0:
            t += int(rng.random() < 1.0 / arrival_rate)
        if prompt_len_weights is None:
            plen = int(rng.choice(prompt_lens))
        else:
            plen = int(rng.choice(prompt_lens,
                                  p=np.asarray(prompt_len_weights, float)
                                  / float(np.sum(prompt_len_weights))))
        tokens = rng.integers(0, vocab, size=plen, dtype=np.int32)
        n_new = int(rng.choice(new_tokens))
        deadline = None
        if deadlines_ms is not None:
            pick = deadlines_ms[int(rng.integers(len(deadlines_ms)))]
            deadline = None if pick is None else float(pick)
        priority = 0
        if priorities is not None:
            priority = int(priorities[int(rng.integers(len(priorities)))])
        reqs.append(Request(rid=rid, tokens=tokens, n_new=n_new, arrival=t,
                            priority=priority, deadline_ms=deadline))
    return reqs


def _layers(cache: Dict) -> List[Dict]:
    """Every per-layer cache dict: each segment's list, then
    ``shared_attn``'s."""
    return [layer for seg in cache.values() for layer in seg]


def insert_rows(big_cache: Dict, small_cache: Dict, slots: Sequence[int],
                n_rows: int) -> Dict:
    """Copy the first ``n_rows`` rows of ``small_cache`` (an int-pos prefill
    cache, possibly padded past ``n_rows``) into lanes ``slots`` of the
    per-slot ``big_cache``, in place; each lane's ``pos`` becomes the small
    cache's.  Returns ``big_cache``."""
    big_layers, small_layers = _layers(big_cache), _layers(small_cache)
    if len(big_layers) != len(small_layers):
        raise ValueError("insert_rows: the caches have different layers")
    idx = None
    for big, small in zip(big_layers, small_layers):
        for key, leaf in big.items():
            if idx is None:
                idx = torch.as_tensor(list(slots), dtype=torch.long,
                                      device=leaf.device)
            if key == "pos":
                leaf[idx] = small["pos"]
            else:
                leaf[idx] = small[key][:n_rows].to(leaf.dtype)
    return big_cache


@dataclasses.dataclass
class _Lane:
    """In-flight state of one slot."""
    req: Request
    key: prng.Key = (0, 0)          # the request's own PRNG chain
    cur: int = 0                    # last token: the next decode input
    emitted: List[int] = dataclasses.field(default_factory=list)
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)
    admitted_step: int = 0
    # perf_counter stamps and seconds of the request's wait (module doc)
    submit_wall: float = 0.0
    admit_wall: float = 0.0
    prefill_wall: float = 0.0       # its own prefill's first start
    prefill_s: float = 0.0          # its own prefill, chunks summed
    first_tok_wall: float = 0.0
    first_tok_step: int = -1
    preemptions: int = 0
    degraded: bool = False
    # chunked prefill: tokens still being written into the private side
    # cache; the lane holds its slot but does not decode until the side
    # cache is complete and copied in
    prefilling: bool = False
    prefill_toks: Optional[np.ndarray] = None
    prefill_done: int = 0
    side: Any = None


@dataclasses.dataclass
class _QueueItem:
    """A queued request: fresh, or a preempted lane parked for resume
    (``resume`` carries its emitted tokens and accounting)."""
    req: Request
    resume: Optional[_Lane] = None
    submit_wall: float = 0.0


class Scheduler:
    """The continuous-batching step loop, built by ``Engine.serve_stream``
    (or directly, to drive steps one at a time).

    ``step_hook(snapshot)`` runs after every step with ``step, occupancy,
    free, queue, pending, active, admitted, completed, shed, preempted,
    prefilling``, the reference's snapshot."""

    def __init__(self, engine, *, max_slots: Optional[int] = None,
                 collect_logits: bool = False,
                 step_hook: Optional[Callable[[Dict[str, Any]], None]] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 preempt_policy: Optional[str] = None,
                 max_queue: Optional[int] = None,
                 deadline_aware: bool = False,
                 step_time_ms: float = 1.0,
                 max_preemptions: int = 2):
        cfg = engine.cfg
        if cfg.family == "encdec":
            raise ValueError(
                "continuous batching is not supported for the encdec "
                "family (cross-attention caches are per-request)")
        if preempt_policy is not None and \
                preempt_policy not in PREEMPT_POLICIES:
            raise ValueError(
                f"preempt_policy must be one of {PREEMPT_POLICIES}, "
                f"got {preempt_policy!r}")
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if step_time_ms <= 0.0:
            raise ValueError("step_time_ms must be positive")
        self.engine = engine
        self.max_slots = int(max_slots or engine.scfg.batch)
        self.collect_logits = collect_logits
        self.step_hook = step_hook
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.preempt_policy = preempt_policy
        self.max_queue = max_queue
        self.deadline_aware = deadline_aware
        self.step_time_ms = float(step_time_ms)
        self.max_preemptions = int(max_preemptions)
        self.slots = SlotManager(self.max_slots)
        self.cache = model_mod.init_cache(
            cfg, self.max_slots, engine.scfg.max_len, engine.cache_dtype,
            engine.device, per_slot_pos=True)
        # a fresh int-pos side cache for one chunk-prefilling lane
        self._side_factory = lambda: model_mod.init_cache(
            cfg, 1, engine.scfg.max_len, engine.cache_dtype, engine.device)
        self.active: Dict[int, _Lane] = {}
        self.queue: List[_QueueItem] = []
        self.pending: List[Request] = []
        self.completed: Dict[int, CompletedRequest] = {}
        self.shed: Dict[int, ShedRequest] = {}
        self.preempt_count = 0
        self.step = 0
        self._total = 0
        # submit stamps of requests not yet arrived (None: submitted ahead
        # of their arrival step, stamped when it takes them in)
        self._submitted: Dict[int, Optional[float]] = {}
        # this step's seconds inside engine calls, and its first tokens
        self._engine_s = 0.0
        self._firsts: List[_Lane] = []

    # ------------------------------------------------------------ helpers --
    def _prefill_tokens(self, it: _QueueItem) -> np.ndarray:
        """What admission prefills: the prompt, and for a preempted resume
        every emitted token but the last (the cache then holds what the
        uninterrupted run's held before its next decode step, at the same
        pos; the last emitted token is the next decode input)."""
        base = np.asarray(it.req.tokens, np.int64).reshape(-1)
        if it.resume is not None and it.resume.emitted:
            return np.concatenate(
                [base, np.asarray(it.resume.emitted[:-1], np.int64)])
        return base

    def _lane_for(self, it: _QueueItem) -> _Lane:
        if it.resume is not None:
            return it.resume
        return _Lane(req=it.req, key=prng.PRNGKey(self.engine.scfg.seed),
                     submit_wall=it.submit_wall)

    def _engine_call(self, fn, *args):
        """``fn(*args)``, an engine step, with its start stamp and wall
        seconds; the seconds count as engine time of this step."""
        t = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t
        self._engine_s += dt
        return out, t, dt

    @staticmethod
    def _prefilled(lane: _Lane, start: float, seconds: float) -> None:
        """Account one prefill call of the lane's own."""
        if not lane.prefill_wall:
            lane.prefill_wall = start
        lane.prefill_s += seconds

    def _qkey(self, it: _QueueItem):
        r = it.req
        if self.deadline_aware:
            ds = self._deadline_step(r)
            return (-r.priority, float("inf") if ds is None else ds,
                    r.arrival, r.rid)
        return (-r.priority, r.arrival, r.rid)

    def _enqueue(self, it: _QueueItem) -> None:
        keys = [self._qkey(x) for x in self.queue]
        self.queue.insert(bisect.bisect_right(keys, self._qkey(it)), it)

    def _deadline_step(self, r: Request) -> Optional[int]:
        """Absolute deadline in scheduler steps, or None (best effort)."""
        if r.deadline_ms is None:
            return None
        return r.arrival + int(np.ceil(r.deadline_ms / self.step_time_ms))

    def _chunks_for(self, n_tokens: int) -> int:
        c = self.prefill_chunk_tokens
        if c is None or n_tokens <= c:
            return 1
        return -(-n_tokens // c)

    def _min_done_step(self, it: _QueueItem) -> int:
        """The earliest completion step of an admission this step: its
        prefill chunks (the last also gives the first token), then a decode
        step per remaining token."""
        chunks = self._chunks_for(len(self._prefill_tokens(it)))
        done = len(it.resume.emitted) if it.resume is not None else 0
        rem = max(it.req.n_new - done, 1)
        return self.step + chunks + rem - 2

    def _remaining_work(self, lane: _Lane) -> int:
        """Decode tokens still to emit plus prefill tokens still to write
        (the preemption victim's measure)."""
        rem = lane.req.n_new - len(lane.emitted)
        if lane.prefilling:
            rem += len(lane.prefill_toks) - lane.prefill_done
        return rem

    def _shed_request(self, it: _QueueItem, reason: str) -> None:
        r = it.req
        self.shed[r.rid] = ShedRequest(
            rid=r.rid, arrival=r.arrival, shed_step=self.step,
            reason=reason, prompt_len=r.prompt_len, n_new=r.n_new)
        obs.count("sched.shed", reason=reason)
        # counters carry no attrs into the snapshot, so the reason-named
        # counter is a metric of its own
        obs.count(f"sched.shed.{reason}")

    def _finish(self, slot: int, lane: _Lane) -> None:
        """Complete the lane's request and free its slot.  A fault at the
        ``sched.slot_free`` site marks the request degraded; the slot is
        freed regardless, so a lane never leaks."""
        try:
            faults.check("sched.slot_free", slot=slot, rid=lane.req.rid)
        except Exception as e:  # noqa: BLE001 — serving must not die
            obs.count("sched.slot_free_fault", reason=type(e).__name__)
            lane.degraded = True
        self.slots.free(slot)
        del self.active[slot]
        now = time.perf_counter()
        r = lane.req
        n = len(lane.emitted)
        tpot = ((now - lane.first_tok_wall) / (n - 1)) if n > 1 else 0.0
        if lane.degraded:
            self.engine.degraded_requests += 1
            obs.count("serve.degraded_request")
        ttft_steps = lane.first_tok_step - r.arrival
        ttft = lane.first_tok_wall - lane.submit_wall
        queue_s = lane.prefill_wall - lane.submit_wall
        tr = obs.get_tracer()
        if tr.enabled:
            tr.record_span(
                "sched.request", int(lane.submit_wall * 1e9),
                int(now * 1e9), cat="sched", rid=r.rid,
                queue_s=lane.admit_wall - lane.submit_wall,
                behind_s=queue_s, prefill_s=lane.prefill_s,
                held_s=ttft - queue_s - lane.prefill_s,
                decode_s=now - lane.first_tok_wall,
                preemptions=lane.preemptions)
        obs.observe("serve.request_ttft_s", ttft)
        obs.observe("serve.request_tpot_s", tpot)
        obs.observe("sched.ttft_steps", float(ttft_steps))
        obs.count("serve.stream_tokens", n)
        self.completed[r.rid] = CompletedRequest(
            rid=r.rid, tokens=np.asarray(lane.emitted, np.int32),
            arrival=r.arrival, admitted_step=lane.admitted_step,
            done_step=self.step,
            queue_wait_steps=lane.admitted_step - r.arrival,
            ttft_s=ttft, tpot_s=tpot, degraded=lane.degraded,
            logits=(np.stack(lane.logits).astype(np.float32)
                    if self.collect_logits else None),
            preemptions=lane.preemptions, ttft_steps=ttft_steps,
            queue_s=queue_s)

    def _first_token(self, slot: int, lane: _Lane, tok: int,
                     row: Optional[np.ndarray]) -> None:
        """The lane's prefill is done: take its first token (a fresh
        admission) or restore the parked decode input (a resume, whose
        prefill logits predict a token already emitted)."""
        if lane.emitted:
            lane.cur = lane.emitted[-1]
            return
        lane.emitted.append(tok)
        lane.cur = tok
        lane.first_tok_wall = time.perf_counter()
        lane.first_tok_step = self.step
        self._firsts.append(lane)
        if self.collect_logits:
            lane.logits.append(row)
        obs.observe("sched.queue_wait_steps",
                    lane.admitted_step - lane.req.arrival)
        if lane.req.n_new <= 1:
            self._finish(slot, lane)

    def _host_rows(self, logits: torch.Tensor, keys):
        """Tokens of (B, V) logits drawn on their device, row ``i`` with
        ``keys[i]`` (the greedy argmax at temperature 0), and the fp32 rows
        on the host only under ``collect_logits``."""
        temp = self.engine.scfg.temperature
        with obs.span("sched.readback", cat="sched"):
            if temp <= 0.0:
                toks = logits.argmax(dim=-1).tolist()
            else:
                toks = prng.categorical_rows(
                    keys, prng.scaled(logits, temp)).tolist()
            rows = (logits.float().cpu().numpy() if self.collect_logits
                    else [None] * len(toks))
        return toks, rows

    # ---------------------------------------------------------- admission --
    def _admit(self, admitted: List[_QueueItem]) -> None:
        """This step's admissions: a grouped whole-prompt prefill for those
        within the chunk budget, a slot and a side cache for the rest (their
        chunks start this same step, in ``_advance_chunks``)."""
        eng = self.engine
        budget = self.prefill_chunk_tokens
        admit_wall = time.perf_counter()
        direct: List[_QueueItem] = []
        for it in admitted:
            n_tok = len(self._prefill_tokens(it))
            if budget is not None and n_tok > budget:
                slot = self.slots.alloc(it.req.rid)
                lane = self._lane_for(it)
                if it.resume is None:
                    lane.admitted_step = self.step
                    lane.admit_wall = admit_wall
                lane.prefilling = True
                lane.prefill_toks = self._prefill_tokens(it)
                lane.prefill_done = 0
                lane.side = self._side_factory()
                self.active[slot] = lane
            else:
                direct.append(it)
        groups: Dict[int, List[_QueueItem]] = {}
        for it in direct:
            groups.setdefault(len(self._prefill_tokens(it)), []).append(it)
        for grp in groups.values():
            with obs.span("sched.admit", cat="sched",
                          rids=[it.req.rid for it in grp]):
                self._admit_group(grp, admit_wall)

    def _admit_group(self, grp: List[_QueueItem], admit_wall: float) -> None:
        """One grouped whole-prompt prefill, its rows copied into fresh
        lanes and its first tokens taken."""
        eng = self.engine
        toks = np.stack([self._prefill_tokens(it) for it in grp])
        g = len(grp)
        # pad the prefill to the engine batch, the warm plan bucket
        # (rows are independent; the padding rows are dropped at insert)
        pad_to = max(eng.scfg.batch, g)
        if pad_to > g:
            toks = np.concatenate(
                [toks, np.repeat(toks[-1:], pad_to - g, axis=0)])
        obs.count("sched.prefill_rows", g)
        obs.count("sched.prefill_rows_padded", pad_to - g)
        eng._req_degraded = False
        (small, last), start, secs = self._engine_call(
            eng.prefill, torch.from_numpy(toks))
        degraded = eng._req_degraded
        slot_ids = [self.slots.alloc(it.req.rid) for it in grp]
        with obs.span("sched.insert_rows", cat="sched"):
            insert_rows(self.cache, small, slot_ids, g)
        lanes = [self._lane_for(it) for it in grp]
        # a fresh lane's first token is drawn with its key itself; a
        # resume's draw is discarded (its token was emitted already)
        first, rows = self._host_rows(last[:g], [ln.key for ln in lanes])
        for i, (it, slot) in enumerate(zip(grp, slot_ids)):
            lane = lanes[i]
            if it.resume is None:
                lane.admitted_step = self.step
                lane.admit_wall = admit_wall
            self._prefilled(lane, start, secs)
            lane.degraded = lane.degraded or degraded
            self.active[slot] = lane
            self._first_token(slot, lane, first[i], rows[i])

    def _advance_chunks(self) -> None:
        """Advance chunk-prefilling lanes, oldest admission first, within
        the step's ``prefill_chunk_tokens`` budget.  A chunk is always
        ``min(budget, remaining)`` and a younger lane never overtakes an
        older one."""
        budget = self.prefill_chunk_tokens
        lanes = sorted(
            ((s, ln) for s, ln in self.active.items() if ln.prefilling),
            key=lambda sl: (sl[1].admitted_step, sl[0]))
        eng = self.engine
        left = budget
        for slot, lane in lanes:
            total = len(lane.prefill_toks)
            take = min(budget, total - lane.prefill_done)
            if take > left:
                break
            left -= take
            seg = lane.prefill_toks[lane.prefill_done:
                                    lane.prefill_done + take]
            eng._req_degraded = False
            obs.count("sched.prefill_rows")
            (lane.side, last), start, secs = self._engine_call(
                eng.prefill_chunk, lane.side, torch.from_numpy(seg[None]))
            self._prefilled(lane, start, secs)
            lane.degraded = lane.degraded or eng._req_degraded
            lane.prefill_done += take
            obs.count("sched.prefill_chunk")
            if lane.prefill_done == total:
                with obs.span("sched.insert_rows", cat="sched"):
                    insert_rows(self.cache, lane.side, [slot], 1)
                lane.side = None
                lane.prefilling = False
                lane.prefill_toks = None
                first, rows = self._host_rows(last, [lane.key])
                self._first_token(slot, lane, first[0], rows[0])

    # --------------------------------------------------------- preemption --
    def _maybe_preempt(self) -> List[int]:
        """At most one preemption a step: with no free slot, evict the
        policy's victim among the lanes the queue head strictly beats
        (higher priority, or deadline-aware an earlier deadline at equal
        priority), each lane at most ``max_preemptions`` times."""
        if (self.preempt_policy is None or not self.queue
                or self.slots.free_count > 0):
            return []
        c = self.queue[0].req
        cd = self._deadline_step(c)
        victims: List[tuple] = []
        for slot, lane in self.active.items():
            v = lane.req
            if lane.preemptions >= self.max_preemptions:
                continue
            vd = self._deadline_step(v)
            beats = v.priority < c.priority or (
                self.deadline_aware and v.priority == c.priority
                and cd is not None and (vd is None or cd < vd))
            if beats:
                victims.append((slot, lane))
        if not victims:
            return []
        if self.preempt_policy == "lowest_priority":
            slot, lane = min(
                victims,
                key=lambda sl: (sl[1].req.priority,
                                -self._remaining_work(sl[1]), sl[0]))
        else:  # longest_remaining
            slot, lane = max(
                victims,
                key=lambda sl: (self._remaining_work(sl[1]), -sl[0]))
        self._preempt(slot, lane)
        return [lane.req.rid]

    def _preempt(self, slot: int, lane: _Lane) -> None:
        """Evict a lane: zero its rows (``pos`` included) in every cache
        leaf, free its slot, park its state and requeue it for resume.
        Both fault sites mark the request degraded and the bookkeeping
        completes regardless: the slot is freed once and the request stays
        in the system."""
        try:
            faults.check("sched.preempt", slot=slot, rid=lane.req.rid)
        except Exception as e:  # noqa: BLE001 — serving must not die
            obs.count("sched.preempt_fault", reason=type(e).__name__)
            lane.degraded = True
        self._evict_rows(slot, lane)
        self.slots.free(slot)
        del self.active[slot]
        lane.prefilling = False
        lane.prefill_toks = None
        lane.prefill_done = 0
        lane.side = None
        lane.preemptions += 1
        self.preempt_count += 1
        obs.count("sched.preempt", policy=self.preempt_policy)
        self._enqueue(_QueueItem(req=lane.req, resume=lane))

    def _evict_rows(self, slot: int, lane: _Lane) -> None:
        """Zero the lane's rows (``pos`` included) across every cache leaf.
        Correctness needs only the ``pos`` reset (a garbage row is never
        read and an admission overwrites it whole); zeroing keeps the cache
        honest for a post-mortem."""
        try:
            faults.check("sched.evict_rows", slot=slot, rid=lane.req.rid)
        except Exception as e:  # noqa: BLE001 — serving must not die
            obs.count("sched.evict_rows_fault", reason=type(e).__name__)
            lane.degraded = True
        for layer in _layers(self.cache):
            for leaf in layer.values():
                leaf[slot].zero_()

    # --------------------------------------------------------------- loop --
    def _decode(self) -> None:
        """One batched decode step over the whole slot cache; prefilling
        and free lanes decode garbage that nothing reads."""
        decodable = {s: ln for s, ln in self.active.items()
                     if not ln.prefilling}
        if not decodable:
            return
        eng = self.engine
        with obs.span("sched.decode", cat="sched"):
            toks = np.zeros((self.max_slots, 1), np.int64)
            for slot, lane in decodable.items():
                toks[slot, 0] = lane.cur
            eng._req_degraded = False
            (logits, self.cache), _, _ = self._engine_call(
                eng.decode_token, self.cache,
                torch.from_numpy(toks).to(eng.device))
        degraded = eng._req_degraded
        # each decodable lane splits its key and draws with the second
        # half; a free or prefilling slot's row is drawn with a key nothing
        # reads
        keys = [(0, 0)] * self.max_slots
        if eng.scfg.temperature > 0.0:
            for slot, lane in decodable.items():
                lane.key, keys[slot] = prng.split(lane.key)
        nxt, rows = self._host_rows(logits[:, -1], keys)
        for slot, lane in list(decodable.items()):
            lane.degraded = lane.degraded or degraded
            lane.emitted.append(nxt[slot])
            if self.collect_logits:
                lane.logits.append(rows[slot])
            if len(lane.emitted) >= lane.req.n_new:
                self._finish(slot, lane)
            else:
                lane.cur = nxt[slot]

    def submit(self, requests: Sequence[Request]) -> None:
        max_len = self.engine.scfg.max_len
        for r in requests:
            if r.prompt_len + r.n_new > max_len:
                raise ValueError(
                    f"request {r.rid}: prompt_len {r.prompt_len} + n_new "
                    f"{r.n_new} exceeds max_len {max_len}")
            if r.n_new < 1:
                raise ValueError(f"request {r.rid}: n_new must be >= 1")
        now = time.perf_counter()
        for r in requests:
            self._submitted[r.rid] = now if r.arrival <= self.step else None
        self.pending.extend(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        self._total += len(requests)

    def run_step(self) -> None:
        """One scheduler step: arrivals -> shed sweep -> preemption ->
        admission -> prefill chunks -> batched decode; then the step's
        host time and its first tokens' samples (module doc)."""
        t0 = time.perf_counter()
        self._engine_s, self._firsts = 0.0, []
        with obs.span("sched.step", cat="sched", step=self.step):
            self._run_step(t0)
        end = time.perf_counter()
        obs.observe("sched.host_s", end - t0 - self._engine_s)
        for lane in self._firsts:
            obs.observe("sched.first_token_s", end - lane.submit_wall)
            obs.observe("sched.first_token_behind_s",
                        lane.prefill_wall - lane.submit_wall)
            obs.observe("sched.first_token_prefill_s", lane.prefill_s)

    def _run_step(self, t0: float) -> None:
        while self.pending and self.pending[0].arrival <= self.step:
            r = self.pending.pop(0)
            wall = self._submitted.pop(r.rid, None)
            it = _QueueItem(req=r, submit_wall=t0 if wall is None else wall)
            if self.max_queue is not None \
                    and len(self.queue) >= self.max_queue:
                self._shed_request(it, "queue_full")
            else:
                self._enqueue(it)
        if self.deadline_aware:
            # a queued request whose deadline an admission this step could
            # not meet is shed; preempted requests were admitted, and stay
            keep: List[_QueueItem] = []
            for it in self.queue:
                ds = self._deadline_step(it.req)
                if it.resume is None and ds is not None \
                        and self._min_done_step(it) > ds:
                    self._shed_request(it, "deadline_unmeetable")
                else:
                    keep.append(it)
            self.queue = keep
        preempted = self._maybe_preempt()
        admitted: List[_QueueItem] = []
        while self.queue and len(admitted) < self.slots.free_count:
            # always the queue head: nothing overtakes a better-ranked
            # request into a slot
            admitted.append(self.queue.pop(0))
        if admitted:
            self._admit(admitted)
        if self.prefill_chunk_tokens is not None:
            with obs.span("sched.prefill_chunks", cat="sched"):
                self._advance_chunks()
        self._decode()
        obs.gauge("sched.slot_occupancy", self.slots.occupancy)
        obs.gauge("sched.queue_depth", len(self.queue))
        # conservation: every submitted request is exactly one of
        # not-yet-arrived / queued / in flight / completed / shed
        accounted = (len(self.pending) + len(self.queue) + len(self.active)
                     + len(self.completed) + len(self.shed))
        if accounted != self._total:
            raise RuntimeError(
                f"request conservation violated at step {self.step}: "
                f"{accounted} accounted vs {self._total} submitted")
        if self.step_hook is not None:
            self.step_hook({
                "step": self.step,
                "occupancy": self.slots.occupancy,
                "free": self.slots.free_count,
                "queue": [it.req.rid for it in self.queue],
                "pending": len(self.pending),
                "active": {s: ln.req.rid for s, ln in self.active.items()},
                "admitted": [it.req.rid for it in admitted],
                "completed": len(self.completed),
                "shed": len(self.shed),
                "preempted": preempted,
                "prefilling": sorted(s for s, ln in self.active.items()
                                     if ln.prefilling),
            })
        self.step += 1

    def run(self, requests: Sequence[Request]) -> List[CompletedRequest]:
        self.submit(requests)
        if not self.pending:
            return []
        # stall guard: every step makes progress, so the steps are bounded
        # by the arrivals' span plus each request's decode steps and prefill
        # chunks (a preempted one repays its prefill up to max_preemptions
        # more times)
        reqs = self.pending
        work = sum(
            r.n_new
            + self._chunks_for(r.prompt_len + r.n_new)
            * (1 + (self.max_preemptions
                    if self.preempt_policy is not None else 0))
            for r in reqs)
        bound = (max(r.arrival for r in reqs) + work
                 + len(reqs) + self.max_slots + 8)
        with obs.span("serve.stream", cat="serve", requests=self._total,
                      max_slots=self.max_slots) as sp:
            while self.pending or self.queue or self.active:
                if self.step > bound:
                    raise RuntimeError(
                        f"scheduler stalled: step {self.step} exceeded "
                        f"bound {bound} with {len(self.completed)}/"
                        f"{self._total} completed")
                self.run_step()
            sp.set(steps=self.step, completed=len(self.completed),
                   shed=len(self.shed), preemptions=self.preempt_count)
        return [self.completed[rid] for rid in sorted(self.completed)]
