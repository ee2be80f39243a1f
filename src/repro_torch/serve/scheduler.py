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

Divergences from the reference, each for a reason: only greedy decoding is
ported, so a lane carries no PRNG key and a step takes the argmax on the
device and copies ``(max_slots,)`` token ids to the host (the same token as
the reference's numpy argmax: both take the first maximum), the
``(max_slots, V)`` logits only under ``collect_logits``; the cache is lists
of per-layer dicts per segment (plus ``shared_attn``), which
:func:`insert_rows` and the eviction walk, copying rows into the
preallocated tensors in place; a request's ``ttft_s`` starts at its
admission, before its prefill (the reference starts a grouped admission's
after it, leaving the prefill out).

Robustness and metrics, the reference's: the ``sched.slot_free``,
``sched.preempt`` and ``sched.evict_rows`` fault seams each count their
``*_fault`` counter and mark the request degraded, and the bookkeeping
completes regardless (the lane is freed exactly once, the victim
requeued, its rows zeroed), so no lane leaks.  A request whose prefill,
chunk or decode step the engine degraded (``Engine._run_step``) completes
with ``CompletedRequest.degraded`` and counts in the engine's
``degraded_requests`` and ``serve.degraded_request``.  The stream runs in a
``serve.stream`` span; sheds count ``sched.shed.<reason>``; each completion
records ``serve.request_ttft_s``, ``serve.request_tpot_s`` and
``sched.ttft_steps``, each admission ``sched.queue_wait_steps``, and each
step sets the ``sched.slot_occupancy`` and ``sched.queue_depth`` gauges.
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
    ttft_s: float                           # admission -> first token (wall)
    tpot_s: float                           # mean inter-token wall time
    degraded: bool = False                  # a step ran off the planned route
    logits: Optional[np.ndarray] = None     # (n_new, V) fp32 when collected
    preemptions: int = 0                    # times evicted and resumed
    ttft_steps: int = 0                     # arrival -> first token (steps)


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
    cur: int = 0                    # last token: the next decode input
    emitted: List[int] = dataclasses.field(default_factory=list)
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)
    admitted_step: int = 0
    admit_wall: float = 0.0
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
        if engine.scfg.temperature > 0.0:
            raise NotImplementedError(
                "sampling with temperature > 0 needs the reference's "
                "threefry key chains (ROADMAP.md queue 1, item 4)")
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
        return it.resume if it.resume is not None else _Lane(req=it.req)

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
        obs.observe("serve.request_ttft_s",
                    lane.first_tok_wall - lane.admit_wall)
        obs.observe("serve.request_tpot_s", tpot)
        obs.observe("sched.ttft_steps", float(ttft_steps))
        obs.count("serve.stream_tokens", n)
        self.completed[r.rid] = CompletedRequest(
            rid=r.rid, tokens=np.asarray(lane.emitted, np.int32),
            arrival=r.arrival, admitted_step=lane.admitted_step,
            done_step=self.step,
            queue_wait_steps=lane.admitted_step - r.arrival,
            ttft_s=lane.first_tok_wall - lane.admit_wall, tpot_s=tpot,
            degraded=lane.degraded,
            logits=(np.stack(lane.logits).astype(np.float32)
                    if self.collect_logits else None),
            preemptions=lane.preemptions, ttft_steps=ttft_steps)

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
        if self.collect_logits:
            lane.logits.append(row)
        obs.observe("sched.queue_wait_steps",
                    lane.admitted_step - lane.req.arrival)
        if lane.req.n_new <= 1:
            self._finish(slot, lane)

    def _host_rows(self, logits: torch.Tensor):
        """Greedy tokens of (B, V) logits, argmax on the device, and the
        fp32 rows on the host only under ``collect_logits``."""
        toks = logits.argmax(dim=-1).tolist()
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
        direct: List[_QueueItem] = []
        for it in admitted:
            n_tok = len(self._prefill_tokens(it))
            if budget is not None and n_tok > budget:
                slot = self.slots.alloc(it.req.rid)
                lane = self._lane_for(it)
                if it.resume is None:
                    lane.admitted_step = self.step
                    lane.admit_wall = time.perf_counter()
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
            toks = np.stack([self._prefill_tokens(it) for it in grp])
            g = len(grp)
            # pad the prefill to the engine batch, the warm plan bucket
            # (rows are independent; the padding rows are dropped at insert)
            pad_to = max(eng.scfg.batch, g)
            if pad_to > g:
                toks = np.concatenate(
                    [toks, np.repeat(toks[-1:], pad_to - g, axis=0)])
            now = time.perf_counter()       # TTFT counts the prefill
            eng._req_degraded = False
            small, last = eng.prefill(torch.from_numpy(toks))
            degraded = eng._req_degraded
            slot_ids = [self.slots.alloc(it.req.rid) for it in grp]
            insert_rows(self.cache, small, slot_ids, g)
            first, rows = self._host_rows(last[:g])
            for i, (it, slot) in enumerate(zip(grp, slot_ids)):
                lane = self._lane_for(it)
                if it.resume is None:
                    lane.admitted_step = self.step
                    lane.admit_wall = now
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
            lane.side, last = eng.prefill_chunk(
                lane.side, torch.from_numpy(seg[None]))
            lane.degraded = lane.degraded or eng._req_degraded
            lane.prefill_done += take
            obs.count("sched.prefill_chunk")
            if lane.prefill_done == total:
                insert_rows(self.cache, lane.side, [slot], 1)
                lane.side = None
                lane.prefilling = False
                lane.prefill_toks = None
                first, rows = self._host_rows(last)
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
        toks = np.zeros((self.max_slots, 1), np.int64)
        for slot, lane in decodable.items():
            toks[slot, 0] = lane.cur
        eng = self.engine
        eng._req_degraded = False
        logits, self.cache = eng.decode_token(
            self.cache, torch.from_numpy(toks).to(eng.device))
        degraded = eng._req_degraded
        nxt, rows = self._host_rows(logits[:, -1])
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
        self.pending.extend(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        self._total += len(requests)

    def run_step(self) -> None:
        """One scheduler step: arrivals -> shed sweep -> preemption ->
        admission -> prefill chunks -> batched decode."""
        while self.pending and self.pending[0].arrival <= self.step:
            r = self.pending.pop(0)
            if self.max_queue is not None \
                    and len(self.queue) >= self.max_queue:
                self._shed_request(_QueueItem(req=r), "queue_full")
            else:
                self._enqueue(_QueueItem(req=r))
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
