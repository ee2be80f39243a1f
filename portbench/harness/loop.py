"""The closed loop over the program's scheduler.

The loop builds nothing of the program's own: it is handed a
``Scheduler`` and submits each client's next request when the client's
last one completes, then drives ``run_step``.  After every step it reads
which tokens reached the host (the lanes' ``emitted`` lists and the
completed requests) and stamps each, the first token as every later one,
with the harness's own clock at the end of the step that produced it:
that is when the client, which runs between steps, receives it (the
step's last act on the device is the copy of its token ids to the host).
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .traffic import Item, Traffic


@dataclass
class Req:
    rid: int
    client: int
    item: Item
    send_t: float
    times: List[float] = field(default_factory=list)
    done_t: Optional[float] = None
    tokens: Optional[list] = None
    prompt: Optional[object] = None

    @property
    def prompt_len(self) -> int:
        return self.item.prompt_len


@dataclass
class Step:
    t0: float
    t1: float
    admitted: int
    occupancy: int
    prefills: List[int] = field(default_factory=list)    # prompt lengths
    decode_keys: List[int] = field(default_factory=list)  # keys a token read
    prefill_s: float = 0.0                                # synced, if timed


class ClosedLoop:
    def __init__(self, sched, traffic: Traffic, request_cls):
        self.sched, self.traffic, self.request_cls = sched, traffic, request_cls
        self.reqs: Dict[int, Req] = {}
        self.seen: Dict[int, int] = {}
        self.steps: List[Step] = []
        self._n_completed = 0
        self._snap: Optional[dict] = None
        self._prefill_s = 0.0
        sched.step_hook = self._hook

    def _hook(self, snap: dict) -> None:
        self._snap = snap

    def add_prefill_time(self, seconds: float) -> None:
        self._prefill_s += seconds

    def send(self, client: int, t: float, first: bool = False) -> None:
        it = self.traffic.first(client) if first else self.traffic.next()
        toks = self.traffic.tokens(it)
        rid = len(self.reqs)
        self.reqs[rid] = Req(rid, client, it, t, prompt=toks)
        self.seen[rid] = 0
        self.sched.submit([self.request_cls(rid=rid, tokens=toks,
                                            n_new=it.n_new,
                                            arrival=self.sched.step)])

    def start(self) -> None:
        t = time.perf_counter()
        for c in range(self.traffic.clients):
            self.send(c, t, first=True)

    def _observe(self, rid: int, emitted, t1: float, rec: Step) -> None:
        r = self.reqs[rid]
        n, prev = len(emitted), self.seen[rid]
        for j in range(prev, n):
            r.times.append(t1)
            if j == 0:
                rec.prefills.append(r.prompt_len)
            else:
                rec.decode_keys.append(r.prompt_len + j)
        self.seen[rid] = n

    def step(self) -> Step:
        self._prefill_s = 0.0
        t0 = time.perf_counter()
        self.sched.run_step()
        t1 = time.perf_counter()
        snap = self._snap or {}
        rec = Step(t0, t1, len(snap.get("admitted", ())),
                   int(snap.get("occupancy", 0)), prefill_s=self._prefill_s)
        for lane in self.sched.active.values():
            self._observe(lane.req.rid, lane.emitted, t1, rec)
        done = list(itertools.islice(self.sched.completed.values(),
                                     self._n_completed, None))
        self._n_completed += len(done)
        for c in done:
            self._observe(c.rid, c.tokens, t1, rec)
            r = self.reqs[c.rid]
            r.done_t, r.tokens = t1, [int(t) for t in c.tokens]
            self.send(r.client, t1)
        self.steps.append(rec)
        return rec

    def run_for(self, seconds: float) -> List[Step]:
        """Steps until ``seconds`` have passed since the first began."""
        out: List[Step] = []
        start = time.perf_counter()
        while True:
            out.append(self.step())
            if out[-1].t1 - start >= seconds:
                return out
