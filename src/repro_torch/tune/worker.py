"""Tuner worker: claim shards, measure representatives, survive being shot,
the port of ``repro.tune.worker``.

A worker is a loop over the lease ledger::

    claim shard -> for each group: take the card lock -> heartbeat ->
    measure the representative -> release -> ... -> complete shard ->
    claim next -> ... until the ledger has nothing claimable

Measurements run through a private :class:`PlanRegistry` backed by the
shared :class:`CompileCache` store, with the ``hopper`` backend on the
worker's ``device`` (default the card), under the ``max_factor`` the
serving registry's warmup passes for the request: the path a replica's
warmup takes, so results persist under the key the replica looks up, with
merge-on-write cross-process safety.  Re-measuring a reclaimed shard is
idempotent: keys the dead worker finished replay, only the unmeasured rest
pays.

**One card, one measurement at a time** (the port's addition).  Every
worker on a machine shares its one card, and a timing run beside another
worker's would time the contention.  So each measurement holds an
``fcntl`` lock on a per-device file in the work directory
(:class:`CardLock`).  A worker waiting for it keeps heartbeating its shard
about every ``ttl / 3``, so two workers whose measurements outlast the TTL
do not reclaim each other's shards; once it holds the lock it heartbeats
once more and abandons the shard if the lease was lost.  The ledger still
orders the shards and still reclaims a dead worker's shard (the kernel
frees a dead process's ``flock``).

Failure handling: a lost heartbeat abandons the shard (the new owner has
it), a ledger I/O fault (``tune.lease`` injection, a flaky filesystem)
retries after a backoff, and a failed measurement records the key as
failed but keeps the shard going: one unplannable bucket must not wedge
the fleet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import time
from pathlib import Path
from typing import Dict, List, Tuple, Union

import torch

try:
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX: lockless best effort
    fcntl = None

from .. import device as device_mod
from .. import obs
from ..compiler.cache import CompileCache
from ..compiler.registry import PlanRegistry

from . import grid as grid_mod
from .lease import LeaseLedger


@dataclasses.dataclass
class WorkerReport:
    worker: str
    shards_done: List[str] = dataclasses.field(default_factory=list)
    shards_lost: List[str] = dataclasses.field(default_factory=list)
    measured: int = 0
    replayed: int = 0
    failed: Dict[str, str] = dataclasses.field(default_factory=dict)
    lease_errors: int = 0
    # the port's: wall seconds spent waiting for the card lock, and each
    # measurement's (start, end) on the host clock while holding it
    lock_wait_s: float = 0.0
    intervals: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class CardLock:
    """An exclusive ``fcntl`` lock on one device, held by one measurement
    at a time across every worker process sharing ``lock_dir``.  ``poll``
    runs between tries while the lock is held elsewhere and may return
    False to give up the wait."""

    def __init__(self, lock_dir: Union[os.PathLike, str],
                 device: torch.device):
        name = re.sub(r"[^A-Za-z0-9_.-]", "_", str(device))
        self.path = Path(lock_dir) / f"card-{name}.lock"

    @contextlib.contextmanager
    def hold(self, poll=None, every_s: float = 0.05):
        """Yields ``(acquired, waited_s)``.  Without ``fcntl`` (non-POSIX)
        or a writable directory it yields at once, unlocked."""
        t0 = time.perf_counter()
        lockf = None
        if fcntl is not None:
            try:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                lockf = open(self.path, "w")
            except OSError:
                lockf = None
        if lockf is None:
            yield True, 0.0
            return
        try:
            while True:
                try:
                    fcntl.flock(lockf, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    break
                except BlockingIOError:
                    if poll is not None and not poll():
                        yield False, time.perf_counter() - t0
                        return
                    time.sleep(every_s)
            try:
                yield True, time.perf_counter() - t0
            finally:
                with contextlib.suppress(OSError):
                    fcntl.flock(lockf, fcntl.LOCK_UN)
        finally:
            lockf.close()


class TunerWorker:
    """One fleet member.  ``shards`` is the shard -> [WorkGroup] map every
    worker derives from the config (:func:`repro_torch.tune.grid.
    shard_groups`); the card lock lives beside the ledger."""

    def __init__(self, worker_id: str, ledger: LeaseLedger,
                 store: CompileCache,
                 shards: Dict[str, List[grid_mod.WorkGroup]], *,
                 backend: str = "hopper", device=None,
                 claim_retries: int = 3, retry_sleep_s: float = 0.05,
                 measure_hook=None):
        if backend != "hopper":
            raise ValueError(f"the port's plans compile for the 'hopper' "
                             f"backend, not {backend!r}")
        self.worker_id = worker_id
        self.ledger = ledger
        self.store = store
        self.shards = shards
        self.device = device_mod.resolve(device)
        self.card = CardLock(ledger.path.parent, self.device)
        self.claim_retries = claim_retries
        self.retry_sleep_s = retry_sleep_s
        # test seam: called before each measurement, holding the card lock
        # (two-process tests park a worker here to die mid-lease)
        self._measure_hook = measure_hook
        self._reg = PlanRegistry(pump="measure", cache=store,
                                 spot_check="finite")

    # ------------------------------------------------------------------ run --
    def run(self) -> WorkerReport:
        """Drain the ledger: claim and measure until nothing is claimable.
        Ledger faults degrade to bounded retries, never a crash."""
        rep = WorkerReport(worker=self.worker_id)
        with obs.span("tune.worker", cat="tune", worker=self.worker_id):
            while True:
                claimed = self._claim(rep)
                if claimed is None:
                    break
                shard, keys = claimed
                self._run_shard(rep, shard, keys)
        return rep

    def _claim(self, rep: WorkerReport):
        for attempt in range(self.claim_retries):
            try:
                return self.ledger.claim(self.worker_id)
            except Exception as e:  # noqa: BLE001 — ledger fault: retry
                rep.lease_errors += 1
                obs.count("tune.lease_error", worker=self.worker_id,
                          op="claim", error=type(e).__name__)
                if attempt + 1 < self.claim_retries:
                    time.sleep(self.retry_sleep_s)
        return None

    def _heartbeat(self, rep: WorkerReport, shard: str) -> bool:
        try:
            return self.ledger.heartbeat(self.worker_id, shard)
        except Exception as e:  # noqa: BLE001 — ledger fault ≠ lost lease:
            # the lease may still be ours on disk; keep measuring (results
            # are idempotent either way) and let complete() arbitrate
            rep.lease_errors += 1
            obs.count("tune.lease_error", worker=self.worker_id,
                      op="heartbeat", error=type(e).__name__)
            return True

    def _run_shard(self, rep: WorkerReport, shard: str,
                   keys: List[str]) -> None:
        groups = {g.key: g for g in self.shards.get(shard, [])}
        with obs.span("tune.shard", cat="tune", shard=shard,
                      worker=self.worker_id, keys=len(keys)) as sp:
            for key in keys:
                group = groups.get(key)
                if group is None:     # ledger/grid drift: count, skip
                    obs.count("tune.unknown_key", shard=shard, key=key)
                    continue
                if not self._measure_locked(rep, shard, group):
                    rep.shards_lost.append(shard)
                    sp.set(lost=True)
                    return            # reclaimed: the new owner has it
            try:
                done = self.ledger.complete(self.worker_id, shard)
            except Exception as e:  # noqa: BLE001 — ledger fault on the
                # final write: the measurements are safely in the store;
                # the shard stays leased and expires back to the pool,
                # where the next claim replays it for free
                rep.lease_errors += 1
                obs.count("tune.lease_error", worker=self.worker_id,
                          op="complete", error=type(e).__name__)
                done = False
            if done:
                rep.shards_done.append(shard)
            else:
                rep.shards_lost.append(shard)
            sp.set(done=done)

    def _measure_locked(self, rep: WorkerReport, shard: str,
                        group: grid_mod.WorkGroup) -> bool:
        """Take the card lock (heartbeating about every ``ttl / 3`` while
        waiting), heartbeat, measure, release.  False when the lease was
        lost, before or while waiting."""
        lost = []
        every = max(self.ledger.ttl_s / 3.0, 1e-3)
        last = [time.perf_counter()]

        def poll() -> bool:
            if time.perf_counter() - last[0] >= every:
                last[0] = time.perf_counter()
                if not self._heartbeat(rep, shard):
                    lost.append(True)
                    return False
            return True

        with self.card.hold(poll, every_s=min(0.05, every / 4)) \
                as (held, waited):
            rep.lock_wait_s += waited
            if waited > 0.001:
                obs.observe("tune.lock_wait_s", waited)
            if not held or lost or not self._heartbeat(rep, shard):
                return False
            t0 = time.time()
            self._measure(rep, group)
            rep.intervals.append((t0, time.time()))
        return True

    def _measure(self, rep: WorkerReport, group: grid_mod.WorkGroup) -> None:
        """Measure one group representative through the registry's
        measured-autotune path; the result lands in the shared store under
        the group's key (every member replays it)."""
        item = group.representative
        if self._measure_hook is not None:
            self._measure_hook(item)
        try:
            kern = self._reg.kernel(item.kernel, item.args,
                                    item.builder_kwargs(),
                                    device=self.device,
                                    max_factor=item.max_factor)
        except Exception as e:  # noqa: BLE001 — one bad bucket ≠ dead fleet
            rep.failed[group.key] = repr(e)
            obs.count("tune.measure_failed", kernel=item.kernel,
                      error=type(e).__name__)
            return
        tuned = kern.report.autotune or {}
        if tuned and not tuned.get("replayed"):
            rep.measured += 1
        else:
            rep.replayed += 1


def run_fleet(cfg, batch: int, max_len: int, *, ledger_path, store_path,
              out_path=None, dtype=None, cache_dtype="float32",
              n_shards: int = 4, worker_id: str = "worker-0",
              ttl_s: float = 30.0, backend: str = "hopper", device=None,
              measure_hook=None) -> Dict:
    """One worker's end-to-end tuner pass: derive the grid, register the
    shards, drain the ledger, and (when ``out_path`` is given) publish the
    artifact; publishing is salvage-aware, so a partly tuned ledger still
    yields a usable artifact.  Each worker publishes what its store has
    seen (its own plans and those merged in at each of its writes), so the
    last worker to finish publishes the whole grid."""
    from . import artifact as artifact_mod
    groups = grid_mod.enumerate_work(cfg, batch, max_len, dtype=dtype,
                                     cache_dtype=cache_dtype)
    shards = grid_mod.shard_groups(groups, n_shards)
    ledger = LeaseLedger(ledger_path, ttl_s=ttl_s)
    for attempt in range(3):
        try:
            ledger.init_shards(grid_mod.shard_keys(shards))
            break
        except Exception as e:  # noqa: BLE001 — ledger fault: bounded retry;
            # even a dead ledger only costs parallelism (claim yields None
            # and publish still salvages whatever the store holds)
            obs.count("tune.lease_error", worker=worker_id, op="init",
                      error=type(e).__name__)
            time.sleep(0.05)
    store = CompileCache(store_path)
    worker = TunerWorker(worker_id, ledger, store, shards, backend=backend,
                         device=device, measure_hook=measure_hook)
    t0 = time.perf_counter()
    rep = worker.run()
    out = {"worker": rep.as_dict(), "ledger": ledger.states(),
           "groups": len(groups),
           "work_items": sum(len(g.items) for g in groups),
           "device": str(worker.device),
           "wall_s": time.perf_counter() - t0}
    if out_path is not None:
        out["artifact"] = artifact_mod.publish(store, groups, out_path)
    return out


__all__ = ["CardLock", "TunerWorker", "WorkerReport", "run_fleet"]
