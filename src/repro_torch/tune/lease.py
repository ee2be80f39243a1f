"""File-backed lease ledger: crash-tolerant work partitioning for the tuner,
the port of ``repro.tune.lease``.

One JSON file (schema-versioned, written atomically via mkstemp+rename,
mutated only under an ``fcntl`` lock on a ``.lock`` sibling — the exact
self-healing store idioms of :class:`repro_torch.compiler.cache.CompileCache`)
holds one row per shard::

    {"version": 1,
     "shards": {"shard-0": {"state": "pending" | "leased" | "done",
                            "owner": "worker-a", "heartbeat": 1723...,
                            "expires": 1723..., "keys": [...],
                            "attempts": 2}}}

Lease semantics (the reference's docs/robustness.md, "Artifact lifecycle"):

* **Claim** — a worker atomically flips a ``pending`` shard to ``leased``
  under its id, stamping a heartbeat and an expiry ``ttl_s`` in the future.
* **Heartbeat** — the owner re-stamps expiry between measurements; a
  heartbeat (or completion) by a worker that no longer owns the shard is
  rejected, which is what makes double-publish impossible after a reclaim.
* **Reclaim** — a lease whose expiry has passed is claimable by any worker
  (``tune.lease_reclaimed``): a worker SIGKILLed mid-measurement loses
  nothing but its own wall time — the shard returns to the pool and the
  survivor re-measures it (measurements are idempotent: they land in the
  content-hash-keyed compile cache, so a re-measure of half-done work
  replays the finished half for free).

Every ledger mutation passes the ``tune.lease`` fault-injection site, so a
chaos test can make any claim/heartbeat/complete raise mid-flight; all
ledger I/O failures degrade to "no lease" (the worker retries) rather than
crashing the fleet.

The ledger orders and reclaims shards only.  On one card the workers also
take turns at the card itself, one measurement at a time
(:class:`repro_torch.tune.worker.CardLock`).
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

try:
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX: lockless best effort
    fcntl = None

from .. import obs
from ..testing import faults

LEDGER_SCHEMA = 1


class LeaseLedger:
    """Shared lease state over one JSON file; safe across processes.

    Every operation is a full read-modify-write under the cross-process
    lock — the ledger file is the only authoritative state, so a worker
    process can die at any instruction without corrupting it."""

    def __init__(self, path: os.PathLike | str, *, ttl_s: float = 30.0):
        self.path = Path(path)
        self.ttl_s = float(ttl_s)

    # -- persistence (CompileCache idioms) -----------------------------------
    @contextlib.contextmanager
    def _lock(self):
        if fcntl is None:
            yield
            return
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            lockf = open(self.path.with_suffix(self.path.suffix + ".lock"),
                         "w")
        except OSError:
            yield
            return
        try:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            yield
        finally:
            with contextlib.suppress(OSError):
                fcntl.flock(lockf, fcntl.LOCK_UN)
            lockf.close()

    def _read(self) -> Dict[str, dict]:
        try:
            with open(self.path) as f:
                data = json.loads(f.read())
            shards = data.get("shards", {})
            return {k: dict(v) for k, v in shards.items()
                    if isinstance(v, dict)}
        except FileNotFoundError:
            return {}
        except (OSError, ValueError, AttributeError, TypeError) as e:
            # a torn/corrupt ledger degrades to "empty" — init_shards can
            # rebuild it and nothing measured is lost (results live in the
            # compile cache, not here); the event is counted, never silent
            obs.count("tune.ledger_corrupt", path=str(self.path),
                      error=repr(e))
            return {}

    def _write(self, shards: Dict[str, dict]) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                   prefix=self.path.name, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump({"version": LEDGER_SCHEMA, "shards": shards}, f)
        os.replace(tmp, self.path)

    # -- ledger API ----------------------------------------------------------
    def init_shards(self, shard_keys: Dict[str, List[str]]) -> None:
        """Ensure one row per shard exists.  Idempotent and merge-safe:
        rows already present (any state — another worker may have finished
        them) are kept, so every worker can call this at startup."""
        with self._lock():
            faults.check("tune.lease", op="init", path=str(self.path))
            shards = self._read()
            dirty = False
            for name, keys in shard_keys.items():
                if name not in shards:
                    shards[name] = {"state": "pending", "owner": None,
                                    "heartbeat": None, "expires": None,
                                    "keys": list(keys), "attempts": 0}
                    dirty = True
            if dirty:
                self._write(shards)

    def claim(self, worker: str,
              now: Optional[float] = None) -> Optional[Tuple[str, List[str]]]:
        """Claim one shard for ``worker``: the first ``pending`` row, else
        the first ``leased`` row whose expiry has passed (a dead worker's
        lease — counted ``tune.lease_reclaimed``).  Returns ``(shard,
        keys)`` or None when nothing is claimable."""
        now = now if now is not None else time.time()
        with self._lock():
            faults.check("tune.lease", op="claim", worker=worker)
            shards = self._read()
            for name in sorted(shards):
                row = shards[name]
                state = row.get("state")
                expired = (state == "leased"
                           and now >= (row.get("expires") or 0.0))
                if state != "pending" and not expired:
                    continue
                if expired:
                    obs.count("tune.lease_reclaimed", shard=name,
                              dead_owner=str(row.get("owner")))
                row.update(state="leased", owner=worker, heartbeat=now,
                           expires=now + self.ttl_s,
                           attempts=int(row.get("attempts", 0)) + 1)
                self._write(shards)
                obs.count("tune.lease_claimed", shard=name, worker=worker)
                return name, list(row.get("keys", []))
        return None

    def heartbeat(self, worker: str, shard: str,
                  now: Optional[float] = None) -> bool:
        """Extend ``worker``'s lease on ``shard``; False when the lease was
        lost (reclaimed by another worker after expiry) — the worker must
        abandon the shard instead of racing the new owner."""
        now = now if now is not None else time.time()
        with self._lock():
            faults.check("tune.lease", op="heartbeat", worker=worker)
            shards = self._read()
            row = shards.get(shard)
            if (not isinstance(row, dict) or row.get("state") != "leased"
                    or row.get("owner") != worker):
                obs.count("tune.lease_lost", shard=shard, worker=worker,
                          op="heartbeat")
                return False
            row.update(heartbeat=now, expires=now + self.ttl_s)
            self._write(shards)
            return True

    def complete(self, worker: str, shard: str,
                 now: Optional[float] = None) -> bool:
        """Mark ``shard`` done.  Rejected unless ``worker`` still owns the
        lease — a worker that stalled past its TTL and lost the shard to a
        reclaim cannot double-publish its result row."""
        now = now if now is not None else time.time()
        with self._lock():
            faults.check("tune.lease", op="complete", worker=worker)
            shards = self._read()
            row = shards.get(shard)
            if (not isinstance(row, dict) or row.get("state") != "leased"
                    or row.get("owner") != worker):
                obs.count("tune.lease_lost", shard=shard, worker=worker,
                          op="complete")
                return False
            row.update(state="done", heartbeat=now, expires=None)
            self._write(shards)
            obs.count("tune.shard_done", shard=shard, worker=worker)
            return True

    def release(self, worker: str, shard: str) -> None:
        """Voluntarily return an owned shard to the pool (worker shutdown
        mid-shard); a lost lease releases nothing."""
        with self._lock():
            shards = self._read()
            row = shards.get(shard)
            if (isinstance(row, dict) and row.get("state") == "leased"
                    and row.get("owner") == worker):
                row.update(state="pending", owner=None, heartbeat=None,
                           expires=None)
                self._write(shards)

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        return self._read()

    def states(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for row in self._read().values():
            s = row.get("state", "?")
            out[s] = out.get(s, 0) + 1
        return out

    def all_done(self) -> bool:
        shards = self._read()
        return bool(shards) and all(r.get("state") == "done"
                                    for r in shards.values())

    def done_keys(self) -> List[str]:
        """Content hashes of every completed shard, in shard order."""
        shards = self._read()
        out: List[str] = []
        for name in sorted(shards):
            if shards[name].get("state") == "done":
                out.extend(shards[name].get("keys", []))
        return out


__all__ = ["LeaseLedger", "LEDGER_SCHEMA"]
