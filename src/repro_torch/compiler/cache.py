"""Persistent compile/autotune cache.

Keyed by a content hash of the *structure* of a graph (nodes, edges, access
patterns, shapes) plus the compile parameters (including the ``autotune``
policy); the stored value is the pipeline *plan*::

    {"factor": 2, "mode": "T", "graph": "matmul",
     "passes": [["streaming", true], ...],
     "autotune": {"policy": "measure", "winner": 2, "backend": "pallas",
                  "timings_us": {"1": ..., "2": ...}}}   # measured runs only

— most importantly the chosen pump factor, so a repeated
``compile``/``autopump`` in a fresh process skips the autotune search,
legality probing, *and* any runtime re-measurement (``autotune='measure'``
replays the stored winner).  Entries live in one JSON file (default
``~/.cache/repro_torch/compile_cache.json``, overridable with
``$REPRO_TORCH_CACHE_DIR`` or an explicit path), written atomically via
rename.  The port never reads or writes the JAX package's cache file.

Compute-node ``fn`` bodies are not part of the structural fingerprint (they
are opaque callables); plans are fn-independent, and the in-memory kernel
memo in :mod:`repro_torch.compiler` additionally keys on the fn code
location.
All I/O failures degrade to cache-off behaviour instead of raising.

Self-healing store semantics:

* **Atomic writes + cross-process locking** — every write is tmp+rename
  (readers never see a torn file) and the read-merge-write cycle holds an
  ``fcntl`` lock on ``<path>.lock``, so two processes warming the same grid
  merge their entries instead of last-writer-wins clobbering.
* **Quarantine with retry budget + exponential backoff** — a plan that
  fails compilation or flunks the registry's differential/finite spot-check
  is recorded under its content-hash key (suffixed with the backend rung):
  each failure doubles the backoff window (``base_s · 2^(fails-1)``, capped
  at ``cap_s`` once ``budget`` failures are spent), and
  :func:`repro_torch.compiler.compile` raises ``PlanQuarantined`` for a
  quarantined rung inside its window (``cache.quarantine_skip``), so the
  hot path stops re-paying a known-bad plan.  A later success clears the
  entry.
* **Fault injection** — the read / parse / write seams are injection sites
  (``cache.load`` / ``cache.json`` / ``cache.save``; see
  :mod:`repro_torch.testing.faults`), and every degrade they trigger is a
  counted health event (``cache.corrupt``).  Entries stamped under another
  toolchain are counted once per load as ``cache.stale_env`` (the
  reference's ``cache.stale_jax_version``: the port's fingerprint is the
  card and the toolchain, ``_env_fingerprint``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

try:
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX: lockless best effort
    fcntl = None

from .. import obs
from ..core.ir import Graph
from ..core.symbolic import AccessPattern, Affine
from ..testing import faults

REGION_KERNEL = Path(__file__).resolve().parent.parent / "csrc" \
    / "region_map_reduce.cu"


def _affine_sig(a: Affine):
    sig = [list(map(list, a.terms)), a.const]
    if a.tables:        # group-indexed lookups are part of the structure
        sig.append([[s, list(t)] for s, t in a.tables])
    return sig


def _access_sig(acc: Optional[AccessPattern]):
    if acc is None:
        return None
    return {
        "dims": [list(d) for d in acc.domain.dims],
        "exprs": [_affine_sig(e) for e in acc.normalized_exprs()],
        "width": acc.width,
    }


_META_KEYS = ("factor", "pump_mode", "keep", "rate", "reduce", "axes")


def _meta_sig(meta: dict) -> list:
    sig = [[k, repr(meta[k])] for k in _META_KEYS if k in meta]
    carry = meta.get("carry")
    if carry is not None:
        # CarrySpec's repr embeds function objects (unstable across
        # processes); its signature() is the stable structural identity
        sig.append(["carry", repr(carry.signature())])
    return sig


def graph_fingerprint(g: Graph) -> str:
    """Deterministic content hash of the graph structure (not fn bodies)."""
    nodes = []
    for name in sorted(g.nodes):
        n = g.nodes[name]
        nodes.append([
            name, n.kind.value, list(n.shape), n.dtype, n.space.value,
            n.elem_width, n.depth, n.vector_width, n.rate.value, n.pump,
            bool(n.data_dependent_io), _meta_sig(n.meta),
        ])
    edges = [[e.src, e.dst, _access_sig(e.access), e.volume] for e in g.edges]
    blob = json.dumps([g.name, nodes, edges], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


_ENV: Optional[str] = None


def _env_fingerprint() -> str:
    """Toolchain identity folded into every request key.  Measured-runtime
    plans (``autotune='measure'``) are only as good as the build that timed
    them, so torch's version, CUDA's version, the device's name and a hash
    of the region kernel's source are part of the key: an upgrade, another
    card or an edited kernel degrades to a cold re-measure instead of a
    stale replay."""
    global _ENV
    if _ENV is None:
        try:
            src = hashlib.sha256(REGION_KERNEL.read_bytes()).hexdigest()[:16]
        except OSError:
            src = "none"
        dev = torch.cuda.get_device_name(0) if torch.cuda.is_available() \
            else "cpu"
        _ENV = (f"torch-{torch.__version__}|cuda-{torch.version.cuda}|"
                f"{dev}|region-{src}")
    return _ENV


def request_key(g: Graph, **params) -> str:
    """Cache key for one compile request: structure hash + parameters +
    toolchain fingerprint."""
    blob = json.dumps([graph_fingerprint(g), _env_fingerprint(),
                       sorted(params.items())],
                      sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()


def _default_path() -> Path:
    root = os.environ.get("REPRO_TORCH_CACHE_DIR")
    if root:
        return Path(root).expanduser() / "compile_cache.json"
    return Path.home() / ".cache" / "repro_torch" / "compile_cache.json"


@dataclasses.dataclass(frozen=True)
class QuarantinePolicy:
    """Backoff schedule for plans that keep failing.

    The n-th recorded failure of a plan key opens a no-retry window of
    ``base_s * 2**(n-1)`` seconds, capped at ``cap_s``; once ``budget``
    failures are spent the window pins at ``cap_s`` (the plan is effectively
    parked until an operator clears it or a success is recorded)."""

    base_s: float = 0.5
    cap_s: float = 300.0
    budget: int = 5

    def window_s(self, fails: int) -> float:
        if fails >= self.budget:
            return self.cap_s
        return min(self.base_s * (2.0 ** max(fails - 1, 0)), self.cap_s)


class CompileCache:
    """JSON-on-disk key→plan store with hit/miss accounting, cross-process
    merge-on-write locking and a quarantine ledger (schema version 2; a
    version-1 file reads as an empty quarantine)."""

    def __init__(self, path: Optional[os.PathLike | str] = None,
                 quarantine: Optional[QuarantinePolicy] = None):
        self.path = Path(path) if path is not None else _default_path()
        self.quarantine_policy = quarantine or QuarantinePolicy()
        self.hits = 0
        self.misses = 0
        self._entries: Optional[Dict[str, dict]] = None
        self._quarantine: Dict[str, dict] = {}
        # keys whose quarantine entries this process cleared; the merge in
        # _save must not resurrect them from a stale on-disk copy
        self._quarantine_cleared: set = set()

    # -- persistence ---------------------------------------------------------
    @contextlib.contextmanager
    def _lock(self):
        """Cross-process write lock on a `.lock` sibling.  Lock failures
        (exotic filesystems, non-POSIX) degrade to the unlocked best-effort
        behaviour — writes stay atomic either way, the lock only closes the
        read-merge-write race between concurrent writers."""
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

    def _read_disk(self):
        """Fresh read of the on-disk store → (entries, quarantine).  All
        failure modes (missing file, torn write, bitrot, IO error) degrade
        to an empty store; corruption is counted."""
        try:
            faults.check("cache.load", path=str(self.path))
            with open(self.path) as f:
                text = f.read()
            text = faults.mangle("cache.json", text, path=str(self.path))
            data = json.loads(text)
            entries = dict(data.get("entries", {}))
            quarantine = dict(data.get("quarantine", {}))
        except FileNotFoundError:
            return {}, {}            # cold store: expected, not a health event
        except (OSError, ValueError, AttributeError, TypeError) as e:
            # truncated/corrupted/wrong-schema JSON: cold-compile path.  The
            # degrade is the contract; the event must still be visible
            obs.count("cache.corrupt", path=str(self.path), error=repr(e))
            return {}, {}
        return entries, quarantine

    def _load(self) -> Dict[str, dict]:
        if self._entries is None:
            self._entries, self._quarantine = self._read_disk()
            if self._entries:
                # entries stamped under another toolchain can never match a
                # current request key (the fingerprint is folded into the
                # key): count them once per load for cache health
                env = _env_fingerprint()
                stale = sum(1 for v in self._entries.values()
                            if isinstance(v, dict)
                            and v.get("env") not in (None, env))
                if stale:
                    obs.count("cache.stale_env", stale,
                              path=str(self.path), env=env)
        return self._entries

    def _save(self, merge: bool = True) -> None:
        try:
            with self._lock():
                entries = self._load()
                quarantine = self._quarantine
                if merge:
                    # re-read under the lock and merge: another process may
                    # have written entries since our load, and plans/ledger
                    # rows are individually valid — union loses nothing
                    disk_entries, disk_quarantine = self._read_disk()
                    entries = {**disk_entries, **entries}
                    quarantine = {**disk_quarantine, **quarantine}
                    for key in self._quarantine_cleared:
                        quarantine.pop(key, None)
                    self._entries, self._quarantine = entries, quarantine
                faults.check("cache.save", path=str(self.path))
                self.path.parent.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                           prefix=self.path.name,
                                           suffix=".tmp")
                with os.fdopen(fd, "w") as f:
                    json.dump({"version": 2, "entries": entries,
                               "quarantine": quarantine}, f)
                os.replace(tmp, self.path)
        except OSError:
            pass  # read-only filesystem etc.: behave as a process-local cache

    # -- store API -----------------------------------------------------------
    def get(self, key: str) -> Optional[dict]:
        entries = self._load()
        entry = entries.get(key)
        if not isinstance(entry, dict):   # absent or corrupted value
            if key in entries:            # present but wrong type: corrupted
                obs.count("cache.corrupt", key=key)
            self.misses += 1
            obs.count("cache.miss")
            return None
        self.hits += 1
        obs.count("cache.hit")
        return dict(entry)

    def put(self, key: str, value: dict) -> None:
        value = dict(value)
        # stamp the toolchain identity so prune() can drop entries orphaned
        # by a toolchain change, and a creation time so it can age them out
        value.setdefault("env", _env_fingerprint())
        value.setdefault("created", time.time())
        self._load()[key] = value
        self._save()

    def put_many(self, values: Dict[str, dict]) -> None:
        """Install a batch of entries under one locked merge-write (the
        artifact preload: N ``put`` calls would pay N read-merge-write
        cycles on the shared file)."""
        if not values:
            return
        entries = self._load()
        now = time.time()
        for key, value in values.items():
            value = dict(value)
            value.setdefault("env", _env_fingerprint())
            value.setdefault("created", now)
            entries[key] = value
        self._save()

    def prune(self, max_age_s: Optional[float] = None,
              now: Optional[float] = None) -> Dict[str, int]:
        """Garbage-collect the persistent store under the fcntl lock.

        Three classes of dead weight accumulate forever without this:
        entries stamped under another toolchain (its identity is folded
        into the request key, so no current request can ever hit them),
        entries older than ``max_age_s`` (when given), and quarantine rows
        whose backoff window has expired (kept by :meth:`quarantined` so
        repeat failures back off harder — but an operator-invoked prune is
        the explicit "forgive history" point).  The whole read-evict-write
        cycle runs inside :meth:`_lock`, so a concurrent writer's fresh
        entries are never lost; evictions are counted via ``obs``
        (``cache.pruned`` per category) and returned."""
        now = now if now is not None else time.time()
        evicted = {"stale_env": 0, "aged": 0, "corrupt": 0, "quarantine": 0}
        env = _env_fingerprint()
        try:
            with self._lock():
                entries, quarantine = self._read_disk()
                keep: Dict[str, dict] = {}
                for key, value in entries.items():
                    if not isinstance(value, dict):
                        evicted["corrupt"] += 1
                    elif value.get("env") not in (None, env):
                        evicted["stale_env"] += 1
                    elif (max_age_s is not None
                          and now - value.get("created", now) > max_age_s):
                        evicted["aged"] += 1
                    else:
                        keep[key] = value
                q_keep: Dict[str, dict] = {}
                for key, value in quarantine.items():
                    if (isinstance(value, dict)
                            and now < value.get("until", 0.0)):
                        q_keep[key] = value
                    else:   # window expired (or row corrupt): GC it
                        evicted["quarantine"] += 1
                if sum(evicted.values()):
                    faults.check("cache.save", path=str(self.path))
                    self.path.parent.mkdir(parents=True, exist_ok=True)
                    fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                               prefix=self.path.name,
                                               suffix=".tmp")
                    with os.fdopen(fd, "w") as f:
                        json.dump({"version": 2, "entries": keep,
                                   "quarantine": q_keep}, f)
                    os.replace(tmp, self.path)
                self._entries, self._quarantine = keep, q_keep
        except OSError:
            return evicted    # read-only store: nothing evicted, no crash
        for kind, n in evicted.items():
            if n:
                obs.count("cache.pruned", n, kind=kind, path=str(self.path))
        return evicted

    # -- quarantine ledger ---------------------------------------------------
    def quarantined(self, key: str, now: Optional[float] = None
                    ) -> Optional[dict]:
        """The quarantine entry for ``key`` if its backoff window is still
        open, else None.  An expired window does not delete the entry — the
        failure count persists so the *next* failure backs off harder."""
        self._load()
        entry = self._quarantine.get(key)
        if not isinstance(entry, dict):
            return None
        if (now if now is not None else time.time()) < entry.get("until", 0.0):
            return dict(entry)
        return None

    def record_failure(self, key: str, reason: str,
                       now: Optional[float] = None) -> dict:
        """Record one failure of ``key``; opens/extends its backoff window
        per the policy and persists the ledger."""
        self._load()
        now = now if now is not None else time.time()
        entry = self._quarantine.get(key)
        fails = (entry.get("fails", 0) if isinstance(entry, dict) else 0) + 1
        window = self.quarantine_policy.window_s(fails)
        entry = {"fails": fails, "until": now + window, "reason": reason,
                 "last": now}
        self._quarantine[key] = entry
        self._quarantine_cleared.discard(key)
        obs.count("cache.quarantine", key=key, reason=reason,
                  fails=str(fails))
        self._save()
        return dict(entry)

    def record_success(self, key: str) -> None:
        """A key that works again leaves quarantine entirely."""
        self._load()
        if self._quarantine.pop(key, None) is not None:
            self._quarantine_cleared.add(key)
            self._save()

    def quarantine_entries(self) -> Dict[str, dict]:
        self._load()
        return {k: dict(v) for k, v in self._quarantine.items()
                if isinstance(v, dict)}

    @property
    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._load()),
                "quarantined": len(self._quarantine)}

    def __len__(self) -> int:
        return len(self._load())

    def __contains__(self, key: str) -> bool:
        """Presence probe that does not count toward hit/miss stats."""
        return key in self._load()


_DEFAULT_CACHES: Dict[str, CompileCache] = {}


def default_cache() -> CompileCache:
    """Process-wide cache instance for the default path (env-sensitive)."""
    path = str(_default_path())
    if path not in _DEFAULT_CACHES:
        _DEFAULT_CACHES[path] = CompileCache(path)
    return _DEFAULT_CACHES[path]


def resolve(cache) -> Optional[CompileCache]:
    """A ``cache=`` argument as the store it names: None the default
    cache, False none, else the given :class:`CompileCache` (tested with
    ``is``: a store with no entries is falsy)."""
    if cache is None:
        return default_cache()
    return None if cache is False else cache
