"""``repro_torch.tune`` — fault-tolerant offline autotuning, the port of
``repro.tune``.

Splits plan tuning from serving: an offline worker fleet measures the
(kernel x bucket x pump-factor) grid once, publishes a verified plan
artifact, and every serving replica warm-starts from it with zero autotune
measurements (``launch.serve --plan-artifact``).

* :mod:`.grid` — enumerate the warmup grid, dedupe by compile-cache key
  (measure one representative per group).
* :mod:`.lease` — file-backed lease ledger: workers claim shards under
  heartbeat-stamped leases; an expired lease (a dead worker) is reclaimed.
* :mod:`.worker` — the claim → lock the card → measure → complete loop.
* :mod:`.artifact` — schema-versioned artifact with a per-entry verified
  manifest; partial-result salvage.

    PYTHONPATH=src python -m repro_torch.launch.tune --arch qwen3-0.6b \\
        --batch 8 --max-len 577 --device cuda
"""
from . import artifact, grid, lease, worker
from .artifact import ARTIFACT_SCHEMA, load, publish, verify_entry
from .grid import WorkGroup, WorkItem, enumerate_work, shard_groups
from .lease import LeaseLedger
from .worker import CardLock, TunerWorker, WorkerReport, run_fleet

__all__ = [
    "artifact", "grid", "lease", "worker",
    "ARTIFACT_SCHEMA", "load", "publish", "verify_entry",
    "WorkGroup", "WorkItem", "enumerate_work", "shard_groups",
    "LeaseLedger", "CardLock", "TunerWorker", "WorkerReport", "run_fleet",
]
