"""Verified plan artifact: the tuner's output, the replica's warm start,
the port of ``repro.tune.artifact``.

One JSON file, written atomically (mkstemp+rename), schema-versioned::

    {"schema": 1, "env": "torch-2.x|cuda-12.x|NVIDIA H100 ...|region-...",
     "created": 1723...,
     "complete": false,                       # partial-result salvage
     "entries":  {<key>: <plan dict, as stored in CompileCache>},
     "manifest": {<key>: {"kernel": ..., "sha256": ..., "env": ...,
                          "device": "NVIDIA H100 80GB HBM3" | "cpu",
                          "factor": ..., "timings_us": {...},
                          "members": [<spec>, ...]}},
     "missing":  [<key>, ...]}                # enumerated but unmeasured

The manifest is the verification surface: each entry carries the sha256 of
its canonical-JSON plan, the toolchain fingerprint that measured it
(``compiler.cache._env_fingerprint``: torch, CUDA, the card and the region
kernel's source) and the device its candidates were timed on, so a replica
verifies per entry: one bitrotted or stale plan is quarantined and
re-measured locally while every other entry still loads with zero
measurements (:meth:`repro_torch.compiler.registry.PlanRegistry.
preload_artifact`).

The device is the port's addition.  The fingerprint names the card
whenever CUDA is present, whatever device did the timing, so a plan timed
on the host of a machine with a card carries the card's fingerprint; a
plan timed on another kind of device than the replica serves on is
``stale``.

Partial-result salvage: :func:`publish` never demands completeness — a
fleet killed at 60% publishes the measured 60% (``complete: false``, the
unmeasured keys under ``missing``, counted ``artifact.salvaged``), and
replicas re-measure only the gap.

Fault sites: ``artifact.load`` (read/parse — raising and text-mangling
rules both fire there) and ``artifact.verify`` (per-entry verification).
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from .. import obs
from ..testing import faults

ARTIFACT_SCHEMA = 1


def entry_hash(plan: Dict[str, Any]) -> str:
    """Content hash of one plan entry (canonical JSON, sorted keys)."""
    blob = json.dumps(plan, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()


def _env_fingerprint() -> str:
    from ..compiler.cache import _env_fingerprint
    return _env_fingerprint()


def device_kind(device: Union[str, torch.device, None]) -> Optional[str]:
    """The kind of device a plan was timed on, as the manifest records it:
    ``"cpu"``, or the card's name for a CUDA device (None for None)."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _timed_on(plan: Dict[str, Any]) -> Optional[str]:
    """The device kind of a stored plan's measurement (its autotune
    record's ``device``), or None for a plan that was not measured."""
    dev = (plan.get("autotune") or {}).get("device")
    if not dev:
        return None
    if str(dev).startswith("cuda") and not torch.cuda.is_available():
        return str(dev)         # another machine's card: kept as written
    return device_kind(dev)


def publish(store, groups: Sequence, path: Union[os.PathLike, str],
            *, now: Optional[float] = None) -> Dict[str, Any]:
    """Publish the measured plans for ``groups`` from ``store`` (a
    :class:`~repro_torch.compiler.cache.CompileCache`) to ``path``.

    Salvages partials: groups whose representative was never measured (a
    fleet killed mid-run) are listed under ``missing`` and the artifact is
    stamped ``complete: false``; it is still a valid artifact covering
    everything that was measured.  Returns a summary dict."""
    now = now if now is not None else time.time()
    entries: Dict[str, dict] = {}
    manifest: Dict[str, dict] = {}
    missing: List[str] = []
    for group in groups:
        plan = store.get(group.key) if group.key in store else None
        if not isinstance(plan, dict):
            missing.append(group.key)
            continue
        rep = group.representative
        tuned = plan.get("autotune") or {}
        entries[group.key] = plan
        manifest[group.key] = {
            "kernel": rep.kernel,
            "sha256": entry_hash(plan),
            "env": plan.get("env"),
            "device": _timed_on(plan),
            "factor": plan.get("factor"),
            "timings_us": tuned.get("timings_us", {}),
            "members": [dict(item.spec) for item in group.items],
        }
    complete = not missing
    doc = {"schema": ARTIFACT_SCHEMA, "env": _env_fingerprint(),
           "created": now, "complete": complete, "entries": entries,
           "manifest": manifest, "missing": missing}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name,
                               suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    if not complete:
        obs.count("artifact.salvaged", len(missing), path=str(path))
    obs.count("artifact.published", path=str(path),
              entries=len(entries), complete=str(complete))
    return {"path": str(path), "entries": len(entries),
            "missing": len(missing), "complete": complete}


def load(path: Union[os.PathLike, str]) -> Dict[str, Any]:
    """Read and parse an artifact.  Raises ``ValueError`` / ``OSError`` on
    a missing, torn, corrupt or wrong-schema file; the caller owns the
    degrade (a replica falls back to full local measurement)."""
    path = Path(path)
    faults.check("artifact.load", path=str(path))
    with open(path) as f:
        text = f.read()
    text = faults.mangle("artifact.load", text, path=str(path))
    doc = json.loads(text)
    if not isinstance(doc, dict):
        raise ValueError(f"artifact {path}: not a JSON object")
    schema = doc.get("schema")
    if schema != ARTIFACT_SCHEMA:
        raise ValueError(f"artifact {path}: schema {schema!r} "
                         f"(expected {ARTIFACT_SCHEMA})")
    if not isinstance(doc.get("entries"), dict) \
            or not isinstance(doc.get("manifest"), dict):
        raise ValueError(f"artifact {path}: missing entries/manifest")
    return doc


def verify_entry(key: str, plan: Any, manifest_entry: Any,
                 *, env: Optional[str] = None,
                 device: Optional[str] = None) -> Optional[str]:
    """Per-entry verification: returns the rejection reason or None.

    ``corrupt`` (hash mismatch against the manifest), ``stale`` (measured
    under another toolchain fingerprint than this process's, or timed on
    another kind of device than ``device``, the replica's
    :func:`device_kind`), ``missing`` (no manifest row for the entry),
    ``invalid`` (not a replayable plan dict)."""
    faults.check("artifact.verify", key=key)
    if not isinstance(manifest_entry, dict):
        return "missing"
    if not isinstance(plan, dict):
        return "invalid"
    try:
        int(plan["factor"])
    except (KeyError, TypeError, ValueError):
        return "invalid"
    if entry_hash(plan) != manifest_entry.get("sha256"):
        return "corrupt"
    env = env if env is not None else _env_fingerprint()
    if plan.get("env") not in (None, env):
        return "stale"
    timed = manifest_entry.get("device")
    if device is not None and timed is not None and timed != device:
        return "stale"
    return None


__all__ = ["ARTIFACT_SCHEMA", "entry_hash", "device_kind", "publish", "load",
           "verify_entry"]
