"""Tuning-grid enumeration and content-hash dedupe, the port of
``repro.tune.grid``.

The offline tuner measures exactly the plans a serving replica would warm:
:func:`repro_torch.models.transformer.plan_requests` enumerates the
(kernel x bucket) grid, each request canonicalizes through the
``PlanRegistry`` request builders the serving wrappers use, and the
compile-cache key (:func:`repro_torch.compiler.measure_request_key`) keys
the work.  Two requests with one key are the same measurement: the grid
groups them and the tuner measures one representative per group, whose
result lands in the shared store under the group key, so every member
replays it.

The port's key also carries each request's ``max_factor``, the cap the
registry passes (``registry._max_factor``), and a decode request's cache
dtype (``kv_dtype``), which that cap depends on: both are part of the key
the registry compiles under, so the artifact's keys are the replica's.

Shards partition the groups round-robin; a shard is the unit of lease in
:mod:`.lease` (one worker owns one shard at a time).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import obs


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One (kernel, bucket) measurement request, canonicalized.

    ``args`` / ``kwargs`` are the registry-canonical builder arguments (the
    key the serving wrapper looks the plan up under), ``kv_dtype`` a decode
    request's cache dtype (None elsewhere), ``max_factor`` the registry's
    cap for it and ``key`` the compile-cache key of the measured-autotune
    request."""

    kernel: str
    spec: Tuple[Tuple[str, Any], ...]       # the plan_requests shape kwargs
    args: Tuple
    kwargs: Tuple[Tuple[str, Any], ...]
    key: str
    kv_dtype: Optional[str] = None
    max_factor: int = 16

    def builder_kwargs(self) -> Dict[str, Any]:
        return dict(self.kwargs)


@dataclasses.dataclass(frozen=True)
class WorkGroup:
    """All work items sharing one key: measure ``items[0]`` (the
    representative), and every member is served by the same cache entry."""

    key: str
    items: Tuple[WorkItem, ...]

    @property
    def representative(self) -> WorkItem:
        return self.items[0]


def enumerate_work(cfg, batch: int, max_len: int, *, dtype=None,
                   cache_dtype="float32", policy=None) -> List[WorkGroup]:
    """The deduped tuning grid for one serving shape.

    Deterministic in ``(cfg, batch, max_len, dtype, cache_dtype)``: every
    tuner worker re-derives the same group list from the config, so shards
    are referenced by index across processes.  ``dtype`` is the serving
    dtype (default ``cfg.dtype``) and ``cache_dtype`` the engine's KV cache
    dtype (``ServeConfig.cache_dtype``, default float32): the grid is the
    one ``Engine.warmup`` plans for that engine."""
    from ..compiler import measure_request_key
    from ..compiler.registry import PlanRegistry, _max_factor
    from ..core.autopump import BUILDERS
    from ..models import transformer

    if not getattr(cfg, "fresh_prefill_kernel", True):
        # the Engine's own normalization: its prefill always starts on a
        # fresh cache, so it serves with the flash prefill route on, and
        # the tuner must cover that grid
        cfg = dataclasses.replace(cfg, fresh_prefill_kernel=True)
    if isinstance(cache_dtype, str):
        cache_dtype = getattr(torch, cache_dtype)
    reg = PlanRegistry(policy)          # bucket math only; never compiles
    canon = {"flash_attention": reg.flash_request,
             "ssd_scan": reg.ssd_request,
             "grouped_gemm": reg.grouped_request,
             "decode_attention": reg.decode_request,
             "ssd_decode": reg.ssd_decode_request}
    groups: Dict[str, List[WorkItem]] = {}
    reqs = transformer.plan_requests(cfg, batch, max_len, dtype=dtype,
                                     policy=reg.policy, cached=True,
                                     cache_dtype=cache_dtype)
    for kernel, spec in reqs:
        shape = dict(spec)
        kv_dtype = shape.pop("kv_dtype", None)
        args, kwargs, _pads = canon[kernel](**shape)
        mf = _max_factor(kernel, args, kwargs, kv_dtype)
        g, est = BUILDERS[kernel](*args, **kwargs)
        key = measure_request_key(g, est, max_factor=mf)
        item = WorkItem(kernel=kernel, spec=tuple(sorted(spec.items())),
                        args=tuple(args),
                        kwargs=tuple(sorted(kwargs.items())), key=key,
                        kv_dtype=kv_dtype, max_factor=mf)
        groups.setdefault(key, []).append(item)
    out = [WorkGroup(key=key, items=tuple(items))
           for key, items in groups.items()]
    deduped = sum(len(g.items) - 1 for g in out)
    if deduped:
        obs.count("tune.grid_deduped", deduped)
    obs.count("tune.grid_groups", len(out))
    return out


def shard_groups(groups: List[WorkGroup],
                 n_shards: int) -> Dict[str, List[WorkGroup]]:
    """Round-robin partition of the group list into named shards.  Group
    order is the enumeration order (deterministic), so every worker derives
    the same shard -> groups mapping on its own."""
    n = max(1, min(int(n_shards), len(groups)) if groups else 1)
    shards: Dict[str, List[WorkGroup]] = {f"shard-{i}": [] for i in range(n)}
    for i, group in enumerate(groups):
        shards[f"shard-{i % n}"].append(group)
    return shards


def shard_keys(shards: Dict[str, List[WorkGroup]]) -> Dict[str, List[str]]:
    """The ledger's view: shard name -> group keys."""
    return {name: [g.key for g in groups] for name, groups in shards.items()}


__all__ = ["WorkItem", "WorkGroup", "enumerate_work", "shard_groups",
           "shard_keys"]
