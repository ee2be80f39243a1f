"""``repro_torch.compiler`` — pass pipeline, lowering backends, persistent
cache: the port of the reference's ``repro.compiler``.

The back half of the paper's §3 workflow: where ``repro_torch.core`` defines
the IR and the two rewrite rules, this package *drives* them as registered
passes (:mod:`.passes`, :mod:`.pipeline`), compiles the transformed graph to
an executable (per-node PyTorch :mod:`.lowering`, or the fused-region
emission of :mod:`.hopper_backend`, whose ``hopper`` tier launches the
hand-written region kernel), and memoizes both the autotune decision and
the compiled kernel across calls and processes (:mod:`.cache`).

    from repro_torch import compiler
    kern = compiler.compile(graph, factor=2, mode="T", backend="hopper")
    out = kern({"x": x, "y": y})          # == repro_torch.core.executor.run(...)
    kern.report.emission                  # per-region tier, grid, why
    kern.report.summary()                 # pass provenance + cache state

``compile`` is served in O(1) for repeated requests: an in-process memo
returns the compiled kernel outright, and the JSON disk cache replays the
pipeline plan (chosen pump factor — including a measured-runtime autotune
winner from ``autotune='measure'``) in fresh processes.

Every request is observable through :mod:`repro_torch.obs`, under the
reference's names: a ``compiler.compile`` span (``compiler.autotune`` and
one ``compiler.autotune.candidate`` under it when measuring) and how it
was served (``compile.memo_hit`` / ``compile.replay`` / ``compile.measure``
/ ``compile.build``).  ``compile.measure`` is a fault-injection site, once
per candidate.  :func:`compile_degraded` walks the cross-backend rungs of
:data:`DEGRADATION_LADDER` instead of raising.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Dict, Optional, Tuple

import torch

from .. import device as device_mod
from .. import obs
from ..core.ir import Graph, NodeKind, PumpSpec
from ..core.pump_plan import SMEM_BYTES, plan_kernel_pump
from .cache import (CompileCache, QuarantinePolicy, default_cache,
                    graph_fingerprint, request_key)
from .cache import resolve as resolve_cache
from .hopper_backend import lower_hopper, partition_regions
from .lowering import CompiledKernel, LoweringError, lower, torch_dtype
from .passes import (PASS_REGISTRY, FifoDepthPass, FusionReport, GraphPass,
                     MultipumpPass, StreamFusionPass, StreamingPass,
                     make_pass, register_pass)
from .pipeline import PassRecord, Pipeline, PipelineReport
from ..testing import faults

BACKENDS = ("torch", "hopper", "reference", "none")

# The degradation ladder, the reference's with the port's rungs.  The first
# three are emission tiers inside the hopper backend: lower_hopper picks per
# region and falls through hopper -> blockloop / carryloop -> gather when a
# region has no hand-written kernel.  The cross-layer rungs are what this
# module and the plan registry own: a hopper-backend failure degrades to the
# per-node PyTorch lowering (compile_degraded), and below that the serving
# engine re-runs a failing step on the plain route (``engine.degraded``).
# Every step down is counted with its reason (``degrade.compile`` /
# ``registry.fallback.*`` / ``engine.degraded``), never silent.
DEGRADATION_LADDER = ("hopper", "blockloop", "gather", "torch", "direct")


class PlanQuarantined(RuntimeError):
    """Raised by :func:`compile` when the request's plan key is inside its
    quarantine backoff window — the caller must take another route instead
    of re-paying a known-bad compile."""

    def __init__(self, msg: str, *, qkey: str = "", entry: dict = None):
        super().__init__(msg)
        self.qkey = qkey
        self.entry = entry or {}


class AutotuneError(RuntimeError):
    """Every autotune candidate failed to build or measure."""

    def __init__(self, msg: str, *, failures: dict = None):
        super().__init__(msg)
        self.failures = failures or {}


# memo value: (kernel, plan) — the plan is re-used to write-through to a
# caller-supplied persistent cache that hasn't seen this request yet
_KERNEL_MEMO: Dict[Tuple, Tuple[CompiledKernel, dict]] = {}
_MEMO_HITS: Dict[Tuple, int] = {}


def clear_memo() -> None:
    """Drop all in-process compiled kernels (test isolation hook)."""
    _KERNEL_MEMO.clear()
    _MEMO_HITS.clear()


def forget(cache_key: str) -> int:
    """Purge every in-process memo entry compiled under ``cache_key`` (all
    backends and devices).  The memo is filled before post-compile
    validation runs, so a kernel that fails the registry's spot check must
    not be memo-served to the retry; validation failures call this."""
    stale = [mk for mk in _KERNEL_MEMO if mk[0] == cache_key]
    for mk in stale:
        _KERNEL_MEMO.pop(mk, None)
        _MEMO_HITS.pop(mk, None)
    return len(stale)


def _cell_sig(value) -> str:
    """Value-identifying signature of one closure cell.  repr() is not
    value-identifying for large arrays (elided middle), so array and tensor
    buffers are hashed.  Everything else falls back to repr: reprs that
    embed the object id (the common case for callables) miss safely across
    rebuilds; a custom object with a value-blind repr could still alias —
    documented limit."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().contiguous().numpy()
    tobytes = getattr(value, "tobytes", None)
    if callable(tobytes):
        h = hashlib.sha256(tobytes()).hexdigest()[:16]
        return f"<array {getattr(value, 'shape', ())} " \
               f"{getattr(value, 'dtype', '?')} {h}>"
    return repr(value)


def _fn_signature(g: Graph) -> Tuple:
    """Behavioral identity of compute bodies — structural fingerprints ignore
    fn objects, so the in-process memo adds this to avoid serving a kernel
    whose graph matches structurally but computes something else.  Covers the
    code location *and* the captured state (closure cells, defaults): two
    instantiations of the same lambda with different captured values must not
    collide.  A repr that isn't value-identifying only causes a safe memo
    miss."""
    sig = []
    for c in sorted(g.computes(), key=lambda n: n.name):
        carry = c.meta.get("carry")
        fns = [("fn", c.fn), ("tile_fn", c.meta.get("tile_fn"))]
        if carry is not None:
            sig.append((c.name, "carry", carry.signature()))
            fns += [("carry_step", carry.step_fn),
                    ("carry_final", carry.final_fn)]
        for label, fn in fns:
            if fn is None:
                sig.append((c.name, label, None))
                continue
            code = getattr(fn, "__code__", None)
            try:
                cells = tuple(
                    _cell_sig(cell.cell_contents)
                    for cell in getattr(fn, "__closure__", None) or ())
            except ValueError:  # unresolved cell: fall back to object id
                cells = (f"<cell id={id(fn)}>",)
            sig.append((c.name, label, getattr(fn, "__module__", ""),
                        getattr(fn, "__qualname__", repr(fn)),
                        getattr(code, "co_firstlineno", -1),
                        repr(getattr(fn, "__defaults__", None)), cells))
    return tuple(sig)


def _estimate_sig(estimate) -> Optional[Tuple]:
    if estimate is None:
        return None
    return (estimate.block_bytes_in, estimate.block_bytes_out,
            estimate.flops_per_block, estimate.fixed_overhead_s,
            estimate.panel_bytes)


def _valid_plan(plan) -> bool:
    """A usable cached plan must at least replay an integer pump factor —
    anything else (truncated write, hand-edited JSON, schema drift) is
    treated as a miss so a corrupted cache degrades to a cold compile
    instead of crashing the build."""
    if not isinstance(plan, dict):
        return False
    try:
        int(plan["factor"])
    except (KeyError, TypeError, ValueError):
        return False
    return True


AUTOTUNE_CANDIDATES = (1, 2, 4, 8)
# relative runtime band within which measured candidates count as tied
AUTOTUNE_TIE_BAND = 0.05
# timed calls per candidate after one warm-up call
AUTOTUNE_REPEATS = 5
# wall-clock budget for measuring ONE autotune candidate (build + repeats).
# A candidate that blows through it keeps whatever timings it banked so far —
# a slow-but-finite candidate still competes; the budget bounds warmup tail
# latency, it does not disqualify.
AUTOTUNE_CANDIDATE_BUDGET_S = 10.0


def _build(graph: Graph, *, factor, mode, smem_budget, max_factor, estimate,
           backend, device) -> CompiledKernel:
    """One pipeline run + lowering (no caching layers)."""
    pipe = Pipeline.default(factor=factor, mode=mode,
                            smem_budget=smem_budget, max_factor=max_factor,
                            estimate=estimate)
    out_graph, report = pipe.run(graph)
    spec = PumpSpec(factor=report.factor, mode=mode, vmem_budget=smem_budget)

    warn = report.warn
    fn = None
    if backend == "torch":
        fn = lower(out_graph, warn=warn, device=device)
    elif backend == "hopper":
        report.emission = {}
        fn = lower_hopper(out_graph, warn=warn, emission=report.emission,
                          device=device)
    elif backend == "reference":
        from ..core import executor

        def fn(inputs, _g=out_graph):
            return executor.run(_g, {k: _host(v) for k, v in inputs.items()})

    return CompiledKernel(graph=out_graph, spec=spec, report=report, fn=fn,
                          backend=backend)


def _host(v):
    """An executor input: tensors come back to the host as numpy."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def _measure_inputs(graph: Graph, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """Synthetic operands for autotune timing: zeros on ``device`` for every
    memory that nothing in the graph writes (the external inputs)."""
    return {n.name: torch.zeros(n.shape, dtype=torch_dtype(n.dtype),
                                device=device)
            for n in graph.nodes.values()
            if n.kind == NodeKind.MEMORY and not graph.in_edges(n.name)}


def _lost_tiers(kern: CompiledKernel, hopper: set) -> str:
    """Why an autotune candidate is no candidate, or ``''``: each region
    that some candidate emitted at the ``hopper`` tier (``hopper``, a set of
    region names) and this one, at another pump, keeps below it (the
    hand-written kernel is not built for that pump), with the reason the
    backend gave."""
    out = []
    for region, em in (kern.report.emission or {}).items():
        if region in hopper and em["tier"] != "hopper":
            why = em["why"][-1] if em["why"] else em["tier"]
            out.append(f"{region} at tier {em['tier']}: {why}")
    return "; ".join(out)


def _time_kernel(fn, inputs, timer, budget_s: Optional[float] = None
                 ) -> float:
    """One candidate's time in µs.  On the card: the median of
    ``AUTOTUNE_REPEATS`` calls timed by the CUDA-event ``Timer`` (L2 flushed
    before each, one warm-up call first).  On the CPU: the best of as many
    host-clock calls.  ``budget_s`` caps the wall clock spent; at least one
    timed call always happens."""
    if timer is not None:
        return timer.ms(lambda: fn(inputs), iters=AUTOTUNE_REPEATS,
                        budget_s=budget_s) * 1e3
    t_start = time.perf_counter()
    fn(inputs)
    best = float("inf")
    for _ in range(AUTOTUNE_REPEATS):
        t0 = time.perf_counter()
        fn(inputs)
        best = min(best, (time.perf_counter() - t0) * 1e6)
        if budget_s is not None and time.perf_counter() - t_start > budget_s:
            obs.count("compile.measure_budget_hit")
            break
    return best


def compile(graph: Graph, *, factor="auto", mode: str = "T",
            smem_budget: int = SMEM_BYTES, max_factor: int = 16,
            estimate=None, backend: str = "torch", autotune=None,
            cache=None, memoize: bool = True,
            device=None) -> CompiledKernel:
    """Run the pass pipeline on ``graph`` and lower the result.

    ``factor`` is an explicit pump factor M (1 = stream-only) or ``'auto'``
    to let the multipump pass autotune it (from ``estimate`` when given,
    under ``smem_budget``, the shared memory of one block).  ``backend`` is
    ``'torch'`` (per-node PyTorch lowering), ``'hopper'`` (fused-region
    emission; see :mod:`.hopper_backend`), ``'reference'`` (numpy executor,
    the differential-testing oracle) or ``'none'`` (plan only).
    ``autotune='measure'`` times the candidate pump factors ``{1, 2, 4, 8}``
    on the lowered executable, on ``device``, and keeps the winner (a
    candidate whose pump keeps a region below the ``hopper`` tier that the
    first candidate reached, its kernel not being built for that pump,
    counts as failed, not timed); the
    measured plan persists in the cache, so a repeat compile replays it
    without re-measuring.  ``device`` (default the card) is where the
    executable puts inputs that are not tensors and where it is measured;
    tensor inputs run on their own device.  ``cache`` is a
    :class:`CompileCache`, ``None`` for the default persistent cache, or
    ``False`` to disable disk caching; ``memoize=False`` also bypasses the
    in-process kernel memo.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if autotune not in (None, "measure"):
        raise ValueError(f"unknown autotune policy {autotune!r}")
    if autotune == "measure" and backend not in ("torch", "hopper"):
        raise ValueError("autotune='measure' needs an executable backend "
                         "('torch' or 'hopper')")
    dev = device_mod.resolve(device) if backend in ("torch", "hopper") \
        else None
    cache = resolve_cache(cache)

    # the plan (chosen factor) is backend-independent, so the backend stays
    # out of the persistent key — autopump's backend='none' plans are reused
    # by executable compiles of the same graph; the memo key adds it because
    # the memoized artifact (the compiled callable) is backend-specific.
    # autotune IS part of the key: a measured winner and a capacity-model
    # guess for the same request must not collide.
    key = request_key(graph, factor=factor, mode=mode,
                      vmem_budget=smem_budget, max_factor=max_factor,
                      estimate=_estimate_sig(estimate), autotune=autotune)
    if cache is not None:
        # quarantine gate: a (plan, backend) pair that recently failed is
        # not retried inside its backoff window
        qkey = f"{key}:{backend}"
        q = cache.quarantined(qkey)
        if q is not None:
            obs.count("cache.quarantine_skip", graph=graph.name,
                      backend=backend, reason=q.get("reason", ""))
            raise PlanQuarantined(
                f"plan {key[:12]}… backend={backend} is quarantined "
                f"({q.get('reason', 'unknown')}, fail #{q.get('fails', 0)}) — "
                f"backoff window open", qkey=qkey, entry=q)
    memo_key = (key, backend, str(dev), _fn_signature(graph))
    if memoize and memo_key in _KERNEL_MEMO:
        kern, plan = _KERNEL_MEMO[memo_key]
        if cache is not None and key not in cache:
            cache.put(key, plan)   # write-through to a fresh persistent cache
        _MEMO_HITS[memo_key] = _MEMO_HITS.get(memo_key, 0) + 1
        obs.count("compile.memo_hit", graph=graph.name, backend=backend)
        # fresh report view per hit: the original compile's provenance
        # record must not be rewritten retroactively
        report = dataclasses.replace(kern.report, served_from="memory",
                                     cache_hits=_MEMO_HITS[memo_key])
        return dataclasses.replace(kern, report=report)
    with obs.span("compiler.compile", cat="compile", graph=graph.name,
                  backend=backend, autotune=autotune or "none",
                  factor=str(factor), mode=mode) as cspan:
        try:
            return _compile_cold(graph, factor=factor, mode=mode,
                                 smem_budget=smem_budget,
                                 max_factor=max_factor, estimate=estimate,
                                 backend=backend, autotune=autotune,
                                 cache=cache, memoize=memoize, key=key,
                                 memo_key=memo_key, device=dev, cspan=cspan)
        except Exception as e:
            # stamp the request identity so a caller can quarantine /
            # forget the exact failing plan without recomputing the key
            try:
                e.compile_cache_key = key
                e.compile_backend = backend
            except Exception:
                pass
            raise


def _compile_cold(graph: Graph, *, factor, mode, smem_budget, max_factor,
                  estimate, backend, autotune, cache, memoize, key, memo_key,
                  device, cspan) -> CompiledKernel:
    """The non-memo-hit path of :func:`compile` (span-bracketed)."""

    def build(f, est=estimate):
        return _build(graph, factor=f, mode=mode, smem_budget=smem_budget,
                      max_factor=max_factor, estimate=est, backend=backend,
                      device=device)

    plan = cache.get(key) if cache is not None else None
    if plan is not None and not _valid_plan(plan):
        obs.count("cache.corrupt", key=key, graph=graph.name)
        plan = None         # corrupted entry: fall back to a cold compile
    measured = 0
    if plan is not None:
        # replay the cached decision: no autotune search, no factor probing,
        # no re-measurement
        obs.count("compile.replay", graph=graph.name, backend=backend,
                  factor=int(plan["factor"]))
        kern = build(int(plan["factor"]), est=None)
        served = "disk"
        if plan.get("autotune"):
            kern.report.autotune = dict(plan["autotune"], replayed=True)
    elif autotune == "measure":
        obs.count("compile.measure", graph=graph.name, backend=backend)
        inputs = _measure_inputs(graph, device)
        timer = None
        if device.type == "cuda":
            from ..launch.timing import Timer
            timer = Timer()
        timings: Dict[int, float] = {}
        kernels: Dict[int, CompiledKernel] = {}
        failures: Dict[int, str] = {}
        # regions some candidate emitted at the hopper tier: a candidate
        # that keeps one of them below it is no candidate (wherever it
        # comes in the order: an injected failure may take the first)
        hopper: set = set()
        with obs.span("compiler.autotune", cat="compile", graph=graph.name,
                      backend=backend) as aspan:
            for cand in AUTOTUNE_CANDIDATES:
                if cand > max_factor:
                    continue
                with obs.span("compiler.autotune.candidate", cat="compile",
                              graph=graph.name, factor=cand) as csp:
                    # one candidate failing (bad lowering at that factor, a
                    # measurement timeout) must not sink the search — the
                    # surviving candidates still yield a valid winner
                    try:
                        faults.check("compile.measure", graph=graph.name,
                                     factor=cand)
                        k = build(cand)
                        achieved = k.spec.factor  # legality may clamp it
                        if achieved in timings:
                            csp.set(achieved=achieved, skipped="duplicate")
                            continue
                        hopper |= {r for r, em
                                   in (k.report.emission or {}).items()
                                   if em["tier"] == "hopper"}
                        lost = _lost_tiers(k, hopper)
                        if lost:
                            # a kernel not built for this pump: the region
                            # would run a PyTorch loop in its place, which
                            # is no candidate for the kernel's pump
                            failures[cand] = lost
                            csp.set(achieved=achieved, skipped="tier")
                            continue
                        t = _time_kernel(k.fn, inputs, timer,
                                         budget_s=AUTOTUNE_CANDIDATE_BUDGET_S)
                        measured += 1
                        kernels[achieved] = k
                        timings[achieved] = t
                        csp.set(achieved=achieved, best_us=round(t, 1))
                    except Exception as e:
                        failures[cand] = repr(e)
                        obs.count("compile.measure_failed", graph=graph.name,
                                  factor=str(cand), error=type(e).__name__)
                        csp.set(failed=type(e).__name__)
            for f in list(timings):
                lost = _lost_tiers(kernels[f], hopper)
                if lost:        # timed before a later candidate reached it
                    failures[f] = lost
                    del timings[f], kernels[f]
            aspan.set(failed_candidates=len(failures))
        del timer, inputs
        if not timings:
            raise AutotuneError(
                f"autotune='measure' on {graph.name!r}: every candidate "
                f"failed — {failures}", failures=failures)
        # statistical ties go to the smallest factor: candidates within the
        # noise band of the best are indistinguishable by measurement
        best_t = min(timings.values())
        winner = min(f for f, t in timings.items()
                     if t <= best_t * (1.0 + AUTOTUNE_TIE_BAND))
        kern = kernels[winner]
        served = None
        kern.report.autotune = {
            "policy": "measure", "winner": winner, "backend": backend,
            "device": str(device),
            "timings_us": {str(f): round(t, 1) for f, t in timings.items()},
            "replayed": False,
        }
        if failures:
            kern.report.autotune["failed"] = {str(f): err for f, err
                                              in failures.items()}
            kern.report.warn(
                f"autotune: {len(failures)} candidate(s) failed "
                f"measurement and were excluded from the search")
    else:
        obs.count("compile.build", graph=graph.name, backend=backend)
        kern = build(factor)
        served = None

    report = kern.report
    report.cache_key = key
    report.served_from = served
    report.cache_hits = 1 if served else 0
    report.measurements = measured
    cspan.set(served=served or "build", achieved_factor=kern.spec.factor)

    if plan is None:
        plan = {"factor": kern.spec.factor, "mode": mode,
                "graph": graph.name,
                "passes": [[r.name, r.applied] for r in report.records]}
        if report.autotune:
            plan["autotune"] = {k: v for k, v in report.autotune.items()
                                if k != "replayed"}
        if cache is not None:
            cache.put(key, plan)
    if memoize:
        _KERNEL_MEMO[memo_key] = (kern, plan)
    return kern


def compile_degraded(graph: Graph, *, backend: str = "hopper",
                     autotune=None, cache=None, **kw) -> CompiledKernel:
    """:func:`compile`, walking the cross-backend rungs of
    :data:`DEGRADATION_LADDER` instead of raising.

    Tries the requested backend first; on failure (or an open quarantine
    window) records the failing rung in the quarantine ledger, counts
    ``degrade.compile`` with the reason, and steps down: hopper → per-node
    PyTorch lowering → the same without measured autotune.  The
    intra-backend tiers (blockloop / carryloop / gather) degrade inside
    :func:`~.hopper_backend.lower_hopper` before any of this triggers.
    Raises only when every rung fails; the serving engine's plain route is
    the rung below this function.
    """
    store = resolve_cache(cache)
    rungs = [(backend, autotune)]
    if backend != "torch":
        rungs.append(("torch", autotune))
    if autotune is not None:
        rungs.append(("torch", None))
    last = None
    degraded_from = None
    for b, at in rungs:
        try:
            kern = compile(graph, backend=b, autotune=at, cache=cache, **kw)
        except PlanQuarantined as e:
            # already quarantined: skip the rung without re-recording it
            last = e
            degraded_from = (b, "quarantined")
            obs.count("degrade.compile", graph=graph.name, frm=b,
                      reason="quarantined")
            continue
        except Exception as e:
            last = e
            reason = type(e).__name__
            degraded_from = (b, reason)
            obs.count("degrade.compile", graph=graph.name, frm=b,
                      reason=reason)
            qkey = getattr(e, "compile_cache_key", None)
            if store is not None and qkey:
                store.record_failure(f"{qkey}:{b}", reason)
            continue
        if degraded_from is not None:
            frm, why = degraded_from
            kern.report.warn(
                f"degraded compile: backend={frm} failed ({why}); "
                f"served by backend={b}"
                + ("" if at == autotune else " without measured autotune"))
        return kern
    raise last


def plan_pump(block_bytes_in: int, block_bytes_out: int,
              flops_per_block: float, mode: str = "T", max_factor: int = 16,
              smem_budget: int = SMEM_BYTES, axis: int = 0,
              panel_bytes: Optional[int] = None, cache=None) -> PumpSpec:
    """Persistently-cached pump-factor planning for the kernel layer.

    Same contract as :func:`repro_torch.core.pump_plan.plan_kernel_pump`,
    but the chosen factor is stored in the compile cache so every process
    after the first skips the capacity-model search.
    """
    cache = resolve_cache(cache)
    key = None
    if cache is not None:
        key = "pump:" + hashlib.sha256(json.dumps(
            [block_bytes_in, block_bytes_out, flops_per_block, mode,
             max_factor, smem_budget, axis, panel_bytes], sort_keys=True
        ).encode()).hexdigest()
        entry = cache.get(key)
        if entry is not None and _valid_plan(entry):
            return PumpSpec(factor=int(entry["factor"]), mode=mode, axis=axis,
                            vmem_budget=smem_budget)
    spec = plan_kernel_pump(block_bytes_in, block_bytes_out, flops_per_block,
                            mode=mode, max_factor=max_factor,
                            smem_budget=smem_budget, axis=axis,
                            panel_bytes=panel_bytes)
    if cache is not None:
        cache.put(key, {"factor": spec.factor})
    return spec


__all__ = [
    "compile", "compile_degraded", "plan_pump", "clear_memo", "forget",
    "BACKENDS", "DEGRADATION_LADDER",
    "AUTOTUNE_CANDIDATES", "AUTOTUNE_CANDIDATE_BUDGET_S", "AUTOTUNE_REPEATS",
    "PlanQuarantined", "AutotuneError",
    "Pipeline", "PipelineReport", "PassRecord",
    "GraphPass", "PASS_REGISTRY", "register_pass", "make_pass",
    "StreamingPass", "StreamFusionPass", "MultipumpPass", "FifoDepthPass",
    "FusionReport",
    "CompileCache", "QuarantinePolicy", "default_cache",
    "graph_fingerprint", "request_key",
    "CompiledKernel", "LoweringError", "lower",
    "lower_hopper", "partition_regions",
]
