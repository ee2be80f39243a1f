"""Metrics registry: counters, gauges, histograms with percentiles; the
port of ``repro.obs.metrics``, with a time stamp on each histogram sample
(``Histogram.between`` reads the samples of a window).

The *how-often / how-bad* half of ``repro_torch.obs``.  Unlike the tracer,
metrics are **always on** — counting a cache corruption or recording a
decode-step latency costs an attribute lookup and an append, and health
counters (``cache.corrupt``, ``engine.degraded``) must count whether or
not anyone asked for a trace.

The registry absorbs the port's stat surfaces as *views* instead of
re-implementing them: :class:`~repro_torch.compiler.registry.RegistryStats`
and the engine's stats register snapshot callbacks
(:meth:`MetricsRegistry.register_view`), and the percentile math every
stats() consumer needs lives in exactly one place (:class:`Histogram`,
which :class:`~repro_torch.launch.steps.StepTimer` keeps its warm samples
in).  ``snapshot()`` is a pure-JSON dict — it round-trips through
``json``.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

PERCENTILES = (50, 90, 99)


class Counter:
    """Monotonic event counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> int:
        self.value += n
        return self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Value series with nearest-rank percentiles (p50/p90/p99).

    Stores raw samples up to ``max_samples``, each with the
    ``time.perf_counter()`` stamp of its ``record``; past that the series
    is compacted by keeping every other sample with its stamp
    (deterministic — no RNG), while ``count``/``total`` keep exact tallies
    over everything ever recorded.  The serving decode loop records
    thousands of sub-ms floats per run, so the bound exists for
    long-lived processes, not for correctness at benchmark scale.
    """

    __slots__ = ("_values", "_stamps", "count", "total", "min", "max",
                 "max_samples")

    def __init__(self, max_samples: int = 8192):
        self._values: List[float] = []
        self._stamps: List[float] = []
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.max_samples = max_samples

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self._values.append(v)
        self._stamps.append(time.perf_counter())
        if len(self._values) > self.max_samples:
            self._values = self._values[::2]
            self._stamps = self._stamps[::2]

    def between(self, t0: float, t1: float) -> List[float]:
        """The retained samples recorded at ``t0 <= perf_counter() <= t1``
        (the clock a caller's window is measured on)."""
        return [v for v, t in zip(self._values, self._stamps)
                if t0 <= t <= t1]

    @property
    def values(self) -> List[float]:
        return list(self._values)

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile over the retained samples."""
        if not self._values:
            return None
        s = sorted(self._values)
        rank = max(int(round(p / 100.0 * len(s) + 0.5)), 1)
        return s[min(rank, len(s)) - 1]

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "count": self.count, "total": self.total, "mean": self.mean,
            "min": self.min, "max": self.max,
        }
        for p in PERCENTILES:
            out[f"p{p}"] = self.percentile(p)
        return out


class MetricsRegistry:
    """Named metric store + view callbacks, snapshot-exportable as JSON."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._views: Dict[str, Callable[[], Any]] = {}

    # -- metric accessors (create-on-first-use) ------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram())
        return h

    # -- views ---------------------------------------------------------------
    def register_view(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a snapshot callback: ``fn()`` is called (and must return
        a JSON-able value or None) every time :meth:`snapshot` runs.  This is
        how pre-existing stat objects (RegistryStats, StepTimer) join the
        unified snapshot without duplicating their counters here."""
        self._views[name] = fn

    def unregister_view(self, name: str) -> None:
        self._views.pop(name, None)

    # -- export --------------------------------------------------------------
    def snapshot(self, include_views: bool = True) -> Dict[str, Any]:
        """Pure-JSON state dump: ``json.loads(json.dumps(snap)) == snap``."""
        snap: Dict[str, Any] = {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._histograms.items())},
        }
        if include_views:
            views = {}
            for name, fn in sorted(self._views.items()):
                try:
                    v = fn()
                except Exception as e:  # noqa: BLE001 — a dead view must not
                    v = {"error": repr(e)}  # take the snapshot down with it
                if v is not None:
                    views[name] = v
            snap["views"] = views
        # normalize through json so embedding the snapshot in a bench
        # artifact can never fail later (tuples→lists, repr for strays)
        return json.loads(json.dumps(snap, default=repr))

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# -------------------------------------------------------------- formatting --
def _fmt_seconds(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.0f}us"


def _fmt_value(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def format_snapshot(snap: Dict[str, Any], prefix: str = "") -> str:
    """Readable rendering of a :meth:`MetricsRegistry.snapshot` dict."""
    lines: List[str] = []
    counters = snap.get("counters") or {}
    if counters:
        lines.append(f"{prefix}counters:")
        for k, v in counters.items():
            lines.append(f"{prefix}  {k:<40} {v}")
    gauges = {k: v for k, v in (snap.get("gauges") or {}).items()
              if v is not None}
    if gauges:
        lines.append(f"{prefix}gauges:")
        for k, v in gauges.items():
            lines.append(f"{prefix}  {k:<40} {_fmt_value(v)}")
    hists = snap.get("histograms") or {}
    if hists:
        lines.append(f"{prefix}histograms:")
        for k, h in hists.items():
            unit = _fmt_seconds if k.endswith("_s") else _fmt_value
            lines.append(
                f"{prefix}  {k:<40} n={h.get('count', 0)}"
                f" mean={unit(h.get('mean'))} p50={unit(h.get('p50'))}"
                f" p90={unit(h.get('p90'))} p99={unit(h.get('p99'))}"
                f" max={unit(h.get('max'))}")
    for name, view in (snap.get("views") or {}).items():
        lines.append(f"{prefix}{name}: "
                     + json.dumps(view, default=repr, sort_keys=True))
    return "\n".join(lines)


# ------------------------------------------------------------ process-wide --
_METRICS = MetricsRegistry()


def default_metrics() -> MetricsRegistry:
    return _METRICS


def set_default_metrics(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (tests); returns the old one."""
    global _METRICS
    old, _METRICS = _METRICS, reg
    return old
