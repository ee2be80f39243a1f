"""``repro_torch.obs`` — the observability spine: tracing, metrics,
profiling; the port of ``repro.obs`` (its own copy: the port imports
nothing of the reference package).

Every layer of the port reports through this package, under the
reference's names:

* the **pass pipeline** emits one span per registered pass
  (``compiler.pass``) under a ``compiler.pipeline`` span;
* **``compiler.compile``** spans each request and counts how it was served
  (``compile.memo_hit`` / ``compile.replay`` / ``compile.measure`` /
  ``compile.build``), and ``compile_degraded`` counts every step down the
  ladder (``degrade.compile``);
* the **compile cache** counts health events (``cache.corrupt``,
  ``cache.stale_env``, ``cache.quarantine``);
* the **hopper backend** counts the per-region emission tiers
  (``emission.tier.*``) and every region kept below ``hopper``
  (``emission.degraded``, with the reason);
* the **plan registry** counts hits / misses / fallbacks per phase and
  measure / replay per plan (``registry.*``) and publishes its stats as a
  snapshot view;
* the **serve engine** wraps warmup / prefill / per-token decode in spans,
  records TTFT and per-step latency histograms, and counts every degraded
  step (``engine.degraded``) and request; the **scheduler** adds its
  gauges, sheds, fault counters and per-request histograms.

On the card the engine's steps end in ``torch.cuda.synchronize()``
(``StepTimer``), so a step span measures the device's work too; the
compile and registry spans measure host time (no sync is added to get
them).  With tracing off a span is one attribute check; nothing counts per
layer or per kernel launch.

Quick use::

    from repro_torch import obs
    obs.enable()                          # tracing (metrics are always on)
    with obs.span("my.step", n=3):
        ...
    obs.count("my.counter")               # counter + trace instant
    obs.observe("my.latency_s", 0.004)    # histogram sample
    obs.write_trace("trace.json")         # open at ui.perfetto.dev
    obs.snapshot()                        # pure-JSON metrics state
"""
from __future__ import annotations

from typing import Any, Dict

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_metrics, format_phases, format_snapshot,
                      set_default_metrics)
from .profile import profile
from .trace import (Tracer, disable, enable, get_tracer, instant, set_tracer,
                    span, tracing_enabled, write_trace)

__all__ = [
    "Tracer", "get_tracer", "set_tracer", "enable", "disable",
    "tracing_enabled", "span", "instant", "write_trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_metrics",
    "set_default_metrics", "format_snapshot", "format_phases",
    "count", "observe", "gauge", "snapshot", "register_view", "profile",
]


def count(name: str, n: int = 1, **attrs) -> None:
    """Increment counter ``name`` and, when tracing, drop an instant event
    with ``attrs`` at the same point."""
    default_metrics().counter(name).inc(n)
    tr = get_tracer()
    if tr.enabled:
        tr.instant(name, **attrs)


def observe(name: str, value: float) -> None:
    """Record one histogram sample (latency, size, ...)."""
    default_metrics().histogram(name).record(value)


def gauge(name: str, value: float) -> None:
    """Set gauge ``name`` to ``value``."""
    default_metrics().gauge(name).set(value)


def snapshot(include_views: bool = True) -> Dict[str, Any]:
    """Process-wide metrics snapshot (pure JSON — see MetricsRegistry)."""
    return default_metrics().snapshot(include_views=include_views)


def register_view(name: str, fn) -> None:
    """Publish an existing stats object into every future snapshot."""
    default_metrics().register_view(name, fn)
