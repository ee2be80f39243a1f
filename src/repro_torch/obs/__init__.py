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
* the **serve engine** wraps warmup / prefill / per-token decode in spans
  (the step's wait for the card in ``engine.sync_wait``), records TTFT,
  the synced wall and the enqueue of each step (``serve.decode_step_s``,
  ``engine.prefill_s``, ``engine.<phase>_enqueue_s``) and
  ``engine.warmup_s``, and counts every degraded step
  (``engine.degraded``) and request; the **scheduler** adds its step
  phases as spans (``sched.step`` over ``sched.admit``,
  ``sched.insert_rows``, ``sched.prefill_chunks``, ``sched.decode``,
  ``sched.readback``), one ``sched.request`` span a request, its gauges,
  sheds, fault counters, padded-row counters and per-request histograms,
  the host time of each step (``sched.host_s``) and the parts of each
  first token's wait (``sched.first_token_*``);
* **``kernels._build.build_all``** records ``kernels.build_s``.

On the card the engine's steps end in ``torch.cuda.synchronize()``
(``StepTimer``), so a step span measures the device's work too; the
compile and registry spans measure host time (no sync is added to get
them).  With tracing off a span is one attribute check and one profiler
check; nothing counts per layer or per kernel launch.  While a
``torch.profiler`` records, every span is also a ``record_function``
range in its trace, tracing on or off.

Every histogram sample carries its ``time.perf_counter()`` stamp, so
``Histogram.between(t0, t1)`` reads the samples of a window timed on
that clock (the benchmark's readers do).

Quick use::

    from repro_torch import obs
    obs.enable()                          # tracing (metrics are always on)
    with obs.span("my.step", n=3):
        ...
    obs.count("my.counter")               # counter + trace instant
    obs.observe("my.latency_s", 0.004)    # histogram sample
    obs.write_trace("trace.json")         # open at ui.perfetto.dev
    obs.get_tracer().record_span("my.request", t0_ns, t1_ns, rid=7)
    obs.snapshot()                        # pure-JSON metrics state
"""
from __future__ import annotations

from typing import Any, Dict

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_metrics, format_snapshot, set_default_metrics)
from .profile import profile
from .trace import (Tracer, disable, enable, get_tracer, instant, set_tracer,
                    span, tracing_enabled, write_trace)

__all__ = [
    "Tracer", "get_tracer", "set_tracer", "enable", "disable",
    "tracing_enabled", "span", "instant", "write_trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_metrics",
    "set_default_metrics", "format_snapshot",
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
