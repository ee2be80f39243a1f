"""Span tracer: nested wall-clock spans + instant events, exportable as
Chrome-trace JSON (Perfetto-loadable); the port of ``repro.obs.trace``,
with a hook into ``torch.profiler`` and request spans beside it.

The tracer is the *where-does-the-time-go* half of ``repro_torch.obs``:
every layer that does time-shaped work (pipeline passes, compiles,
autotune measurement, plan-registry compiles, engine warmup / prefill /
decode, the scheduler's step phases) brackets it in a span, so one
``Engine.generate()`` call under ``--trace`` yields a complete nested
timeline.

Design constraints:

* **No dependencies** — stdlib only, importable from every layer
  (including :mod:`repro_torch.compiler.cache`); torch is looked up in
  ``sys.modules`` when a span opens, never imported here.
* **Off by default, near-zero cost when off** — ``span()`` returns a
  shared no-op handle after one attribute check and one profiler check.
* **Exception-safe nesting** — a span records on ``__exit__`` even when the
  body raises (the error type lands in its attrs), and the thread-local
  stack is popped in all cases, so an exception can never corrupt the
  parent/depth bookkeeping of later spans.

**The profiler hook.**  While a ``torch.profiler`` is recording
(``torch.autograd._profiler_enabled()``), every span also opens a
``record_function`` range of its name, whether or not tracing is on: the
program's spans then sit in the profiler's Chrome trace as user
annotations, on the kernels' own timeline.

**Request spans.**  ``Tracer.record_span`` records a span that opened
earlier and closed elsewhere (the scheduler's ``sched.request``, from
submit to completion).  Such spans overlap one another, so the Chrome
trace exports each one carrying a ``rid`` as an async event keyed by it.

Timestamps are monotonic (``time.perf_counter_ns``) relative to the
tracer's construction, in microseconds — the unit Chrome-trace wants.
Spans time the host: on the card a span measures the device's work only
where the code inside it synchronizes (the engine's steps do, through
``StepTimer``, whose wait is the ``engine.sync_wait`` span); compile and
registry spans measure host time.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Shared no-op handle returned when tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


def profiling() -> bool:
    """Whether a ``torch.profiler`` is recording in this process (False
    where torch was never imported)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def _range_open(name: str):
    """An entered ``record_function`` range: a user annotation in the
    recording profiler's trace."""
    rf = sys.modules["torch"].autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Range:
    """A span only a recording profiler sees (tracing off): its
    ``record_function`` range, nothing in the tracer."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Range":
        self._rf = _range_open(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        return False

    def set(self, **attrs) -> None:
        pass


class _Span:
    """One live span: context manager that records itself on exit."""

    __slots__ = ("_tracer", "name", "cat", "attrs", "_t0", "_tid", "_depth",
                 "_parent", "_rf")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. the chosen factor)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        tr = self._tracer
        stack = tr._stack()
        self._parent = stack[-1] if stack else None
        self._depth = len(stack)
        self._tid = tr._tid()
        stack.append(self.name)
        self._rf = _range_open(self.name) if profiling() else None
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur_ns = time.perf_counter_ns() - self._t0
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        elif stack:  # defensive: never let a mismatch corrupt later spans
            del stack[self._depth:]
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        tr._record({
            "type": "span", "name": self.name, "cat": self.cat,
            "ts": (self._t0 - tr._epoch) / 1e3, "dur": dur_ns / 1e3,
            "tid": self._tid, "depth": self._depth, "parent": self._parent,
            "args": self.attrs,
        })
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        return False


class Tracer:
    """Span/event recorder with Chrome-trace export.

    ``enabled=False`` (the default for the process-wide tracer) makes
    ``span()``/``instant()`` no-ops; flip with :func:`enable` or construct a
    private enabled instance (tests do).
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._epoch = time.perf_counter_ns()
        self._records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: Dict[int, int] = {}

    # -- internals -----------------------------------------------------------
    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _record(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._records.append(rec)

    # -- recording API -------------------------------------------------------
    def span(self, name: str, cat: str = "", **attrs):
        """Context manager timing one unit of work; nests via a thread-local
        stack.  Disabled, it returns a profiler range while a
        ``torch.profiler`` records, else a shared no-op handle."""
        if self.enabled:
            return _Span(self, name, cat, attrs)
        if profiling():
            return _Range(name)
        return _NULL

    def record_span(self, name: str, start_ns: int, end_ns: int,
                    cat: str = "", **attrs) -> None:
        """Record a span that opened at ``start_ns`` and closed at
        ``end_ns`` (``time.perf_counter_ns``), elsewhere than one ``with``
        block: a request's life across scheduler steps.  A ``rid`` attr
        makes it an async event of that id in the Chrome trace."""
        if not self.enabled:
            return
        self._record({
            "type": "span", "name": name, "cat": cat,
            "ts": (start_ns - self._epoch) / 1e3,
            "dur": (end_ns - start_ns) / 1e3, "tid": self._tid(),
            "depth": 0, "parent": None, "args": attrs,
            "id": attrs.get("rid"),
        })

    def instant(self, name: str, cat: str = "", **attrs) -> None:
        """Point-in-time event (cache hit, fallback, tier decision)."""
        if not self.enabled:
            return
        self._record({
            "type": "event", "name": name, "cat": cat,
            "ts": (time.perf_counter_ns() - self._epoch) / 1e3,
            "tid": self._tid(), "args": attrs,
        })

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    @property
    def records(self) -> List[Dict[str, Any]]:
        """Finished records (spans appear when they close)."""
        with self._lock:
            return list(self._records)

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [r for r in self.records
                if r["type"] == "span" and (name is None or r["name"] == name)]

    # -- export --------------------------------------------------------------
    def chrome_trace(self, metadata: Optional[dict] = None) -> Dict[str, Any]:
        """The Chrome Trace Event JSON object (open at ui.perfetto.dev or
        chrome://tracing).  Spans become complete ``"X"`` events, request
        spans (``record_span`` with a ``rid``) async ``"b"``/``"e"`` pairs
        keyed by the rid, instants ``"i"`` events; ``ts``/``dur`` are
        microseconds."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        for r in self.records:
            ev = {"name": r["name"], "cat": r["cat"] or "repro_torch",
                  "ts": r["ts"], "pid": pid, "tid": r["tid"],
                  "args": dict(r["args"])}
            if r["type"] != "span":
                events.append({**ev, "ph": "i", "s": "t"})
            elif r.get("id") is not None:
                events.append({**ev, "ph": "b", "id": r["id"]})
                events.append({**ev, "ph": "e", "id": r["id"],
                               "ts": r["ts"] + r["dur"], "args": {}})
            else:
                events.append({**ev, "ph": "X", "dur": r["dur"]})
        out = {"traceEvents": events, "displayTimeUnit": "ms"}
        if metadata:
            out["otherData"] = dict(metadata)
        return out

    def write(self, path, metadata: Optional[dict] = None) -> None:
        """Write the Chrome-trace JSON (``default=repr`` keeps arbitrary
        span attrs from breaking the export)."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(metadata), f, default=repr)


# ------------------------------------------------------------ process-wide --
_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-wide tracer (tests); returns the old one."""
    global _TRACER
    old, _TRACER = _TRACER, tracer
    return old


def enable() -> Tracer:
    _TRACER.enabled = True
    return _TRACER


def disable() -> Tracer:
    _TRACER.enabled = False
    return _TRACER


def tracing_enabled() -> bool:
    return _TRACER.enabled


def span(name: str, cat: str = "", **attrs):
    """Span on the process-wide tracer — the one-liner every layer uses::

        with obs.span("compiler.compile", graph=g.name):
            ...
    """
    return _TRACER.span(name, cat, **attrs)


def instant(name: str, cat: str = "", **attrs) -> None:
    _TRACER.instant(name, cat, **attrs)


def write_trace(path, metadata: Optional[dict] = None) -> None:
    _TRACER.write(path, metadata)
