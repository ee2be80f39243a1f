"""Span tracer: nested wall-clock spans + instant events, exportable as
Chrome-trace JSON (Perfetto-loadable) or a JSONL event log; the port of
``repro.obs.trace``, line for line.

The tracer is the *where-does-the-time-go* half of ``repro_torch.obs``:
every layer that does time-shaped work (pipeline passes, compiles,
autotune measurement, plan-registry compiles, engine warmup / prefill /
decode) brackets it in a span, so one ``Engine.generate()`` call under
``--trace`` yields a complete nested timeline.

Design constraints:

* **Zero dependencies** — stdlib only, importable from every layer
  (including :mod:`repro_torch.compiler.cache`).
* **Off by default, near-zero cost when off** — ``span()`` returns a
  shared no-op handle after one attribute check.
* **Exception-safe nesting** — a span records on ``__exit__`` even when the
  body raises (the error type lands in its attrs), and the thread-local
  stack is popped in all cases, so an exception can never corrupt the
  parent/depth bookkeeping of later spans.

Timestamps are monotonic (``time.perf_counter_ns``) relative to the
tracer's construction, in microseconds — the unit Chrome-trace wants.
Spans time the host: on the card a span measures the device's work only
where the code inside it synchronizes (the engine's steps do, through
``StepTimer``); compile and registry spans measure host time.
"""
from __future__ import annotations

import json
import os
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


class _Span:
    """One live span: context manager that records itself on exit."""

    __slots__ = ("_tracer", "name", "cat", "attrs", "_t0", "_tid", "_depth",
                 "_parent")

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
        return False


class Tracer:
    """Span/event recorder with Chrome-trace and JSONL export.

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
        stack.  Returns a no-op handle when the tracer is disabled."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, cat, attrs)

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
        chrome://tracing).  Spans become complete ``"X"`` events, instants
        become ``"i"`` events; ``ts``/``dur`` are microseconds."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        for r in self.records:
            if r["type"] == "span":
                events.append({
                    "name": r["name"], "cat": r["cat"] or "repro_torch",
                    "ph": "X", "ts": r["ts"], "dur": r["dur"],
                    "pid": pid, "tid": r["tid"], "args": dict(r["args"]),
                })
            else:
                events.append({
                    "name": r["name"], "cat": r["cat"] or "repro_torch",
                    "ph": "i", "s": "t", "ts": r["ts"],
                    "pid": pid, "tid": r["tid"], "args": dict(r["args"]),
                })
        out = {"traceEvents": events, "displayTimeUnit": "ms"}
        if metadata:
            out["otherData"] = dict(metadata)
        return out

    def write(self, path, metadata: Optional[dict] = None) -> None:
        """Write the Chrome-trace JSON (``default=repr`` keeps arbitrary
        span attrs from breaking the export)."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(metadata), f, default=repr)

    def write_jsonl(self, path) -> None:
        """One raw record per line — the grep/jq-friendly event log."""
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r, default=repr) + "\n")


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
