"""Profiling hook: bracket a span with an optional ``torch.profiler``
capture; the port of ``repro.obs.profile`` (``torch.profiler`` where the
reference starts ``jax.profiler``).

``obs.profile("prefill", logdir="...")`` answers "where does the time go
*inside* one step": the span lands in the obs trace (wall-clock
attribution across the port's own layers) and, when a ``logdir`` is given,
a ``torch.profiler`` capture of the same window (the host and, on the card,
every kernel and copy) is written there as a Chrome trace,
``<logdir>/<name>.pt.trace.json``, which ui.perfetto.dev opens beside the
obs trace.  ``launch/profile.py`` is the per-phase busy / idle report over
the same profiler.

The profiler is strictly optional: a start or export failure degrades to
the plain span with a counted ``profile.unavailable`` event — profiling
hooks must never take the serving path down.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

from . import metrics as _metrics
from . import trace as _trace


@contextlib.contextmanager
def profile(name: str = "profile", logdir: Optional[str] = None,
            **attrs) -> Iterator[object]:
    """Span (always) + ``torch.profiler`` capture (when ``logdir``).

        with obs.profile("serve.generate", logdir="build/prof"):
            engine.generate(tokens, 64)
    """
    prof = None
    if logdir is not None:
        try:
            import torch
            from torch.profiler import ProfilerActivity
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        except Exception as e:  # noqa: BLE001 — a profiler is optional
            prof = None
            _metrics.default_metrics().counter("profile.unavailable").inc()
            _trace.instant("profile.unavailable", error=repr(e))
    span = _trace.get_tracer().span(name, cat="profile",
                                    profiled=prof is not None, **attrs)
    try:
        with span as sp:
            yield sp
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(str(logdir), f"{name}.pt.trace.json"))
            except Exception as e:  # noqa: BLE001
                _trace.instant("profile.stop_failed", error=repr(e))
