"""Step timing: the port of ``repro.launch.steps.StepTimer``.

The first call of each phase counts as cold (kernel builds, cuBLAS
handles and allocator growth land there); later calls are steady state,
kept in an ``obs.Histogram`` per phase, so the percentile math lives in
one place, as in the reference.  On the card every step ends in
``torch.cuda.synchronize()``, so a time is the device's, not the time to
enqueue.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from repro_torch import obs


class StepTimer:
    def __init__(self, device: torch.device):
        self._sync = device.type == "cuda"
        self.cold_s: Dict[str, float] = {}
        self._warm: Dict[str, obs.Histogram] = {}

    def run(self, phase: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self._sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if phase not in self.cold_s:
            self.cold_s[phase] = dt
        else:
            hist = self._warm.get(phase)
            if hist is None:
                hist = self._warm[phase] = obs.Histogram()
            hist.record(dt)
        return out

    @property
    def steady(self) -> Dict[str, List[float]]:
        """Raw warm samples per phase (a view over the histograms)."""
        return {phase: h.values for phase, h in self._warm.items()}

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per phase: the cold call, the steady-state mean, p50, p99 and
        best, and the reference's explicit ``cold`` / ``warm`` split."""
        out = {}
        for phase, cold in self.cold_s.items():
            h = self._warm.get(phase)
            n = h.count if h else 0
            p50 = h.percentile(50) if h else None
            p99 = h.percentile(99) if h else None
            out[phase] = {
                "cold_s": cold,
                "steps": n,
                "steady_mean_s": h.mean if h else None,
                "steady_p50_s": p50,
                "steady_p99_s": p99,
                "steady_best_s": h.min if h else None,
                "cold": {"calls": 1, "total_s": cold},
                "warm": {
                    "calls": n,
                    "total_s": h.total if h else 0.0,
                    "mean_s": h.mean if h else None,
                    "best_s": h.min if h else None,
                    "p50_s": p50,
                    "p90_s": h.percentile(90) if h else None,
                    "p99_s": p99,
                },
            }
        return out
