"""Step timing: the port of ``repro.launch.steps.StepTimer``.

The first call of each phase counts as cold (kernel builds, cuBLAS
handles and allocator growth land there); later calls are steady state.
On the card every step ends in ``torch.cuda.synchronize()``, so a time is
the device's, not the time to enqueue.
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Dict, List

import torch


class StepTimer:
    def __init__(self, device: torch.device):
        self._sync = device.type == "cuda"
        self.cold_s: Dict[str, float] = {}
        self.steady: Dict[str, List[float]] = {}

    def run(self, phase: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self._sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if phase not in self.cold_s:
            self.cold_s[phase] = dt
        else:
            self.steady.setdefault(phase, []).append(dt)
        return out

    def stats(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for phase, cold in self.cold_s.items():
            xs = self.steady.get(phase, [])
            out[phase] = {
                "cold_s": cold,
                "steps": len(xs),
                "steady_mean_s": statistics.fmean(xs) if xs else None,
                "steady_p50_s": statistics.median(xs) if xs else None,
                "steady_best_s": min(xs) if xs else None,
            }
        return out
