"""Kernel timing on the card with CUDA events."""
from __future__ import annotations

import statistics
import time
from typing import Optional

import torch

TIMING_ITERS = 20


class Timer:
    """Per-launch CUDA-event times, with L2 (50 MB) flushed before each by
    writing a 256 MB buffer, so each timed call finds its inputs in device
    memory as a cold caller would.  ``ms`` runs ``fn`` once to warm up, then
    returns the median of ``iters`` timed calls, or of those timed before
    ``budget_s`` seconds of wall clock ran out (at least one)."""

    def __init__(self):
        self._flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                  device="cuda")

    def ms(self, fn, iters: int = TIMING_ITERS,
           budget_s: Optional[float] = None) -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            if times and budget_s is not None \
                    and time.perf_counter() - t0 > budget_s:
                break
            self._flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)
