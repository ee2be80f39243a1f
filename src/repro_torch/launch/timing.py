"""Kernel timing on the card with CUDA events."""
from __future__ import annotations

import statistics
import time
from typing import Optional

import torch

TIMING_ITERS = 20
# the spin queued before each start event: about 1 ms of the H100's
# 1.98 GHz SM clock, many times the host's cost of queueing one wrapped call
HOLD_CYCLES = 2_000_000


class Timer:
    """Per-launch CUDA-event times, with L2 (50 MB) flushed before each by
    writing a 256 MB buffer, so each timed call finds its inputs in device
    memory as a cold caller would.  ``ms`` runs ``fn`` once to warm up, then
    returns the median of ``iters`` timed calls, or of those timed before
    ``budget_s`` seconds of wall clock ran out (at least one).

    After the flush the stream spins for ``hold_cycles`` (a device sleep)
    before the start event, so the host has queued the timed call while the
    card is still busy: without it, a call whose host side (checks, ctypes,
    allocation) outlasts the flush leaves the card idle inside the timed
    window, and the time holds host time.  ``samples`` and ``late`` count
    the timed calls and those whose start event had fired before the host
    finished queueing them (their time may hold host time).

    The flush leaves L2 full of dirty lines, which a short call writes back
    to device memory as it evicts them; ``read_flush=True`` flushes by
    reading the buffer instead, so L2 holds clean lines."""

    def __init__(self, hold_cycles: int = HOLD_CYCLES,
                 read_flush: bool = False):
        self._flush = torch.zeros(64 * 1024 * 1024, dtype=torch.float32,
                                  device="cuda")
        self.hold_cycles = hold_cycles
        self.read_flush = read_flush
        self.samples = self.late = 0

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
            if self.read_flush:
                self._flush.sum()
            else:
                self._flush.zero_()
            if self.hold_cycles:
                torch.cuda._sleep(self.hold_cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            self.late += start.query()
            self.samples += 1
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)
