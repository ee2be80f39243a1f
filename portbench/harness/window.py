"""The window's arithmetic, frozen with the benchmark: what the end-to-end
and per-layer metrics compute from the loop's record.  Every reading takes
all the work and all the time of the window."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .loop import Req, Step

ROOT = Path(__file__).resolve().parents[1]
PEAKS = json.loads((ROOT / "roofline" / "peaks.json").read_text())


def p95(values: Sequence[float]) -> Optional[float]:
    """The 95th percentile (linear between order statistics), None for no
    values."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), 95))


class Window:
    """One measured stretch of the loop: its steps, the requests, and
    [t0, t1] on the host clock."""

    def __init__(self, steps: List[Step], reqs: Dict[int, Req], t0: float,
                 port: Dict, slots: int,
                 token_flops: Callable[[Dict, int, bool], float]):
        self.steps, self.reqs = steps, reqs
        self.t0, self.t1 = t0, steps[-1].t1
        self.port, self.slots = port, slots
        self.token_flops = token_flops
        # set by the traced stretch that follows the window (run with
        # --trace 1): kernel seconds and counts by name, counter deltas
        self.trace: Optional[Dict] = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def _inside(self, t: float) -> bool:
        return self.t0 <= t <= self.t1

    # ------------------------------------------------------ end to end --
    def tokens(self) -> int:
        """Prompt tokens of prefills that finished inside the window plus
        output tokens that reached the host inside it."""
        n = 0
        for r in self.reqs.values():
            if r.times and self._inside(r.times[0]):
                n += r.prompt_len
            n += sum(1 for t in r.times if self._inside(t))
        return n

    def tok_s(self) -> float:
        return self.tokens() / self.seconds

    def ttft_ms(self) -> List[float]:
        """Send to first token, of every request whose first token came
        inside the window."""
        return [(r.times[0] - r.send_t) * 1e3 for r in self.reqs.values()
                if r.times and self._inside(r.times[0])]

    def itl_ms(self) -> List[float]:
        """Every gap between consecutive output tokens of a request that
        ends inside the window."""
        out = []
        for r in self.reqs.values():
            for a, b in zip(r.times, r.times[1:]):
                if self._inside(b):
                    out.append((b - a) * 1e3)
        return out

    def attempted(self) -> int:
        """Requests sent before the window closed that had not completed
        before it opened."""
        return sum(1 for r in self.reqs.values() if r.send_t <= self.t1
                   and (r.done_t is None or r.done_t >= self.t0))

    def completed(self) -> List[Req]:
        return [r for r in self.reqs.values()
                if r.done_t is not None and self._inside(r.done_t)]

    # ------------------------------------------------------- per layer --
    def occupancy_pct(self) -> float:
        return 100.0 * float(np.mean([s.occupancy for s in self.steps])) \
            / self.slots

    def decode_step_ms(self) -> Optional[float]:
        """Mean wall of the steps that admitted nothing."""
        walls = [s.t1 - s.t0 for s in self.steps if not s.admitted]
        return 1e3 * sum(walls) / len(walls) if walls else None

    def prefill_us_per_tok(self) -> Optional[float]:
        toks = sum(sum(s.prefills) for s in self.steps)
        secs = sum(s.prefill_s for s in self.steps)
        return 1e6 * secs / toks if toks and secs else None

    def flops(self) -> float:
        """Model FLOPs of the steps' work: each prompt token at its position
        (the head on the last), each decoded token over its keys."""
        p, f = self.port, self.token_flops
        a = f(p, 0, False)
        b = f(p, 1, False) - a
        head = f(p, 0, True) - a
        total = 0.0
        for s in self.steps:
            for n in s.prefills:
                total += n * a + b * n * (n + 1) / 2 + head
            for k in s.decode_keys:
                total += a + b * k + head
        return total

    def mfu_pct(self) -> float:
        return 100.0 * self.flops() / (self.seconds * PEAKS["bf16_flops"])

    def roofline_pct(self, kernel: str) -> Optional[float]:
        """Sum of the kernel's bounds over its calls in the traced stretch,
        over the kernel's device time there; None where it made no call or
        the calls counted three ways disagree."""
        if self.trace is None:
            return None
        return self.trace["roofline"].get(kernel)
