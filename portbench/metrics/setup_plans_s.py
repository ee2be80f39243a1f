"""Seconds of set-up spent building the kernels and planning the engine's
kernel grid: every ``kernels.build_s`` and ``engine.warmup_s`` sample
recorded before the window, summed (s)."""
from repro_torch import obs


def read(w):
    out = []
    for name in ("kernels.build_s", "engine.warmup_s"):
        h = obs.default_metrics().histogram(name)
        between = getattr(h, "between", None)
        out += between(float("-inf"), w.t0) if between else []
    return sum(out) if out else None
