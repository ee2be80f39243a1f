"""Share of the engine's decode steps in the window that replayed its
captured CUDA graph (%): the mean of the ``engine.decode_graph`` samples
(1 a replay, 0 an eager step), one a step, stamped inside the window.
A program that records no such sample reads nothing."""
from repro_torch import obs


def read(w):
    h = obs.default_metrics().histogram("engine.decode_graph")
    between = getattr(h, "between", None)
    steps = between(w.t0, w.t1) if between else []
    return 100.0 * sum(steps) / len(steps) if steps else None
