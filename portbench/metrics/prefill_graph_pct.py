"""Share of the engine's fresh prefills in the window that replayed a
captured CUDA graph (%): the mean of the ``engine.prefill_graph`` samples
(1 a replay, 0 an eager prefill), one a prefill, stamped inside the
window.  A program that records no such sample reads nothing."""
from repro_torch import obs


def read(w):
    h = obs.default_metrics().histogram("engine.prefill_graph")
    between = getattr(h, "between", None)
    prefills = between(w.t0, w.t1) if between else []
    return 100.0 * sum(prefills) / len(prefills) if prefills else None
