"""The host's part of the engine's prefills in the window (%): the seconds
from each prefill's entry (its cache allocated in them) to the return of
its last launch (``engine.prefill_enqueue_s``) over the seconds to its
synchronized end (``engine.prefill_s``), each summed over the window."""
from repro_torch import obs


def _samples(name, w):
    h = obs.default_metrics().histogram(name)
    between = getattr(h, "between", None)
    return between(w.t0, w.t1) if between else []


def read(w):
    enqueue = _samples("engine.prefill_enqueue_s", w)
    wall = sum(_samples("engine.prefill_s", w))
    return 100.0 * sum(enqueue) / wall if enqueue and wall > 0 else None
