"""The host's part of the engine's decode steps in the window (%): the
seconds from each step's entry to the return of its last launch
(``engine.decode_enqueue_s``) over the seconds to its synchronized end
(``serve.decode_step_s``), each summed over the window.  Near 100 the
host paces the step."""
from repro_torch import obs


def _samples(name, w):
    h = obs.default_metrics().histogram(name)
    between = getattr(h, "between", None)
    return between(w.t0, w.t1) if between else []


def read(w):
    enqueue = _samples("engine.decode_enqueue_s", w)
    wall = sum(_samples("serve.decode_step_s", w))
    return 100.0 * sum(enqueue) / wall if enqueue and wall > 0 else None
