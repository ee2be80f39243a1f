"""Mean host time of the scheduler's steps in the window (ms): each step's
wall less its seconds inside the engine's prefill, prefill_chunk and
decode_token calls (``sched.host_s``): admission, cache row copies, token
readback, bookkeeping and the step hook."""
from repro_torch import obs


def read(w):
    h = obs.default_metrics().histogram("sched.host_s")
    between = getattr(h, "between", None)
    host = between(w.t0, w.t1) if between else []
    return 1e3 * sum(host) / len(host) if host else None
