"""Share of the first tokens' wait spent outside the request's own prefill
(%), over the first tokens made in the window: submit to the end of the
step that made the token (``sched.first_token_s``) less the request's own
prefill seconds (``sched.first_token_prefill_s``), summed, over the first
summed.  The rest is queueing behind other prefills and being held for
the step's decode."""
from repro_torch import obs


def _samples(name, w):
    h = obs.default_metrics().histogram(name)
    between = getattr(h, "between", None)
    return between(w.t0, w.t1) if between else []


def read(w):
    first = sum(_samples("sched.first_token_s", w))
    own = sum(_samples("sched.first_token_prefill_s", w))
    return 100.0 * (first - own) / first if first > 0 else None
