"""Mean share of the routed experts that one MoE layer call of a decode
step reads (%), over the traced stretch after the window: the program's
``moe.decode_experts_hit`` samples (experts with at least one routed row,
summed over a step's calls) over its ``moe.decode_calls``, over the
configuration's experts.  The program records them only while a profiler
records; one that records none reads nothing."""
import math

from repro_torch import obs


def _after(name, t0):
    between = getattr(obs.default_metrics().histogram(name), "between", None)
    return sum(between(t0, math.inf)) if between else 0


def read(w):
    n_exp = (w.port.get("moe") or {}).get("n_experts")
    calls = _after("moe.decode_calls", w.t1)
    if not calls or not n_exp:
        return None
    return 100.0 * _after("moe.decode_experts_hit", w.t1) / calls / n_exp
