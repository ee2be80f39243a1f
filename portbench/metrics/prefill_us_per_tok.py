"""Microseconds a prompt token: the engine's prefill calls in the window,
each timed by a host clock that ends in a synchronize, over their prompt
tokens."""


def read(w):
    return w.prefill_us_per_tok()
