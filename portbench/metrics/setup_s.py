"""Seconds from the start of the process to the start of the window:
imports, the weights drawn, the engine and its kernel plans (compiled, or
replayed from the cache), the longest prompt's prefill and the ramp."""


def read(w):
    return w.setup_s
