"""Mean wall of the window's scheduler steps that admitted nothing: one
batched decode step each, ending in the copy of its token ids to the host
(ms)."""


def read(w):
    return w.decode_step_ms()
