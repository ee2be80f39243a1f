"""Share of the traced stretch in which no kernel, copy or memset ran on
the device (%)."""


def read(w):
    if w.trace is None:
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.trace["window_s"])
