"""The flash kernel's share of its roofline over the traced stretch (%):
``roofline/flash.py``'s bound summed over its calls, over its device time."""


def read(w):
    return w.roofline_pct("flash")
