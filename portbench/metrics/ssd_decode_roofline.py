"""The ssd_decode kernel's share of its roofline over the traced stretch (%):
``roofline/ssd_decode.py``'s bound summed over its calls, over its device time."""


def read(w):
    return w.roofline_pct("ssd_decode")
