"""The ssd_scan kernel's share of its roofline over the traced stretch (%):
``roofline/ssd_scan.py``'s bound summed over its calls, over its device time."""


def read(w):
    return w.roofline_pct("ssd_scan")
