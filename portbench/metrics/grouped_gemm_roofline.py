"""The grouped GEMM's share of its roofline over the traced stretch (%):
``roofline/grouped_gemm.py``'s bound summed over its launches, over its
device time."""


def read(w):
    return w.roofline_pct("grouped_gemm")
