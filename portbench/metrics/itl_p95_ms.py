"""95th percentile of the gaps between consecutive output tokens of a
request, over every gap that ends inside the window (ms)."""
from portbench.harness.window import p95


def read(w):
    return p95(w.itl_ms())
