"""95th percentile of send-to-first-token over every request whose first
token reached the client inside the window (ms)."""
from portbench.harness.window import p95


def read(w):
    return p95(w.ttft_ms())
