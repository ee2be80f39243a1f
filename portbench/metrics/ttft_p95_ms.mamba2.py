"""The 95th percentile of send -> first token, over the requests whose
first token came in the window (ms), in the cell where it is not judged:
there it swings with the order the seed deals the prompts in."""
from portbench.harness.window import p95


def read(w):
    return p95(w.ttft_ms())
