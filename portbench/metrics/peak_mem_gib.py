"""Peak device memory allocated during the window, after a reset at its
start (GiB)."""


def read(w):
    return w.peak_window_bytes / 2 ** 30 if w.peak_window_bytes else None
