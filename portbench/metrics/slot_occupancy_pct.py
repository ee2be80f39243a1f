"""Mean share of the decode slots held by a request at the end of each of
the window's scheduler steps (the step hook's snapshots, %)."""


def read(w):
    return w.occupancy_pct()
