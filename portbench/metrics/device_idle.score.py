"""The share of the traced units' wall time in which no operation ran on
the card: 1 - (union of the device intervals in the profiler's trace) /
(the traced wall time)."""


def read(t):
    if t["busy_s"] <= 0 or t["traced_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["traced_s"])
