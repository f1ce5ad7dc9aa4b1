"""The share of the capacity buffer's rows that hold a kept assignment:
100 x the program's counter ``moe.kept`` (assignments within their
expert's capacity) over ``moe.slots`` (E x (C + 1), the rows each expert
product computes), summed over the traced units' MoE calls."""
from portbench.metrics._spans import totals


def read(t):
    got = totals(t)
    if got is None or not got["counters"].get("moe.slots"):
        return None
    c = got["counters"]
    return 100.0 * c.get("moe.kept", 0.0) / c["moe.slots"]
