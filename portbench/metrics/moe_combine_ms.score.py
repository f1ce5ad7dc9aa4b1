"""Device ms a unit of the MoE's combine: the ``moe.combine`` spans
(``models/moe.py`` ``_combine``: each assignment's output gathered back
from the buffer, weighted and summed a token), CUDA events of the
program's own."""
from portbench.metrics._spans import ms_a_unit


def read(t):
    return ms_a_unit(t, ["moe.combine"])
