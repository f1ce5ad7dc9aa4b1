"""Device ms a unit of the MoE's dispatch: the ``moe.dispatch`` spans
(``models/moe.py`` ``_route``: each assignment's row repeated and added
into the [E, C+1, d] capacity buffer), CUDA events of the program's own."""
from portbench.metrics._spans import ms_a_unit


def read(t):
    return ms_a_unit(t, ["moe.dispatch"])
