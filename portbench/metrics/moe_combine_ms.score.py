"""Device ms a unit of the MoE's combine: the ``moe.combine`` spans
(``models/moe.py`` ``_combine``).  Under ``scan_impl="pallas"``, the
scoring cells' setting, the span holds ``ops.moe_combine``, the launch of
``kernels/csrc/moe_permute.cu`` ``combine_rows`` (each token's kept rows
of the buffer read back, weighted by their gates and summed); under
``"xla"``, ``gather_combine``.  CUDA events of the program's own."""
from portbench.metrics._spans import ms_a_unit


def read(t):
    return ms_a_unit(t, ["moe.combine"])
