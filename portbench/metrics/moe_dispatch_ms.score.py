"""Device ms a unit of the MoE's dispatch: the ``moe.dispatch`` spans
(``models/moe.py`` ``_route``).  Under ``scan_impl="pallas"``, the
scoring cells' setting, the span holds ``ops.moe_dispatch``, the two
launches of ``kernels/csrc/moe_permute.cu`` (``slot_tokens``: each slot's
token; ``dispatch_rows``: each row of the [E, C+1, d] capacity buffer
written once, a kept token's row or zeros); under ``"xla"``,
``index_add_dispatch``.  CUDA events of the program's own."""
from portbench.metrics._spans import ms_a_unit


def read(t):
    return ms_a_unit(t, ["moe.dispatch"])
