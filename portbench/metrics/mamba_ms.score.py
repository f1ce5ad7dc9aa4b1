"""Device ms a unit of a hybrid's Mamba layers: the ``mamba`` spans
(``models/hybrid.py`` ``superblock_apply``), each one layer's norm, in
and out projections, conv (``mamba.conv``), dt/B/C inputs
(``mamba.ssm_inputs``), scan (``mamba.scan``: under
``scan_impl="pallas"`` the kernel of ``kernels/csrc/mamba_scan.cu``),
gate and residual add.  CUDA events of the program's own."""
from portbench.metrics._spans import ms_a_unit


def read(t):
    return ms_a_unit(t, ["mamba"])
