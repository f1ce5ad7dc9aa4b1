"""The selective scan's share of its roofline: ``kernels.ops.mamba_scan``
timed by CUDA events around each call, against ``flops.mamba_bound`` (its
B S di N exponentials on the special-function units and their f32
operations, or dt, x, b, c and A read and y written once)."""
from portbench import flops
from portbench.metrics._roofline import share

ENTRY = "repro_torch.kernels.ops:mamba_scan"


def info(args, kwargs, out):
    A, dt = args[0], args[1]
    B, S, di = dt.shape
    return {"B": B, "S": S, "di": di, "N": A.shape[1]}


ENTRIES = [("repro_torch.kernels.ops", "mamba_scan", info)]


def read(t):
    return share(t, ENTRY, lambda r: flops.mamba_bound(
        r["B"], r["S"], r["di"], r["N"])[0])
