"""WKV6's share of its roofline: ``kernels.ops.rwkv6_scan`` timed by
CUDA events around each call, against ``flops.wkv_bound`` (the
recurrence's f32 operations, or r, k, v, w, u read and y written once)."""
from portbench import flops
from portbench.metrics._roofline import share

ENTRY = "repro_torch.kernels.ops:rwkv6_scan"


def info(args, kwargs, out):
    B, S, H, D = args[0].shape
    return {"B": B, "S": S, "H": H, "D": D}


ENTRIES = [("repro_torch.kernels.ops", "rwkv6_scan", info)]


def read(t):
    return share(t, ENTRY, lambda r: flops.wkv_bound(
        r["B"], r["H"], r["S"], r["D"])[0])
