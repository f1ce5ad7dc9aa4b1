"""The expert products' share of their roofline: ``kernels.ops.gmm_equal``
over the MoE's capacity buffer [E, C+1, d], timed by CUDA events around
each call.  The bound counts the rows the capacity kept (a kept slot
holds a token's row, whose first ``PROBE`` elements are not all zero;
an empty slot is zeros; the last slot of each expert parks the dropped
assignments and counts nothing), ``flops.gmm_bound``."""
from portbench import flops
from portbench.metrics._roofline import dtype_name, share

ENTRY = "repro_torch.kernels.ops:gmm_equal"
PROBE = 16


def info(args, kwargs, out):
    x, w = args[0], args[1]
    used = (x[:, :-1, :PROBE] != 0).any(-1)      # [G, C]
    return {"kept": used.sum(), "groups": used.any(-1).sum(),
            "K": x.shape[2], "N": w.shape[2], "dtype": dtype_name(x)}


ENTRIES = [("repro_torch.kernels.ops", "gmm_equal", info)]


def read(t):
    return share(t, ENTRY, lambda r: flops.gmm_bound(
        int(r["kept"]), int(r["groups"]), r["K"], r["N"], r["dtype"])[0])
