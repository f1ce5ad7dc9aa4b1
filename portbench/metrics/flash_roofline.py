"""Flash attention's share of its roofline: ``kernels.ops.flash_attention``
timed by CUDA events around each call, against ``flops.attention_bound``
(the visible pairs' products, or q, k, v and o moved once)."""
from portbench import flops
from portbench.metrics._roofline import dtype_name, share

ENTRY = "repro_torch.kernels.ops:flash_attention"


def info(args, kwargs, out):
    q, k = args[0], args[1]
    B, Sq, Hq, D = q.shape
    return {"B": B, "Hq": Hq, "Hkv": k.shape[2], "Sq": Sq,
            "Skv": k.shape[1], "D": D,
            "causal": bool(kwargs.get("causal", True)),
            "q_offset": int(kwargs.get("q_offset", 0)),
            "dtype": dtype_name(q)}


ENTRIES = [("repro_torch.kernels.ops", "flash_attention", info)]


def read(t):
    return share(t, ENTRY, lambda r: flops.attention_bound(
        r["B"], r["Hq"], r["Hkv"], r["Sq"], r["Skv"], r["D"], r["causal"],
        r["q_offset"], r["dtype"])[0])
