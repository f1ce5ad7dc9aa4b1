"""Roofline terms of a dry-run cell, for one NVIDIA H100.

Counterpart of ``repro/launch/roofline.py``, with the same functions and
names.  The constants are NVIDIA's datasheet values for the card that
``chip_smoke.py`` reports, "NVIDIA H100 80GB HBM3" (SXM) at its 700 W
power limit; a card set below that limit runs slower.  They are not
measured:

    compute term    = FLOPs a rank / PEAK_FLOPS      (dense bf16)
    memory term     = bytes a rank / HBM_BW
    collective term = collective bytes a rank / LINK_BW

``LINK_BW`` is NVLink 4 one way: 900 GB/s a GPU to the other GPUs of its
host, 450 GB/s each way.  A 256- or 512-rank mesh spans hosts, whose
links are slower; the term is the bound of a rank on NVLink.  The dominant
term is the structural bottleneck of the cell.  The collective bytes come
from the records of ``launch/op_analysis.py`` (what each collective a rank
issued moved), not from HLO text.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_FLOPS = 989e12         # bf16 dense FLOP/s, H100 SXM datasheet
HBM_BW = 3.35e12            # bytes/s, H100 SXM (80 GB HBM3) datasheet
LINK_BW = 450e9             # bytes/s, NVLink 4, one direction a GPU
HBM_BYTES = 80e9            # device memory of one card

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Sum the bytes of each collective kind over ``records``, the
    (kind, bytes) pairs ``op_analysis`` keeps, one a collective a rank
    issued (kind in ``COLLECTIVES``, bytes of its input)."""
    out: Dict[str, int] = {c: 0 for c in COLLECTIVES}
    out["count"] = 0
    for kind, nbytes in records:
        if kind not in out or kind == "count":
            raise ValueError(f"unknown collective kind {kind!r}")
        out[kind] += int(nbytes)
        out["count"] += 1
    out["total"] = sum(out[c] for c in COLLECTIVES)
    return out


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float) -> Dict[str, float]:
    t_c = flops_per_device / PEAK_FLOPS
    t_m = bytes_per_device / HBM_BW
    t_x = coll_bytes_per_device / LINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    total = max(t_c, t_m, t_x)
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "dominant": dom,
        "step_lower_bound_s": total,
        "roofline_fraction_compute": t_c / total if total > 0 else 0.0,
    }


def model_flops(n_params_active: int, tokens: int, *, train: bool) -> float:
    """6·N·D for training (fwd+bwd), 2·N·D forward-only."""
    return (6.0 if train else 2.0) * n_params_active * tokens
