"""Shared by the span readers: the program's own spans and counters
(``repro_torch.tracing``) over the traced units' last ``traced_units``
units, the entry-timed ones the rooflines read.

Importing this module turns the program's tracing on.  Readers load only
in a traced run, so a traced run is traced from its set-up on and a
timed run never is.  A program without ``tracing`` gives no reading."""
from __future__ import annotations

from typing import Dict, Optional

try:
    from repro_torch import tracing
except ImportError:
    tracing = None
else:
    tracing.enable()


def totals(t: Dict) -> Optional[Dict]:
    """``tracing.totals`` over the traced units, or None."""
    if tracing is None:
        return None
    out = tracing.totals(last_units=t["traced_units"])
    return out if out["units"] else None


def ms_a_unit(t: Dict, names) -> Optional[float]:
    """The device ms of the spans ``names`` summed, a unit; None where
    none of them was recorded."""
    got = totals(t)
    rows = [got["spans"][n] for n in names if n in got["spans"]] \
        if got else []
    if not rows:
        return None
    return sum(r["ms"] for r in rows) / got["units"]
