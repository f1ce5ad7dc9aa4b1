"""Shared by the ``*_roofline`` readers: the share of its roofline that a
program entry reached, over the traced units' calls."""
from __future__ import annotations

from typing import Callable, Dict, Optional


def share(t: Dict, entry: str, bound_ms: Callable[[Dict], float]
          ) -> Optional[float]:
    """100 x sum of the calls' bounds / sum of their device ms, or None
    where the entry was not called."""
    rows = t["calls"].get(entry, [])
    spent = sum(r["ms"] for r in rows)
    if not rows or spent <= 0:
        return None
    return 100.0 * sum(bound_ms(r) for r in rows) / spent


def dtype_name(x) -> str:
    return str(x.dtype).rsplit(".", 1)[-1]
