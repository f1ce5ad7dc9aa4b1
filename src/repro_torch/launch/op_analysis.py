"""Per-rank FLOPs, traffic, collective bytes and peak live bytes of an
eager run, read from the ops it dispatches.

Counterpart of ``repro/launch/hlo_analysis.py``, which reads them from
post-SPMD HLO text; here there is no compiled program, so ``OpAnalysis``,
a ``TorchDispatchMode``, watches the run itself (the dry-run's run on
``meta`` tensors over a fake process group, or a real one).  An op on
DTensors is handed back to DTensor (the mode returns ``NotImplemented``,
as ``CommDebugMode`` does), which runs it as local ops on each rank's
blocks and the collectives its redistributions need; the mode counts
those, so every quantity is a rank's own, at local shapes:

  * ``flops``           - 2 x M x N x K of every ``mm``/``bmm``/``addmm``/
                          ``baddbmm`` at its local shapes, so a product
                          whose output is a partial sum counts the local
                          K, K over the mesh dims of the sum (matrix-unit
                          work; elementwise work excluded, as the
                          reference's);
  * ``traffic_bytes``   - operand plus result bytes of every op that is
                          not a view.  An eager program materializes every
                          result, so these are eager bytes, above what a
                          fused program would move;
  * ``collective_*``    - the input bytes of every collective a rank
                          issued, by the kind the program asked for (a
                          fake group may carry out an all-to-all as
                          gathers; the record names the all-to-all);
  * ``peak_bytes``      - the most bytes live at once: the storages of the
                          arguments (``track``) and of every op's results,
                          each counted from its creation until Python frees
                          it (a weak reference's callback).

DTensor also runs each new op once on ``meta`` stand-ins of the global
shapes, to learn its output's shape (``_propagate_tensor_meta_non_cached``
of its sharding propagator); no rank does that work, so ops run there
are not counted.

The keys are the reference's (``flops``, ``traffic_bytes``,
``collective_total``, ``collective_count``, ``coll_<kind>``) plus the
per-op breakdown ``ops`` and ``peak_bytes``.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch.roofline import COLLECTIVES, collective_bytes

# the collectives DTensor's redistributions issue, by the reference's kinds
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}
_NO_TRAFFIC = {"wait_tensor", "_wrap_tensor_autograd"}


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(func, args) -> int:
    name = func.overloadpacket.__name__
    if name in ("mm", "addmm"):
        a, b = args[-2], args[-1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = args[-2], args[-1]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 0


class OpAnalysis(TorchDispatchMode):
    """Counts a rank's FLOPs, bytes and collectives while active; see the
    module docstring.  ``track(tree)`` counts tensors made before the mode
    (the arguments) as live."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.traffic = 0
        self.collectives: List[Tuple[str, int]] = []
        self.ops: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {"count": 0, "flops": 0, "bytes": 0})
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, Any] = {}
        self._muted = 0
        self._unpatch = None

    def __enter__(self):
        prop = DTensor._op_dispatcher.sharding_propagator
        real = prop._propagate_tensor_meta_non_cached

        def muted(*args, **kwargs):
            self._muted += 1
            try:
                return real(*args, **kwargs)
            finally:
                self._muted -= 1

        prop._propagate_tensor_meta_non_cached = muted
        self._unpatch = lambda: delattr(prop,
                                        "_propagate_tensor_meta_non_cached")
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch()

    def track(self, tree: Any) -> int:
        """Count the storages of ``tree``'s tensors (DTensors' local
        blocks) as live; returns their bytes."""
        before = self.live
        for t in _tensors(tree):
            self._add(t.to_local() if isinstance(t, DTensor) else t)
        return self.live - before

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            if self._storages.pop(key, None) is not None:
                self.live -= n

        self._storages[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._muted:
            return out
        name = func.overloadpacket.__name__
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        rec = self.ops[name]
        rec["count"] += 1
        kind = _KIND.get(name) if func.namespace in (
            "_c10d_functional", "c10d_functional", "c10d") else None
        if kind is not None:
            nb = sum(_nbytes(t) for t in ins)
            self.collectives.append((kind, nb))
            rec["bytes"] += nb
            self.traffic += nb
        elif name not in _NO_TRAFFIC and not func.is_view:
            f = _dot_flops(func, args)
            nb = sum(_nbytes(t) for t in ins + outs)
            rec["flops"] += f
            rec["bytes"] += nb
            self.flops += f
            self.traffic += nb
        for t in outs:
            self._add(t)
        return out

    def result(self) -> Dict[str, Any]:
        coll = collective_bytes(self.collectives)
        out: Dict[str, Any] = {
            "flops": float(self.flops),
            "traffic_bytes": float(self.traffic),
            "collective_total": float(coll["total"]),
            "collective_count": coll["count"],
            "peak_bytes": self.peak,
        }
        for c in COLLECTIVES:
            out[f"coll_{c}"] = float(coll[c])
        out["ops"] = {k: dict(v) for k, v in sorted(self.ops.items())}
        return out
