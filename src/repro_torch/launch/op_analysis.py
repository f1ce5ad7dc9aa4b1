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
of its sharding propagator), and an op without a sharding strategy once
through its decomposition on a fake mesh (``propagate_op_sharding
_non_cached``); no rank does that work, so ops run there are not counted
(so a cell traced twice in one process counts the same).

A loop too long to step on ``meta`` (the Mamba token scan,
``models/mamba.py`` ``_MetaChunk``) can instead be charged what it would
dispatch: ``active()`` is the mode in use, ``alone()`` runs probes of the
loop at a few lengths in a mode of their own, ``window()`` reads a
probe's counts, ``extrapolate`` (``extrapolated``: once a mode) takes
them to the loop's length, and ``charge`` adds them to the mode in use,
their peak of live bytes above the live bytes of the moment.

The keys are the reference's (``flops``, ``traffic_bytes``,
``collective_total``, ``collective_count``, ``coll_<kind>``) plus the
per-op breakdown ``ops`` and ``peak_bytes``.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (
    TorchDispatchMode, _disable_current_modes,
    _get_current_dispatch_mode_stack,
)
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
# DTensor's sharding propagator: the ops it runs on stand-ins (an output's
# shape, an op without a strategy propagated through its decomposition on a
# fake mesh) are no rank's work; the cached entry point is muted too, as it
# holds the uncached method it wraps
_PROPAGATION = ("_propagate_tensor_meta_non_cached",
                "propagate_op_sharding_non_cached", "propagate_op_sharding")


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
        self._probed: Dict[Any, Dict[str, Any]] = {}
        self._muted = 0
        self._unpatch = None

    def __enter__(self):
        prop = DTensor._op_dispatcher.sharding_propagator
        undo = []
        for name in _PROPAGATION:
            real = getattr(prop, name, None)
            if real is None:
                continue
            # an instance attribute: an enclosing mode's patch, or the
            # propagator's own (its cached entry point)
            outer = prop.__dict__.get(name)

            def muted(*args, real=real, **kwargs):
                self._muted += 1
                try:
                    return real(*args, **kwargs)
                finally:
                    self._muted -= 1

            setattr(prop, name, muted)
            undo.append((lambda n=name: delattr(prop, n)) if outer is None
                        else (lambda n=name, o=outer: setattr(prop, n, o)))
        self._unpatch = lambda: [u() for u in reversed(undo)]
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

    @contextlib.contextmanager
    def muted(self):
        """Ops run inside are neither counted nor tracked."""
        self._muted += 1
        try:
            yield
        finally:
            self._muted -= 1

    @contextlib.contextmanager
    def window(self):
        """Yields a dict that on exit holds what the ops run inside added:
        ``ops`` (name -> count, flops, bytes), ``flops``, ``traffic``,
        ``collectives`` and ``peak`` (the most live bytes above the live
        bytes at entry)."""
        ops0 = {k: dict(v) for k, v in self.ops.items()}
        flops0, traffic0, n_coll0, live0 = (self.flops, self.traffic,
                                            len(self.collectives), self.live)
        peak0, self.peak = self.peak, self.live
        rec: Dict[str, Any] = {}
        try:
            yield rec
        finally:
            rec["ops"] = {}
            for k, v in self.ops.items():
                was = ops0.get(k, {"count": 0, "flops": 0, "bytes": 0})
                d = {f: v[f] - was[f] for f in v}
                if any(d.values()):
                    rec["ops"][k] = d
            rec.update(flops=self.flops - flops0,
                       traffic=self.traffic - traffic0,
                       collectives=list(self.collectives[n_coll0:]),
                       peak=self.peak - live0)
            self.peak = max(peak0, self.peak)

    def extrapolated(self, key: Any, probe: Callable[[int], Dict[str, Any]],
                     n: int) -> Dict[str, Any]:
        """``extrapolate(probe, n)``, probed once for each ``key`` and n
        while this mode lives."""
        if (key, n) not in self._probed:
            self._probed[(key, n)] = extrapolate(probe, n)
        return self._probed[(key, n)]

    def charge(self, rec: Dict[str, Any]) -> None:
        """Add a ``window`` record's counts, and its peak above the live
        bytes now (the caller ``track``s what it keeps live)."""
        for k, v in rec["ops"].items():
            for f, n in v.items():
                self.ops[k][f] += n
        self.flops += rec["flops"]
        self.traffic += rec["traffic"]
        self.collectives.extend(rec["collectives"])
        self.peak = max(self.peak, self.live + rec["peak"])

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


def active() -> Optional[OpAnalysis]:
    """The innermost ``OpAnalysis`` on the dispatch mode stack, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpAnalysis):
            return mode
    return None


def saving_hooked() -> bool:
    """Whether a saved-tensor hook is in use (a remat region's)."""
    return torch._C._autograd._top_saved_tensors_default_hooks(
        False) is not None


@contextlib.contextmanager
def alone(hooked: bool):
    """A fresh ``OpAnalysis``, entered outside every dispatch mode and
    saved-tensor hook in use (an enclosing ``OpAnalysis``, a remat
    region's): the ops run inside count there only, and the autograd
    graphs made inside are their own.  With ``hooked`` an identity hook
    stands in for the ones taken away (autograd detaches what it hands a
    hook)."""
    ag = torch._C._autograd
    taken = []
    while (top := ag._top_saved_tensors_default_hooks(False)) is not None:
        taken.append(top)
        ag._pop_saved_tensors_default_hooks()
    try:
        with _disable_current_modes(), \
                torch.autograd.graph.saved_tensors_hooks(
                    lambda t: t, lambda t: t) if hooked \
                else contextlib.nullcontext(), OpAnalysis() as oa:
            yield oa
    finally:
        for pack, unpack in reversed(taken):
            ag._push_saved_tensors_default_hooks(pack, unpack)


PEAK_AT = (16, 32)


def extrapolate(probe: Callable[[int], Dict[str, Any]], n: int
                ) -> Dict[str, Any]:
    """``probe(k)``'s ``window`` record of a loop of k steps, taken to n
    steps.  Every count of a loop whose steps dispatch the same ops on
    the same shapes, and whose backward makes a grad of the whole input
    at each step, is a polynomial of degree <= 2 in its length: fitted
    exactly at 2, 3 and 4 steps and checked at 5, 16 and 32 (a record
    that fails the check raises).  The peak is no polynomial (the order
    in which the steps free their temporaries moves it by a few of them
    at short lengths): it is taken on the line through 16 and 32 steps.
    ``n`` <= 32 is probed as it is."""
    if n <= PEAK_AT[-1]:
        return probe(n)
    at = (2, 3, 4, 5) + PEAK_AT
    recs = [probe(k) for k in at]
    if any(r["collectives"] for r in recs):
        raise ValueError("a probed loop issued collectives")

    def poly(f2, f3, f4, m):
        return f2 + (m - 2) * (f3 - f2) + \
            (m - 2) * (m - 3) // 2 * (f4 - 2 * f3 + f2)

    def fit(vals, path):
        if [poly(*vals[:3], m) for m in at] != vals:
            raise ValueError(f"{path}: {dict(zip(at, vals))} is no "
                             "polynomial of degree <= 2 in the length")
        return poly(*vals[:3], n)

    zero = {"count": 0, "flops": 0, "bytes": 0}
    names = sorted({k for r in recs for k in r["ops"]})
    out: Dict[str, Any] = {"ops": {}, "collectives": []}
    for k in names:
        out["ops"][k] = {f: fit([r["ops"].get(k, zero)[f] for r in recs],
                                f"ops.{k}.{f}") for f in zero}
    for f in ("flops", "traffic"):
        out[f] = fit([r[f] for r in recs], f)
    (k1, p1), (k2, p2) = [(k, r["peak"]) for k, r in zip(at, recs)][-2:]
    out["peak"] = p1 + (n - k1) * (p2 - p1) // (k2 - k1)
    return out
