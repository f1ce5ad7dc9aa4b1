"""Spans and counters at the layer boundaries of the port's main paths.

Off by default.  An operator turns it on, runs the work, and reads what
each layer took::

    from repro_torch import tracing
    tracing.enable()
    for batch in batches:
        eval_step(params, batch)
    t = tracing.totals(last_units=4)
    t["spans"]["moe.dispatch"]["ms"] / t["units"]   # device ms a step
    tracing.disable()

A *unit* is one call of an entry point (``unit("eval_step", tensor)``,
the eval step's root span): every span opened while it is open belongs to
it, on any thread (a remat group's recompute runs on autograd's).  A span
outside any unit records nothing.  Spans nest by a per-thread stack, so
each knows its parent.

Off, ``span`` and ``unit`` return one shared null context after a flag
check and ``count`` returns at once.  On, a span

* enters a ``_RecordFunctionFast`` range: a plain CPU operation in any
  ``torch.profiler`` trace taken meanwhile (a ``record_function`` range
  is a user annotation, which the profiler mirrors onto the device's
  timeline), on the profiler's clock;
* reads ``time.time_ns()`` (the same epoch clock) at entry and exit;
* records a CUDA event pair on the current stream where the unit runs on
  a CUDA tensor, whose elapsed time is the span's device ms; elsewhere
  the host interval is its ms.

Counters add their values a unit; a tensor is summed on its device.
Only ``totals`` and ``records`` wait for the device and read it back.
The last ``KEEP_UNITS`` closed units are kept.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Deque, Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

KEEP_UNITS = 16
_NULL = contextlib.nullcontext()


class _Unit:
    __slots__ = ("uid", "cuda", "spans", "counters")

    def __init__(self, uid: int, cuda: bool):
        self.uid, self.cuda = uid, cuda
        self.spans: List[_Span] = []
        self.counters: Dict[str, List[Any]] = {}


class _Span:
    __slots__ = ("rec", "unit", "name", "parent", "t0", "t1", "ev0", "ev1",
                 "_rf")

    def __init__(self, rec: "Recorder", unit: _Unit, name: str):
        self.rec, self.unit, self.name = rec, unit, name

    def _mark(self):
        if not self.unit.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        self.t0 = time.time_ns()
        self.ev0 = self._mark()
        return self

    def __exit__(self, *exc):
        self.ev1 = self._mark()
        self.t1 = time.time_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        self.rec._stack().pop()
        self.unit.spans.append(self)
        return False

    def ms(self) -> float:
        """Device ms (after a synchronise), or host ms off CUDA."""
        if self.ev0 is not None:
            return self.ev0.elapsed_time(self.ev1)
        return (self.t1 - self.t0) / 1e6


class _UnitSpan(_Span):
    """The root span: opens its unit on entry, files it on exit."""
    __slots__ = ()

    def __enter__(self):
        self.rec._open = self.unit
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self.rec._open = None
            self.rec._units.append(self.unit)


class Recorder:
    """Spans and counters of the last ``KEEP_UNITS`` units."""

    def __init__(self):
        self.on = False
        self._open: Optional[_Unit] = None
        self._units: Deque[_Unit] = collections.deque(maxlen=KEEP_UNITS)
        self._local = threading.local()
        self._next = 0

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def clear(self) -> None:
        """Drop the units recorded so far."""
        self._units.clear()

    def unit(self, name: str, like: Optional[torch.Tensor] = None):
        """The root span of one unit of work; ``like`` is a tensor of the
        work, whose device the unit is timed on.  Inside an open unit it
        is a plain span."""
        if not self.on:
            return _NULL
        if self._open is not None:
            return _Span(self, self._open, name)
        self._next += 1
        cuda = like is not None and like.device.type == "cuda"
        return _UnitSpan(self, _Unit(self._next, cuda), name)

    def span(self, name: str):
        """A span inside the open unit (the null context outside one)."""
        if not self.on:
            return _NULL
        unit = self._open
        if unit is None:
            return _NULL
        return _Span(self, unit, name)

    def count(self, name: str, value) -> None:
        """Add ``value`` (a number, or a tensor whose elements are summed
        on its device) to the open unit's counter ``name``."""
        if not self.on:
            return
        unit = self._open
        if unit is None:
            return
        if isinstance(value, torch.Tensor):
            value = value.sum()
        unit.counters.setdefault(name, []).append(value)

    def _last(self, last_units: Optional[int]) -> List[_Unit]:
        units = list(self._units)
        if last_units is not None:
            units = units[len(units) - min(last_units, len(units)):]
        if any(u.cuda for u in units):
            torch.cuda.synchronize()
        return units

    @staticmethod
    def _rows(u: _Unit) -> List[Dict]:
        index = {id(s): i for i, s in enumerate(u.spans)}
        return [{"name": s.name, "unit": u.uid,
                 "parent": index.get(id(s.parent)),
                 "start_ns": s.t0, "end_ns": s.t1, "ms": s.ms()}
                for s in u.spans]

    def records(self, last_units: Optional[int] = None) -> List[List[Dict]]:
        """The spans of the last ``last_units`` closed units (all kept, if
        None), a list a unit in the order they closed: ``name``, ``unit``
        (its id), ``parent`` (its index in the list, or None), ``start_ns``
        and ``end_ns`` (epoch clock), ``ms`` (device ms, or host ms off
        CUDA).  Synchronises the device."""
        return [self._rows(u) for u in self._last(last_units)]

    def totals(self, last_units: Optional[int] = None) -> Dict[str, Any]:
        """Over the units of ``records``: ``units``; per span name its
        ``calls``, ``ms``, ``self_ms`` (less its direct children's ms) and
        ``host_ms``; per counter its sum."""
        units = self._last(last_units)
        spans: Dict[str, Dict[str, float]] = {}
        counters: Dict[str, float] = {}
        for u in units:
            rows = self._rows(u)
            inner = [0.0] * len(rows)
            for r in rows:
                if r["parent"] is not None:
                    inner[r["parent"]] += r["ms"]
            for r, below in zip(rows, inner):
                row = spans.setdefault(r["name"], {"calls": 0, "ms": 0.0,
                                                   "self_ms": 0.0,
                                                   "host_ms": 0.0})
                row["calls"] += 1
                row["ms"] += r["ms"]
                row["self_ms"] += max(r["ms"] - below, 0.0)
                row["host_ms"] += (r["end_ns"] - r["start_ns"]) / 1e6
            for name, values in u.counters.items():
                counters[name] = counters.get(name, 0.0) + sum(
                    float(v) for v in values)
        return {"units": len(units), "spans": spans, "counters": counters}


_RECORDER = Recorder()
enable = _RECORDER.enable
disable = _RECORDER.disable
clear = _RECORDER.clear
unit = _RECORDER.unit
span = _RECORDER.span
count = _RECORDER.count
totals = _RECORDER.totals
records = _RECORDER.records


def enabled() -> bool:
    return _RECORDER.on
