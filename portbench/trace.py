"""What a traced run records, after its window: a few more units of work
under ``torch.profiler``, then as many again outside it with CUDA events
around the program entries that the cell's per-layer readers name
(``ENTRIES`` in ``metrics/<name>.py``: (module, function, info) triples;
``info(args, kwargs, out)`` gives the numbers a reader needs of a call,
as tensors or numbers, read once the units are done).  What ``info``
launches on the card runs after the call's end event and never inside
the profiled units.

From the profiler: the device's busy time, the union of the intervals in
which an operation ran on the card, over the traced wall time; the
device operations that took most time; the longest idle gaps, each named
by the host operation that was running in it; the seconds and launches
of the port's own kernels, by their symbols (``flops.port_kernel``).
"""
from __future__ import annotations

import importlib
import time
from typing import Any, Callable, Dict, List, Tuple

from portbench import flops

TOP = 10
NAME = 160        # characters of a kernel's name kept in the breakdown


class EntryTimer:
    """Device time of each call of wrapped functions (CUDA events; host
    clock on the CPU, where the tests drive it)."""

    def __init__(self, cuda: bool):
        import torch
        self.torch, self.cuda = torch, cuda
        self.records: Dict[str, List[Tuple[Any, Any, Dict]]] = {}
        self._restore: List[Tuple[Any, str, Callable]] = []

    def _mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wrap(self, module_name: str, attr: str, info=None) -> None:
        key = f"{module_name}:{attr}"
        if key in self.records:
            return
        module = importlib.import_module(module_name)
        orig = getattr(module, attr)
        recs = self.records[key] = []

        def timed(*args, **kwargs):
            start = self._mark()
            out = orig(*args, **kwargs)
            end = self._mark()
            recs.append((start, end, info(args, kwargs, out) if info else {}))
            return out

        setattr(module, attr, timed)
        self._restore.append((module, attr, orig))

    def restore(self) -> None:
        for module, attr, orig in reversed(self._restore):
            setattr(module, attr, orig)
        self._restore.clear()

    def calls(self) -> Dict[str, List[Dict]]:
        """{entry: [{"ms": device ms, **info as numbers}]} (after a sync)."""
        out = {}
        for key, recs in self.records.items():
            rows = []
            for start, end, info in recs:
                ms = start.elapsed_time(end) if self.cuda \
                    else (end - start) * 1e3
                row = {k: (v.item() if hasattr(v, "item") else v)
                       for k, v in info.items()}
                row["ms"] = ms
                rows.append(row)
            out[key] = rows
        return out


def union_s(intervals: List[Tuple[int, int]]) -> float:
    """Seconds covered by [start_ns, end_ns) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def gaps(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The idle gaps between the merged intervals, longest first."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return sorted(out, key=lambda g: g[0] - g[1])


def _events(prof) -> List[Any]:
    results = getattr(prof.profiler, "kineto_results", None)
    return list(results.events()) if results is not None else []


def read_profile(prof) -> Dict[str, Any]:
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in _events(prof):
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        (dev if e.device_type() == DeviceType.CUDA else host).append(span)
    by_name: Dict[str, float] = {}
    port: Dict[str, List[float]] = {}
    for s, e, name in dev:
        by_name[name[:NAME]] = by_name.get(name[:NAME], 0.0) + (e - s) / 1e9
        kernel = flops.port_kernel(name)
        if kernel is not None:
            seconds, n = port.get(kernel, (0.0, 0))
            port[kernel] = [seconds + (e - s) / 1e9, n + 1]
    iv = [(s, e) for s, e, _ in dev]
    named = []
    for gs, ge in gaps(iv)[:TOP]:
        mid = (gs + ge) // 2
        inside = [(e - s, n) for s, e, n in host if s <= mid < e]
        what = min(inside)[1] if inside else "no host operation"
        named.append([f"host: {what}"[:NAME], (ge - gs) / 1e9])
    return {"busy_s": union_s(iv),
            "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:TOP],
            "idle_gaps": named,
            "port_kernels": port,
            "device_events": len(dev)}


def traced_units(cell, work, first: int, sync) -> Dict[str, Any]:
    """``trace_units`` more units of ``work`` under the profiler, then as
    many under the readers' entry timers."""
    from torch.profiler import ProfilerActivity, profile
    cuda = cell.device == "cuda"
    n = int(cell.traffic.get("trace_units", 2))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for j in range(n):
            work.step(first + j)
        sync()
        traced_s = time.perf_counter() - t
    out = read_profile(prof)
    timer = EntryTimer(cuda)
    for reader in cell.readers.values():
        for module_name, attr, info in getattr(reader, "ENTRIES", ()):
            timer.wrap(module_name, attr, info)
    if timer.records:
        try:
            for j in range(n):
                work.step(first + n + j)
        finally:
            timer.restore()
        sync()
    out.update(traced_s=traced_s, traced_units=n, calls=timer.calls(),
               traffic=cell.traffic, model=cell.conf["model"])
    return out
