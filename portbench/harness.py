"""The benchmark's driver: it finds a cell's files by name, runs the cell
and prints its result.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix:

- ``configs/<config>.json``: the model's sizes (``model``, the port's
  ``ModelConfig`` fields), the settings each kind of traffic runs it
  with (``score``, ``train``), the plain reference that checks it
  (``reference/<reference>.py``), its source and what was assumed;
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names
  the driver of that kind of work, ``kinds/<kind>.py``;
- ``limits/<cell>.json``: each number that decides ``correct`` and its
  limit;
- ``metrics/<name>.py``: one reader a per-layer metric, which takes its
  number from what a traced run recorded, or finds none.

A run: set-up (weights from the seed on the card, warm-up, for training
the first steps), then the window: one unit of work after another until
``--seconds`` have passed, each waited for, the window ending with the
last unit.  A unit of the check's sample (drawn from the seed) that the
window did not reach runs after it, late and untimed.  With ``--trace
1`` a few more units run under the profiler, then as many again with
CUDA events around the program's entries that the metrics read.  Then
the program's state is freed and the reference checks the sample.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE = HERE / ".cache"


class BenchError(Exception):
    """A cell that cannot run as described; the run prints no result."""


# ---------------------------------------------------------------------------
# lookup by name
# ---------------------------------------------------------------------------

def load_json(path: Path) -> Any:
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_module(path: Path) -> ModuleType:
    """The Python file ``path`` as a module (names may hold dots)."""
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    rel = path.relative_to(HERE).as_posix()
    name = "_portbench_" + rel.replace("/", "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: Dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed there, or, with
    no list, in every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def e2e_metrics(bench: Dict, cell: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if applies(m, cell)]


def layer_metrics(bench: Dict, cell: str) -> List[Dict]:
    return [m for m in bench["per_layer"] if applies(m, cell)]


def judge(checks: List[Dict], failed: int) -> bool:
    """``correct``: every number compared within its limit, no answer
    that failed."""
    return all(c["value"] <= c["limit"] for c in checks) and failed == 0


class Cell:
    """Everything a kind's driver needs, found by the cell's name."""

    def __init__(self, bench: Dict, name: str, seed: int, seconds: float,
                 trace: bool, device: str, overrides: Optional[Dict] = None):
        o = overrides or {}
        self.bench, self.name = bench, name
        self.entry = find_cell(bench, name)
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = device
        self.conf = o.get("conf") or load_json(
            HERE / "configs" / f"{self.entry['config']}.json")
        self.traffic = o.get("traffic") or load_json(
            HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = o.get("limits") or load_json(
            HERE / "limits" / f"{name}.json")
        self.kind = self.traffic["kind"]
        self.reference = load_module(
            HERE / "reference" / f"{self.conf['reference']}.py")
        self.driver = load_module(HERE / "kinds" / f"{self.kind}.py")
        self.readers = {m["name"]: load_module(HERE / "metrics"
                                               / f"{m['name']}.py")
                        for m in layer_metrics(bench, name)} if trace else {}


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc builds go to src/repro_torch/kernels/build/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def import_program() -> ModuleType:
    """The port from this checkout's ``src``; nothing else will do."""
    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    try:
        import repro_torch
    except ImportError as e:
        raise BenchError(f"the program is not in this checkout: {e}")
    where = Path(repro_torch.__file__).resolve()
    if src.resolve() not in where.parents:
        raise BenchError(f"repro_torch came from {where}, not {src}")
    return repro_torch


def program_config(conf: Dict, kind: str):
    """The port's ``ModelConfig``: ``model``'s sizes with the kind's
    settings (those that are ``ModelConfig`` fields)."""
    import dataclasses
    from repro_torch.config import base
    fields = dict(conf["model"])
    for key, cls in (("moe", base.MoeConfig), ("rwkv", base.RwkvConfig),
                     ("mamba", base.MambaConfig)):
        if key in fields:
            fields[key] = cls(**fields[key])
    names = {f.name for f in dataclasses.fields(base.ModelConfig)}
    fields.update({k: v for k, v in conf[kind].items() if k in names})
    fields["name"] = conf["name"]
    return base.ModelConfig(**fields)


def kernel_counters() -> Dict[str, int]:
    from repro_torch.kernels import flash_attention as fa, gmm, \
        mamba_scan as mb, rwkv6_scan as rw
    return {"flash": fa.flash_attention.launches,
            "flash_wgmma": fa.flash_attention.route_launches["wgmma"],
            "gmm": gmm.gmm.launches,
            "gmm_wgmma": gmm.gmm.route_launches["wgmma"],
            "wkv6": rw.rwkv6_scan.launches,
            "mamba_scan": mb.mamba_scan.launches}


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not measured"


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

class Marks:
    """Seconds of each phase of a set-up, into ``work.phases``."""

    def __init__(self, work):
        import torch
        self.phases = work.__dict__.setdefault("phases", {})
        self.sync = torch.cuda.synchronize if work.cell.device == "cuda" \
            else (lambda: None)
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.phases[name] = now - self.t
        self.t = now


def run_cell(cell: Cell, t0: float) -> Dict:
    """Set-up, the window, the traced units, the check.  Returns the
    result's parts (no printing)."""
    import torch
    from portbench import trace as tr
    cuda = cell.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    work = cell.driver.Work(cell)
    work.phases = {"imports": time.perf_counter() - t0}
    work.setup()
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = kernel_counters()
    setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    units, tokens = 0, 0
    while True:
        tokens += work.step(units)
        sync()
        units += 1
        if time.perf_counter() - start >= cell.seconds:
            break
    window_s = time.perf_counter() - start
    after = kernel_counters()
    counters = {k + "_per_unit": (after[k] - before[k]) / units
                for k in before}
    late = work.due(units)          # sampled units the window left undone
    for i in late:
        work.step(i)
    sync()
    traced = None
    if cell.trace:
        traced = tr.traced_units(cell, work, max([units - 1] + late) + 1,
                                 sync)
        traced.update(window_s=window_s, units=units, tokens=tokens,
                      model_flops=tokens * work.flops_per_token())
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    work.free()
    t = time.perf_counter()
    checks, failed = work.check(units)
    check_s = time.perf_counter() - t
    return dict(setup_s=setup_s, window_s=window_s, units=units,
                tokens=tokens, rate=tokens / window_s, rate_name=work.RATE,
                counters=counters, trace=traced, peak=peak, checks=checks,
                failed=failed, readings=getattr(work, "readings", {}),
                check_s=check_s, phases=work.phases, late=late)


def result_line(cell: Cell, r: Dict) -> Dict:
    values = {"setup_s": r["setup_s"], r["rate_name"]: r["rate"]}
    metrics = {}
    if not cell.trace:
        for m in e2e_metrics(cell.bench, cell.name):
            if m["name"] not in values:
                raise BenchError(f"{cell.name} reports no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in layer_metrics(cell.bench, cell.name):
            v = cell.readers[m["name"]].read(r["trace"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    import torch
    cuda = cell.device == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.entry["chips"],
              "memory_peak_bytes": r["peak"]}
    out: Dict[str, Any] = {
        "correct": judge(r["checks"], r["failed"]),
        "attempted": r["units"], "failed": r["failed"],
        "metrics": metrics, "device": device}
    if cell.trace:
        t = r["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["traced_s"])
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
        out["port_kernels"] = t["port_kernels"]
    out["card"] = card_line() if cuda else "cpu"
    out["counters"] = r["counters"]
    out["readings"] = dict(r["readings"], check_s=r["check_s"],
                           late_units=r["late"], setup_phases=r["phases"])
    out["checks"] = r["checks"]
    return out


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: List[str], t0: float) -> int:
    args = parse(argv)
    try:
        bench = benchmark()
        need = find_cell(bench, args.workload)["chips"]
        cache_env()
        import torch
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"not measured: this cell needs {need} CUDA card(s), "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 3
        import_program()
        cell = Cell(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda")
        r = run_cell(cell, t0)
        out = result_line(cell, r)
    except BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 4
    for c in out["checks"]:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
