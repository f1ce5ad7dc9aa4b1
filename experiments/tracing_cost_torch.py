"""What the port's tracing (``repro_torch.tracing``) costs on a benchmark
cell, and whether its spans agree with CUDA events around the kernel
entries and with the profiler:

    python experiments/tracing_cost_torch.py --workload <cell> --seed <n> \
        [--units 10] [--pairs 4] [--out <file.json>] [--device cpu]

The cell is set up as ``portbench/run.py`` sets it up (weights and tokens
from the seed, its warm-up), then, on units past the check's sample:

1. the on cost: ``units`` eval steps with tracing off, then on, in turns
   (off, on; on, off; ...), ``pairs`` pairs, each step waited for; the
   tokens/s of each turn;
2. the spans of ``units`` traced steps, a unit;
3. as many again with CUDA events around ``kernels.ops.rwkv6_scan`` and
   ``gmm_equal``: ``rwkv.wkv6`` and ``moe.experts`` against those calls,
   and the share of each ``eval_step`` that its top-level spans cover;
4. ``units`` steps under ``torch.profiler`` with tracing off, then on: the
   device's busy share, the device events that carry a span's name (none
   should), the longest idle gaps as ``portbench/trace.py`` names them.

One JSON object on the last line of standard output (and in ``--out``).
``--device cpu`` runs it at the benchmark's tiny test sizes, for a
rehearsal: its times are the CPU's, no speed of the card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OPS = "repro_torch.kernels.ops"
ENTRIES = ("rwkv6_scan", "gmm_equal")


def per_unit(totals, n):
    return {"spans": {k: {f: v / n for f, v in row.items()}
                      for k, row in totals["spans"].items()},
            "counters": {k: v / n for k, v in totals["counters"].items()}}


def main(argv) -> dict:
    ap = argparse.ArgumentParser(prog="experiments/tracing_cost_torch.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=10)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from portbench import harness as H
    H.cache_env()
    H.import_program()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace as tr
    from repro_torch import tracing

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("not measured: no CUDA card")
    over = None
    if not cuda:
        from portbench import testing
        over = testing.tiny_overrides(args.workload)
    cell = H.Cell(H.benchmark(), args.workload, args.seed, 0.0, False,
                  args.device, overrides=over)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tracing.disable()
    work = cell.driver.Work(cell)
    work.setup()
    nxt = [cell.traffic["check_from"]]          # past the check's sample
    n = args.units

    def run() -> float:
        sync()
        t, tokens = time.perf_counter(), 0
        for _ in range(n):
            tokens += work.step(nxt[0])
            sync()
            nxt[0] += 1
        return tokens / (time.perf_counter() - t)

    out = {"workload": args.workload, "seed": args.seed, "units": n,
           "card": H.card_line() if cuda else "cpu"}

    # 1. the on cost, in turns
    rates = {"off": [], "on": []}
    for k in range(args.pairs):
        for side in (("off", "on") if k % 2 == 0 else ("on", "off")):
            (tracing.enable if side == "on" else tracing.disable)()
            rates[side].append(run())
    med = {s: statistics.median(v) for s, v in rates.items()}
    out["cost"] = {"rates": rates, "median": med,
                   "on_over_off": med["on"] / med["off"]}

    # 2. the spans, a unit
    tracing.enable()
    run()
    out["a_unit"] = per_unit(tracing.totals(last_units=n), n)

    # 3. against the entries' CUDA events, over the same units
    timer = tr.EntryTimer(cuda)
    for attr in ENTRIES:
        timer.wrap(OPS, attr)
    try:
        run()
    finally:
        timer.restore()
    sync()
    calls = timer.calls()
    got = tracing.totals(last_units=n)["spans"]
    cover = []
    for rows in tracing.records(last_units=n):
        root = next(j for j, r in enumerate(rows)
                    if r["parent"] is None and r["name"] == "eval_step")
        top = sum(r["ms"] for r in rows if r["parent"] == root)
        cover.append(top / rows[root]["ms"])
    out["check"] = {
        "wkv6_span_ms": got.get("rwkv.wkv6", {}).get("ms"),
        "wkv6_entry_ms": sum(r["ms"] for r in calls[f"{OPS}:rwkv6_scan"]),
        "experts_span_ms": got.get("moe.experts", {}).get("ms"),
        "gmm_entry_ms": sum(r["ms"] for r in calls[f"{OPS}:gmm_equal"]),
        "top_cover_min": min(cover), "top_cover_max": max(cover)}

    # 4. under the profiler, tracing off then on
    names = set(got)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out["profile"] = {}
    for side in ("off", "on"):
        (tracing.enable if side == "on" else tracing.disable)()
        sync()
        with profile(activities=acts) as prof:
            t = time.perf_counter()
            run()
            traced_s = time.perf_counter() - t
        p = tr.read_profile(prof)
        events = tr._events(prof)
        out["profile"][side] = {
            "idle_pct": 100.0 * (1.0 - p["busy_s"] / traced_s),
            "device_events_named_as_spans": sum(
                1 for e in events if e.device_type() == DeviceType.CUDA
                and e.name() in names),
            "host_events_named_as_spans": sum(
                1 for e in events if e.device_type() == DeviceType.CPU
                and e.name() in names),
            "device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
    tracing.disable()
    work.free()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
