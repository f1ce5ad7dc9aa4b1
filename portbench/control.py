"""The readings that a cell's limits are set from, on the card:

    python3 portbench/control.py --workload <cell> --program-seeds 1,2,... \
        --control-seeds 7,8,9 [--fault-seeds 4,5,6] [--out <file.jsonl>]

For each program seed: the program's numbers against the reference, as a
run compares them (scoring: the units of the run's sample, drawn from
the seed; training: the set-up's steps).  For each control seed: the
control's, the reference computed with fp8 products (``Prec(fp8=True)``)
put in the program's place.  For each fault seed: each planted fault's
readings (``testing.faults``; training's ``state_unchanged`` reads 1 by
the measure and is not run).  One JSON line a reading, with ``correct``
as a run of the cell would decide it by its limits
(``limits/<cell>.json``, through ``harness.judge``).  Scoring computes
the reference once a seed and holds the program, the control and the
faults of that seed to it.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness as H          # noqa: E402


def pool_of(cell):
    from portbench.tokens import Pool
    t = cell.traffic
    return Pool(cell.seed, t["pool_batches"], t["batch"], t["seq"],
                cell.conf["model"]["vocab_size"], cell.device)


def score_readings(cell, control: bool, faults=()):
    """{what: readings} of one seed: the program's (``program``) and each
    fault's, and with ``control`` the control's; each with the residual
    stream's gap to the reference's at each layer (``drift``, the check
    rows) and each layer's own gap (``steps``, the start first)."""
    from portbench.kinds import score
    from portbench.reference.common import Prec
    from portbench.testing import planted
    idx = score.sample(cell.seed, cell.traffic["check_from"],
                       cell.traffic["check_batches"])
    work = score.Work(cell)
    work.setup()
    got = {}
    for what in ("program",) + tuple(faults):
        fault = planted(what) if what != "program" \
            else contextlib.nullcontext()
        with fault:
            for i in idx:
                work.step(i)
        got[what] = {i: score.answers(work.answers[i]) for i in idx}
    pool = work.pool
    work.free()
    if control:
        got["control"] = score.reference(cell, pool, idx, Prec(True))
    forced = {w: {i: g[i]["layers"] for i in idx} for w, g in got.items()
              if all(g[i].get("layers") for i in idx)}
    want = score.reference(cell, pool, idx, Prec(False), forced)
    out = {}
    for what, g in got.items():
        r = score.gaps(g, want, what)
        r["signed"] = {a: [g[i][a] - want[i][a] for i in idx]
                       for a in score.ANSWERS}
        i = idx[0]
        states = g[i].get("layers")
        if states and want[i]["layers"]:
            r["drift"] = [score.rel(x, y) for x, y in
                          zip(states, want[i]["layers"])]
            r["steps"] = score.step_gaps(g[i].get("start"), states,
                                         want[i]["start"],
                                         want[i]["forced"].get(what, []))
        out[what] = r
    return out


def train_readings(cell, what: str):
    from portbench.kinds import train
    from portbench.reference.common import Prec
    if what == "control":
        pool = pool_of(cell)
        want = train.reference_steps(cell, pool, Prec(False))
        c = train.reference_steps(cell, pool, Prec(True))
        return train.readings(c["losses"], c["z"], c["first_grad"],
                              c["change"], want)
    from portbench.testing import planted
    work = train.Work(cell)
    fault = planted(what) if what != "program" else contextlib.nullcontext()
    with fault:
        work.setup()
    work.step_losses = []
    work.free()
    want = train.reference_steps(cell, work.pool, Prec(False))
    return train.readings(work.losses, work.zs, work.first, work.change,
                          want)


def judged(cell, readings) -> bool:
    checks = [{"name": k, "value": readings[k], "limit": lim}
              for k, lim in cell.limits.items()]
    return H.judge(checks, 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    H.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("not measured: no CUDA card", file=sys.stderr)
        return 3
    H.import_program()
    from portbench import testing
    bench = testing.bench()
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    prog, ctrl, flt = (seeds(x) for x in (a.program_seeds, a.control_seeds,
                                          a.fault_seeds))
    out = open(a.out, "a") if a.out else None
    for seed in dict.fromkeys(prog + ctrl + flt):
        t = time.perf_counter()
        cell = H.Cell(bench, a.workload, seed, 0, False, "cuda")
        faults = [f for f in testing.faults(cell.kind,
                                            cell.conf["model"]["family"])
                  if f != "state_unchanged"] if seed in flt else []
        if cell.kind == "score":
            rs = score_readings(cell, seed in ctrl, faults)
            if seed not in prog:
                rs.pop("program")
        else:
            whats = (["program"] if seed in prog else []) + \
                (["control"] if seed in ctrl else []) + faults
            rs = {w: train_readings(cell, w) for w in whats}
        for what, r in rs.items():
            line = json.dumps({"workload": a.workload, "what": what,
                               "seed": seed, "correct": judged(cell, r),
                               "readings": r,
                               "seconds": time.perf_counter() - t,
                               "card": H.card_line()})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
