"""Each planted fault's readings of a scoring cell on the card, one fault
to a computation of the reference:

    python3 portbench/control_each.py --workload <cell> --seeds 4,5,6 \
        [--faults flash_not_causal,...] [--out <file.jsonl>]

``control.py --fault-seeds`` holds every fault of a seed to one
computation of the reference, so it keeps the captured residual streams
of the program and of every fault at once; at jamba2-mini.score's size
(2 x 16,384 tokens, a superblock's stream captured a block) that does
not fit the card.  Here each fault is read beside the program against a
reference of its own; the program's reading is kept from the first
fault of each seed.  The lines are ``control.py``'s (``seconds`` since
the seed's start), with ``correct`` as a run of the cell would decide it
by its limits.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import control                # noqa: E402
from portbench import harness as H          # noqa: E402


def readings(cell, faults):
    """(what, readings) of the program, then of each fault in turn, each
    fault with a reference of its own."""
    for j, fault in enumerate(faults):
        rs = control.score_readings(cell, False, [fault])
        if j:
            rs.pop("program")
        yield from rs.items()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    H.cache_env()
    # one fault's captures freed before the next: let the allocator
    # give their segments back rather than keep them split
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("not measured: no CUDA card", file=sys.stderr)
        return 3
    H.import_program()
    from portbench import testing
    bench = testing.bench()
    out = open(a.out, "a") if a.out else None
    for seed in [int(x) for x in a.seeds.split(",") if x]:
        t = time.perf_counter()
        cell = H.Cell(bench, a.workload, seed, 0, False, "cuda")
        if cell.kind != "score":
            raise H.BenchError(f"{a.workload}: scoring cells only")
        faults = [f for f in a.faults.split(",") if f] or \
            list(testing.faults(cell.kind, cell.conf["model"]["family"]))
        for what, r in readings(cell, faults):
            line = json.dumps({"workload": a.workload, "what": what,
                               "seed": seed,
                               "correct": control.judged(cell, r),
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
