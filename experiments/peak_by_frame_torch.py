"""Where a dry-run cell's peak of live bytes goes.

Traces one cell as ``python -m repro_torch.launch.dryrun`` does, with
``launch/op_analysis.py``'s tracker extended to note, for every storage
it tracks, the innermost frame of the port's model, train or optim code
that made it ("arguments" for the cell's inputs).  Whenever the live
bytes pass the last snapshot by 1%, it sums the live storages by that
frame; the last snapshot, within 1% of the peak, is printed as a table
(GB a rank, frame).

Usage (from the repo root):
  PYTHONPATH=src python experiments/peak_by_frame_torch.py --arch jamba-1.5-large-398b --shape train_4k --mesh single
  PYTHONPATH=src python experiments/peak_by_frame_torch.py --arch jamba-1.5-large-398b --shape train_4k --tiny
"""
import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.config import ShapeConfig
from repro_torch.configs import ARCH_IDS, get_shape, get_tiny_config
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import OpAnalysis

_OWN = tuple(os.sep + os.path.join("repro_torch", d) + os.sep
             for d in ("models", "train", "optim"))


def _frame() -> str:
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        for own in _OWN:
            if own in name:
                return f"{name[name.index(own) + 1:]}:{f.f_code.co_name}"
        f = f.f_back
    return "arguments"


class PeakByFrame(OpAnalysis):
    """``OpAnalysis`` that keeps the snapshot described above."""

    def __init__(self):
        super().__init__()
        self.made = {}
        self.snapshot = (0, {})

    def _add(self, t):
        key = t.untyped_storage()._cdata
        if key not in self._storages:
            self.made[key] = _frame()
        super()._add(t)
        if self.live > 1.01 * self.snapshot[0]:
            by = collections.Counter()
            for k, ref in list(self._storages.items()):
                st = ref()
                if st is not None:
                    by[self.made.get(k, "arguments")] += st.nbytes()
            self.snapshot = (self.live, dict(by))


def peak_by_frame(arch, shape_name, mesh, *, tiny=False):
    """(the cell's artifact, (live bytes at the snapshot, {frame: bytes}))."""
    kw = {}
    if tiny:
        kw = dict(model=get_tiny_config(arch), mesh_shape=(2, 2) if
                  mesh == "single" else (2, 2, 2))
        kind = get_shape(shape_name).kind
        if kind != "decode":
            kw["shape"] = ShapeConfig(shape_name, kind, 8, 16)
    seen = []

    class Recorder(PeakByFrame):
        def __init__(self):
            super().__init__()
            seen.append(self)

    dryrun.OpAnalysis = Recorder
    try:
        art = dryrun.lower_cell(arch, shape_name, mesh, **kw)
    finally:
        dryrun.OpAnalysis = OpAnalysis
    return art, seen[0].snapshot


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny config, 16 rows of 8 tokens, a 2x2 "
                         "(2x2x2) fake mesh")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    art, (live, by) = peak_by_frame(args.arch, args.shape, args.mesh,
                                    tiny=args.tiny)
    print(f"peak {art['memory']['peak_bytes'] / 1e9:.4g} GB a rank; "
          f"snapshot at {live / 1e9:.4g} GB")
    print("| GB a rank | frame that made it |")
    print("|---|---|")
    for frame, n in sorted(by.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"| {n / 1e9:.4g} | {frame} |")
    print(json.dumps({"peak_bytes": art["memory"]["peak_bytes"],
                      "snapshot_bytes": live, "by_frame": by}))


if __name__ == "__main__":
    main()
