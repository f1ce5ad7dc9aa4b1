"""Tables of the port's dry-run from its artifacts (markdown on stdout).

The port's counterpart of ``make_report.py``: it reads the JSON that
``python -m repro_torch.launch.dryrun`` writes into
``experiments/artifacts_torch/`` (one a cell: ``<arch>__<shape>__<mesh>
[__<tag>].json``) and prints

  * the dry-run matrix: argument and peak bytes a rank against the
    artifact's ``memory.hbm_bytes`` (an H100's 80 GB), and the trace's
    wall seconds; every cell of ``repro_torch.configs.cells`` on both
    meshes that has no artifact gets a row marked "missing";
  * the roofline terms a rank (H100 datasheet constants,
    ``launch/roofline.py``), the dominant term and the useful FLOPs
    (model FLOPs over the FLOPs a rank runs);
  * what the second pod adds to the collective term;
  * the parameter leaves the sanitizer keeps whole on an axis that does
    not divide them, with the bytes a rank holds of each;

or with ``--compact`` one table of a row a cell, its two meshes side by
side (the form ``PERF.md`` keeps).

Numbers keep at least four significant digits (trace seconds two
decimals, as the artifact rounds them; a replicated leaf's bytes whole).

Usage (from the repo root):
  PYTHONPATH=src python experiments/make_report_torch.py [--art DIR] [--compact]
"""
import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import ARCH_IDS, cells

ART = os.path.join(os.path.dirname(__file__), "artifacts_torch")
MESHES = ("single", "multi")


def load(art_dir):
    """{(arch, shape, mesh, tag): artifact} of every JSON in ``art_dir``."""
    out = {}
    for p in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(p) as f:
            a = json.load(f)
        out[(a["arch"], a["shape"], a["mesh"], a.get("tag") or "")] = a
    return out


def _order(key):
    arch, shape, mesh, tag = key
    shapes = cells(arch) if arch in ARCH_IDS else []
    return (ARCH_IDS.index(arch) if arch in ARCH_IDS else len(ARCH_IDS),
            arch, shapes.index(shape) if shape in shapes else len(shapes),
            shape, MESHES.index(mesh) if mesh in MESHES else 2, mesh, tag)


def _num(x):
    """At least four significant digits, with no exponent above 1000."""
    return f"{x:.0f}" if abs(x) >= 1000 else f"{x:.4g}"


def _label(key):
    arch, shape, mesh, tag = key
    return f"| {arch} | {shape} | {mesh}{f' ({tag})' if tag else ''} "


def matrix(arts):
    want = {(arch, shape, mesh, "") for arch in ARCH_IDS
            for shape in cells(arch) for mesh in MESHES}
    print("### Dry-run matrix (single pod 16 x 16 = 256 ranks, multi-pod "
          "2 x 16 x 16 = 512)\n")
    print("| arch | shape | mesh | policy | args GB a rank | peak GB a rank "
          "| against HBM | trace s |")
    print("|---|---|---|---|---|---|---|---|")
    for key in sorted(want | set(arts), key=_order):
        a = arts.get(key)
        if a is None:
            print(_label(key) + "| missing | missing | missing | missing "
                  "| missing |")
            continue
        m = a["memory"]
        fits = "fits" if m["peak_bytes"] <= m["hbm_bytes"] else "OVER"
        print(_label(key) + f"| {a['policy']} "
              f"| {_num(m['argument_bytes'] / 1e9)} "
              f"| {_num(m['peak_bytes'] / 1e9)} "
              f"| {fits} {m['hbm_bytes'] / 1e9:.0f} GB "
              f"| {a['trace_s']:.2f} |")


def roofline(arts):
    print("\n### Roofline terms (ms a step, a rank)\n")
    print("| arch | shape | mesh | compute ms | memory ms | collective ms "
          "| dominant | useful FLOPs |")
    print("|---|---|---|---|---|---|---|---|")
    for key in sorted(arts, key=_order):
        a = arts[key]
        r, u = a["roofline"], a.get("useful_flops_ratio")
        print(_label(key) + f"| {_num(r['compute_s'] * 1e3)} "
              f"| {_num(r['memory_s'] * 1e3)} "
              f"| {_num(r['collective_s'] * 1e3)} | {r['dominant']} "
              f"| {'-' if u is None else _num(u)} |")


def multipod(arts):
    print("\n### Multi-pod collective deltas (ms a step, a rank)\n")
    print("| arch | shape | collective ms single | collective ms multi "
          "| pod-axis cost ms |")
    print("|---|---|---|---|---|")
    for key in sorted(arts, key=_order):
        arch, shape, mesh, tag = key
        other = arts.get((arch, shape, "multi", tag))
        if mesh != "single" or other is None:
            continue
        cs = arts[key]["roofline"]["collective_s"] * 1e3
        cm = other["roofline"]["collective_s"] * 1e3
        sign = "+" if cm >= cs else ""
        print(f"| {arch} | {shape}{f' ({tag})' if tag else ''} "
              f"| {_num(cs)} | {_num(cm)} | {sign}{_num(cm - cs)} |")


def replicated(arts):
    print("\n### Leaves kept whole by the sanitizer\n")
    print("| arch | shape | mesh | leaf | shape | spec | bytes a rank |")
    print("|---|---|---|---|---|---|---|")
    for key in sorted(arts, key=_order):
        for r in arts[key].get("replicated", []):
            spec = ", ".join("None" if s is None else str(s)
                             for s in r["spec"])
            print(_label(key) + f"| {r['leaf']} | {r['shape']} | ({spec}) "
                  f"| {r['bytes_per_device']} |")


def compact(arts):
    print("| Cell (policy) | Args GB a rank, single / multi | Peak GB a "
          "rank, single / multi | Dominant | Compute / memory / collective "
          "ms, single (multi) | Useful FLOPs | Trace s, single / multi |")
    print("|---|---|---|---|---|---|---|")
    for arch in ARCH_IDS:
        for shape in cells(arch):
            one, two = (arts.get((arch, shape, m, "")) for m in MESHES)
            if one is None or two is None:
                print(f"| {arch} {shape} | missing | missing | missing "
                      "| missing | missing | missing |")
                continue

            def both(f, over=False):
                def mark(a):
                    m = a["memory"]
                    return f" (>{m['hbm_bytes'] / 1e9:.0f})" if over and \
                        m["peak_bytes"] > m["hbm_bytes"] else ""
                return " / ".join(_num(f(a)) + mark(a) for a in (one, two))

            def terms(a):
                r = a["roofline"]
                return " / ".join(_num(r[k] * 1e3) for k in (
                    "compute_s", "memory_s", "collective_s"))

            def gb(key):
                return lambda a: a["memory"][key] / 1e9

            dom = {one["roofline"]["dominant"], two["roofline"]["dominant"]}
            u = one.get("useful_flops_ratio")
            print(f"| {arch} {shape} ({one['policy']}) "
                  f"| {both(gb('argument_bytes'))} "
                  f"| {both(gb('peak_bytes'), over=True)} "
                  f"| {' / '.join(sorted(dom))} "
                  f"| {terms(one)} ({terms(two)}) "
                  f"| {'-' if u is None else _num(u)} "
                  f"| {one['trace_s']:.2f} / {two['trace_s']:.2f} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default=ART,
                    help="directory of dry-run artifacts")
    ap.add_argument("--compact", action="store_true",
                    help="one row a cell, both meshes side by side")
    args = ap.parse_args(argv)
    arts = load(args.art)
    if args.compact:
        compact(arts)
        return
    matrix(arts)
    roofline(arts)
    multipod(arts)
    replicated(arts)


if __name__ == "__main__":
    main()
