"""``experiments/make_report_torch.py`` on artifacts that ``dryrun.lower_cell``
writes for tiny cells over fake 4- and 8-rank meshes: tiny qwen3-4b's
train_4k on both meshes (its vocab cut to 511, which a 2-way ``model`` axis
does not divide, so the sanitizer keeps the tables whole) and tiny
qwen3-8b's decode_32k on the single mesh.  Every number in the report's
rows is held to the JSON it came from (four significant digits; bytes
against the artifact's ``hbm_bytes``), and each of the other 61 cells of
the matrix prints as missing.  The fake process group is process-global,
so the cells are lowered in a subprocess.  Also
``experiments/peak_by_frame_torch.py`` on a tiny cell."""
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.configs import ARCH_IDS, cells
from test_torch_dryrun import _python

ROOT = Path(__file__).resolve().parent.parent
LOWERED = [("qwen3-4b", "train_4k", "single"), ("qwen3-4b", "train_4k", "multi"),
           ("qwen3-8b", "decode_32k", "single")]


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    art_dir = tmp_path_factory.mktemp("artifacts_torch")
    _python("""
        import json, sys
        from repro_torch.config import ShapeConfig
        from repro_torch.configs import get_shape, get_tiny_config
        from repro_torch.launch import dryrun

        for arch, shape, mesh in json.loads(sys.argv[2]):
            cfg = get_tiny_config(arch)
            cell = None
            if shape == "train_4k":
                cfg = cfg.replace(vocab_size=511)
                cell = ShapeConfig(shape, get_shape(shape).kind, 8, 16)
            art = dryrun.lower_cell(
                arch, shape, mesh, model=cfg, shape=cell,
                mesh_shape=(2, 2) if mesh == "single" else (2, 2, 2))
            dryrun.save_artifact(art, sys.argv[1])
        print(json.dumps("ok"))
    """, str(art_dir), json.dumps(LOWERED), limit=240)
    spec = importlib.util.spec_from_file_location(
        "_make_report_torch", ROOT / "experiments" / "make_report_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    arts = {(a["arch"], a["shape"], a["mesh"]): a
            for a in (json.loads(p.read_text())
                      for p in sorted(art_dir.glob("*.json")))}
    return mod, art_dir, arts


def _tables(out):
    """{section title: [row cells]} of the report's markdown tables."""
    tables = {}
    for part in out.split("### ")[1:]:
        title, body = part.split("\n", 1)
        rows = [[c.strip() for c in line.strip().strip("|").split("|")]
                for line in body.splitlines() if line.startswith("|")]
        tables[title] = rows[2:]                  # header and rule dropped
    return tables


def _close(text, value):
    tol = 0.5 if abs(value) >= 1000 else 5e-4 * abs(value)
    assert abs(float(text) - value) <= tol, (text, value)


def _section(tables, start):
    (rows,) = [r for t, r in tables.items() if t.startswith(start)]
    return rows


def test_report_rows_hold_the_artifacts_numbers(report, capsys):
    mod, art_dir, arts = report
    assert sorted(arts) == sorted(LOWERED)
    mod.main(["--art", str(art_dir)])
    tables = _tables(capsys.readouterr().out)

    matrix = {tuple(r[:3]): r[3:] for r in _section(tables, "Dry-run")}
    for key, a in arts.items():
        policy, args_gb, peak_gb, hbm, trace = matrix[key]
        m = a["memory"]
        assert policy == a["policy"]
        _close(args_gb, m["argument_bytes"] / 1e9)
        _close(peak_gb, m["peak_bytes"] / 1e9)
        assert m["hbm_bytes"] == 80e9
        assert hbm == ("fits" if m["peak_bytes"] <= 80e9 else "OVER") + \
            " 80 GB"
        assert float(trace) == a["trace_s"]

    roof = {tuple(r[:3]): r[3:] for r in _section(tables, "Roofline")}
    assert sorted(roof) == sorted(arts)
    for key, a in arts.items():
        comp, mem, coll, dominant, useful = roof[key]
        r = a["roofline"]
        _close(comp, r["compute_s"] * 1e3)
        _close(mem, r["memory_s"] * 1e3)
        _close(coll, r["collective_s"] * 1e3)
        assert dominant == r["dominant"]
        _close(useful, a["useful_flops_ratio"])

    (row,) = _section(tables, "Multi-pod")
    assert row[:2] == ["qwen3-4b", "train_4k"]
    single = arts[("qwen3-4b", "train_4k", "single")]["roofline"]
    multi = arts[("qwen3-4b", "train_4k", "multi")]["roofline"]
    _close(row[2], single["collective_s"] * 1e3)
    _close(row[3], multi["collective_s"] * 1e3)
    _close(row[4], (multi["collective_s"] - single["collective_s"]) * 1e3)

    rep = _section(tables, "Leaves kept whole")
    want = [(key, r) for key, a in arts.items() for r in a["replicated"]]
    assert len(want) >= 2            # the 511-row tables on both meshes
    assert len(rep) == len(want)
    got = {(tuple(r[:3]), r[3]): r[4:] for r in rep}
    for key, r in want:
        shape, spec, nbytes = got[(key, r["leaf"])]
        assert shape == str(r["shape"])
        assert re.fullmatch(r"\(.*\)", spec)
        assert int(nbytes) == r["bytes_per_device"] > 0


def test_report_marks_every_cell_without_an_artifact_missing(report, capsys):
    mod, art_dir, arts = report
    mod.main(["--art", str(art_dir)])
    rows = _section(_tables(capsys.readouterr().out), "Dry-run")
    want = {(arch, shape, mesh) for arch in ARCH_IDS
            for shape in cells(arch) for mesh in ("single", "multi")}
    assert len(want) == 64
    assert sorted(tuple(r[:3]) for r in rows) == sorted(want)
    for r in rows:
        missing = tuple(r[:3]) not in arts
        assert (r[3:] == ["missing"] * 5) == missing, r


def test_compact_report_holds_both_meshes_in_one_row(report, capsys):
    mod, art_dir, arts = report
    mod.main(["--art", str(art_dir), "--compact"])
    lines = capsys.readouterr().out.splitlines()
    rows = {r[0]: r[1:] for r in
            ([c.strip() for c in line.strip().strip("|").split("|")]
             for line in lines[2:])}
    assert len(rows) == 32
    one, two = (arts[("qwen3-4b", "train_4k", m)] for m in ("single",
                                                             "multi"))
    args, peak, dominant, terms, useful, trace = rows[
        f"qwen3-4b train_4k ({one['policy']})"]
    for text, key in ((args, "argument_bytes"), (peak, "peak_bytes")):
        for t, a in zip(text.split(" / "), (one, two)):
            value, *over = t.split(" ")
            _close(value, a["memory"][key] / 1e9)
            assert over == (["(>80)"] if a["memory"][key] > 80e9 else [])
    assert dominant == " / ".join(sorted({one["roofline"]["dominant"],
                                          two["roofline"]["dominant"]}))
    got = re.fullmatch(r"(.*) \((.*)\)", terms).groups()
    for text, a in zip(got, (one, two)):
        for t, k in zip(text.split(" / "),
                        ("compute_s", "memory_s", "collective_s")):
            _close(t, a["roofline"][k] * 1e3)
    _close(useful, one["useful_flops_ratio"])
    assert [float(t) for t in trace.split(" / ")] == [one["trace_s"],
                                                     two["trace_s"]]
    missing = [k for k, v in rows.items() if v == ["missing"] * 6]
    assert len(missing) == 31         # qwen3-8b's decode has one mesh only


def test_report_imports_nothing_of_the_reference():
    src = (ROOT / "experiments" / "make_report_torch.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(repro|jax|torch)\b(?!_)",
                         src, re.M)


def test_peak_by_frame_sums_the_live_bytes_at_the_peak():
    """``experiments/peak_by_frame_torch.py`` on tiny jamba's train cell:
    its snapshot's frames sum to its live bytes, within 1% of the peak,
    and the scan's Mamba layers and the step's grads are among them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, str(ROOT / "experiments" / "peak_by_frame_torch.py"),
         "--arch", "jamba-1.5-large-398b", "--shape", "train_4k", "--tiny"],
        capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    peak, live, by = got["peak_bytes"], got["snapshot_bytes"], got["by_frame"]
    assert sum(by.values()) == live <= peak <= 1.01 * live
    assert by["arguments"] > 0
    assert any(f.startswith("repro_torch/models/mamba.py:") for f in by)
    assert "repro_torch/train/step.py:train_step" in by
