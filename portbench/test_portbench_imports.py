"""What a run loads and where it refuses to run (CPU, subprocesses)."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from portbench import harness as H

ROOT = str(H.ROOT)
ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")


def test_a_run_loads_no_jax_and_no_reference_package():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from portbench import testing, harness as H\n"
        "testing.run_tiny('qwen3-moe-30b-a3b.score', trace=True)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=ENV, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in H.forbidden_modules()
    assert set(H.forbidden_modules()) <= set(H.FORBIDDEN)


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "rwkv6-3b.score", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, env=ENV, timeout=300, cwd=cwd)


def test_without_a_card_a_run_prints_no_result(tmp_path):
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "not measured" in out.stderr


def test_beside_the_benchmark_alone_a_run_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
