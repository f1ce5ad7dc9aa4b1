"""The port stands alone: it imports neither jax nor the reference package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_import_repro_torch_loads_no_jax():
    pytest.importorskip("torch")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15, out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))", re.M)


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "examples").glob("*_torch.py"))
    + sorted((ROOT / "experiments").glob("*_torch.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_never_imports_jax_or_repro(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, (path, hits)
