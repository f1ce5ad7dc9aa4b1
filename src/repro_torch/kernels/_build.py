"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/lib<name>-<hash>.so`` beside this file (``build/`` is ignored
by git).  The hash covers the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  Nothing here runs
when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (loaded library, seconds the build took, nvcc's output)
_LOADED: Dict[str, Tuple[ctypes.CDLL, float, str]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(name: str) -> Tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.

    Returns (library path, build seconds, nvcc's output).  A failed build
    raises with the compiler's output.
    """
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    os.replace(tmp, out)
    return out, seconds, log


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiling it on the first call."""
    if name not in _LOADED:
        path, seconds, log = build(name)
        _LOADED[name] = (ctypes.CDLL(str(path)), seconds, log)
    return _LOADED[name][0]


def build_report(name: str) -> Tuple[float, str]:
    """(build seconds, nvcc output) of a library already loaded."""
    _, seconds, log = _LOADED[name]
    return seconds, log
