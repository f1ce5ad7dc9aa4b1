"""What the kernel probes (``probe_gmm``, ``probe_flash``) share: variant
builds of a kernel source and device timing.  Needs a CUDA card and nvcc;
nothing runs at import.
"""
from __future__ import annotations

import ctypes
import subprocess

import torch

from repro_torch.kernels import _build


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def variant_lib(source: str, name: str, edits) -> ctypes.CDLL:
    """``csrc/<source>.cu`` with each (old, new) of ``edits`` replaced
    (each old text must occur once), built into ``build/probe/``."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} not found once")
        src = src.replace(old, new)
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = f"{source}_{name.replace(' ', '_')}"
    (out_dir / f"{stem}.cu").write_text(src)
    lib = out_dir / f"lib{stem}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(out_dir / f"{stem}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    3 warm-up calls."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
