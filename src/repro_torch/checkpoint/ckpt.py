"""Striped, write-behind checkpointing over the XUFS fabric
(``repro/checkpoint/ckpt.py``).

Save path (async, never blocks the train step on the WAN):
  1. every leaf tensor is serialized and ``close()``d through the
     XufsClient -> one aggregated store op per leaf in the WAL;
  2. a manifest (leaf paths, shapes, dtypes, step) is written AFTER all
     leaves — WAL FIFO order guarantees the manifest reaches home only
     once every leaf it references is durable (**last-close-wins commit**);
  3. the LATEST pointer is written after the manifest.
  A crash at any point replays cleanly: ``client.sync()`` drains the WAL
  in order; a LATEST that made it home always names a complete manifest.

Restore: LATEST -> manifest -> leaves; small leaves ride the parallel
prefetcher, large ones the striped fetch — the paper's Fig.4/Fig.5 split.

A tree is nested dicts (and lists) of torch tensors or numpy arrays.  The
files are the reference's, byte for byte, so a checkpoint saved by either
package restores on the other: a leaf is named by its ``/``-joined path
with dict keys walked in sorted order, as ``jax.tree_util`` flattens (the
order sets the WAL's, so the manifest and the wire trace match too); a
bf16 leaf is written as its uint16 bits under ``"dtype": "bfloat16"``.
The port keeps per-layer lists where the reference stacks layers, so a
model's tree goes through ``repro_torch.bridge.state_to_reference`` first.
Each leaf is turned into bytes inside ``save``: the train step updates
params and moments in place, and a later step must not reach a saved
leaf.  ``restore`` puts each leaf on the template leaf's device and
dtype.
"""
from __future__ import annotations

import io
import json
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.namespace import XufsClient

Params = Any


def _leaf_paths(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) in ``jax.tree_util.tree_flatten_with_path``'s order:
    dict keys sorted, list entries by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, path + (i,))
    else:
        yield path, tree


def _path_str(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _encode(leaf: Any) -> Tuple[bytes, List[int], str]:
    """A leaf -> (``.npy`` bytes, shape, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            a, dtype = t.view(torch.int16).cpu().numpy().view(np.uint16), \
                "bfloat16"
        else:
            a = t.cpu().numpy()
            dtype = str(a.dtype)
    else:
        a = np.asarray(leaf)
        dtype = str(a.dtype)
        if dtype == "bfloat16":     # numpy can't serialize ml_dtypes natively
            a = a.view(np.uint16)
    if not a.flags.c_contiguous:    # else np.save writes a Fortran header
        a = a.copy(order="C")
    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    return buf.getvalue(), list(a.shape), dtype


def _decode(data: bytes, dtype: str = "") -> torch.Tensor:
    a = np.require(np.load(io.BytesIO(data), allow_pickle=False),
                   requirements=["W"])
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _like(t: torch.Tensor, leaf: Any) -> Any:
    """``t`` cast to ``leaf``'s dtype, on its device (a tensor) or as a
    numpy array (an array)."""
    if isinstance(leaf, torch.Tensor):
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
        t = t.to(getattr(torch, leaf.dtype.name))
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(leaf.dtype)
        return t.numpy()
    return t


def _rebuild(template: Any, leaves: Dict[Tuple, Any], path: Tuple = ()
             ) -> Any:
    """``template``'s structure, in its own order, with ``leaves[path]``
    at each leaf."""
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, path + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves, path + (i,))
                              for i, v in enumerate(template))
    return leaves[path]


class CheckpointManager:
    def __init__(self, client: XufsClient, prefix: str, keep: int = 3):
        self.client = client
        self.prefix = prefix.rstrip("/")
        self.keep = keep

    # ---- save -----------------------------------------------------------
    def save(self, step: int, tree: Params, *,
             extra: Optional[Dict] = None) -> str:
        base = f"{self.prefix}/step_{step:08d}"
        manifest: Dict[str, Any] = {"step": step, "leaves": [],
                                    "extra": extra or {}}
        for path, leaf in _leaf_paths(tree):
            name = _path_str(path)
            obj = f"{base}/{name}.npy"
            data, shape, dtype = _encode(leaf)
            with self.client.open(obj, "w") as f:
                f.write(data)
            manifest["leaves"].append(
                {"name": name, "path": obj, "shape": shape, "dtype": dtype})
        with self.client.open(f"{base}/MANIFEST.json", "w") as f:
            f.write(json.dumps(manifest).encode())
        with self.client.open(f"{self.prefix}/LATEST", "w") as f:
            f.write(str(step).encode())
        return base

    # ---- restore ----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        try:
            with self.client.open(f"{self.prefix}/LATEST") as f:
                return int(f.read().decode())
        except FileNotFoundError:
            return None

    def restore(self, template: Params, step: Optional[int] = None,
                ) -> Tuple[Params, Dict]:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint published")
        base = f"{self.prefix}/step_{step:08d}"
        with self.client.open(f"{base}/MANIFEST.json") as f:
            manifest = json.loads(f.read().decode())
        by_name = {l["name"]: l for l in manifest["leaves"]}
        # parallel-prefetch the small leaves (norm scales, biases)
        self.client.chdir(base + "/")

        def load(path, leaf):
            name = _path_str(path)
            rec = by_name[name]
            with self.client.open(rec["path"]) as f:
                t = _decode(f.read(), rec["dtype"])
            if list(t.shape) != rec["shape"]:
                raise ValueError(f"{name}: shape {list(t.shape)}, manifest "
                                 f"{rec['shape']}")
            return _like(t, leaf)

        leaves = {path: load(path, leaf)
                  for path, leaf in _leaf_paths(template)}
        return _rebuild(template, leaves), manifest

    # ---- gc -----------------------------------------------------------------
    def list_steps(self) -> List[int]:
        steps = set()
        for e in self.client.listdir_cached(self.prefix):
            parts = e.path[len(self.prefix) + 1:].split("/")
            if parts and parts[0].startswith("step_"):
                steps.add(int(parts[0][5:]))
        return sorted(steps)

    def gc(self) -> int:
        steps = self.list_steps()
        doomed = steps[:-self.keep] if len(steps) > self.keep else []
        n = 0
        for s in doomed:
            base = f"{self.prefix}/step_{s:08d}"
            for e in self.client.listdir_cached(base):
                self.client.unlink(e.path)
                n += 1
        return n
