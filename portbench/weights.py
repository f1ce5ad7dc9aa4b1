"""Weights from the seed, made on the device in a few large calls.

A family's ``leaves(model)`` (``reference/<family>.py``) lists its
parameters in groups (the embedding, each layer, the head): a leaf is
(path in the program's tree, shape, init, dtype).  Each group draws from
a ``torch.Generator`` of its own, seeded from (seed, group index), one
normal and one uniform draw for the whole group on the device, so the
reference can make one layer again by itself, bit for bit, after the
program's state is gone.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

Leaf = Tuple[Tuple[Any, ...], Tuple[int, ...], Tuple[Any, ...], str]
Group = Tuple[str, List[Leaf]]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def group_seed(seed: int, index: int) -> int:
    ss = np.random.SeedSequence([int(seed) % (1 << 64), index])
    return int(ss.generate_state(1, dtype=np.uint64)[0])


def make_group(groups: Sequence[Group], index: int, seed: int,
               device) -> Dict[Tuple[Any, ...], torch.Tensor]:
    """{path: tensor} of group ``index``."""
    _, leaves = groups[index]
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, index))
    sizes = {"normal": 0, "uniform": 0}
    for _, shape, init, _ in leaves:
        if init[0] in sizes:
            sizes[init[0]] += int(np.prod(shape))
    draws = {}
    if sizes["normal"]:
        draws["normal"] = torch.randn(sizes["normal"], generator=gen,
                                      device=device)
    if sizes["uniform"]:
        draws["uniform"] = torch.rand(sizes["uniform"], generator=gen,
                                      device=device)
    used = {"normal": 0, "uniform": 0}
    out = {}
    for path, shape, init, dtype in leaves:
        n = int(np.prod(shape))
        kind = init[0]
        if kind == "const":
            t = torch.full(shape, float(init[1]), device=device)
        else:
            t = draws[kind][used[kind]:used[kind] + n].view(shape)
            used[kind] += n
            t = t * init[1] if kind == "normal" else \
                t * (init[2] - init[1]) + init[1]
        out[path] = t.to(DTYPES[dtype])
    return out


def tree_from(flat: Dict[Tuple[Any, ...], torch.Tensor]) -> Any:
    """A nested dict (and, where a key is an int, list) of the leaves."""
    root: Dict[Any, Any] = {}
    for path, t in flat.items():
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return _lists(root)


def _lists(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def make_params(groups: Sequence[Group], seed: int, device) -> Any:
    flat = {}
    for i in range(len(groups)):
        flat.update(make_group(groups, i, seed, device))
    return tree_from(flat)
