"""The configuration files against the benchmark and the port, and the
weights made from them (CPU only)."""
from __future__ import annotations

import dataclasses
import re

import pytest
import torch

from portbench import harness as H
from portbench import testing, weights

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|per_tok")
BENCH = H.benchmark()
CELLS = [w["name"] for w in testing.bench()["workloads"]]


@pytest.mark.parametrize("conf", [c["name"] for c in BENCH["configs"]])
def test_config_files_match_the_benchmark_and_the_port(conf):
    entry = next(c for c in BENCH["configs"] if c["name"] == conf)
    data = H.load_json(H.ROOT / entry["file"])
    assert data["name"] == conf and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key)
    from repro_torch.configs import get_config
    port = get_config(conf)
    for kind in ("score", "train"):
        if kind not in data:
            continue
        mine = H.program_config(data, kind)
        for f in dataclasses.fields(port):
            if f.name in data["model"]:
                assert getattr(mine, f.name) == getattr(port, f.name), f.name


@pytest.mark.parametrize("cell", CELLS)
def test_weights_make_the_tree_the_program_makes(cell):
    from repro_torch.models import init_params
    over = testing.tiny_overrides(cell)
    conf, kind = over["conf"], over["traffic"]["kind"]
    cfg = H.program_config(conf, kind)
    ref = H.load_module(H.HERE / "reference" / f"{conf['reference']}.py")
    groups = ref.leaves(conf["model"], cfg.param_dtype)
    mine = weights.make_params(groups, 5, "cpu")
    theirs = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(t, p=()):
        if isinstance(t, dict):
            return {k2: v for k, x in t.items()
                    for k2, v in shapes(x, p + (k,)).items()}
        if isinstance(t, list):
            return {k2: v for i, x in enumerate(t)
                    for k2, v in shapes(x, p + (i,)).items()}
        return {p: tuple(t.shape)}

    assert shapes(mine) == shapes(theirs)


def test_a_group_made_alone_equals_the_same_group_made_with_the_rest():
    over = testing.tiny_overrides("rwkv6-3b.score")
    ref = H.load_module(H.HERE / "reference" / "rwkv6.py")
    groups = ref.leaves(over["conf"]["model"], "bfloat16")
    whole = weights.make_params(groups, 2 ** 33 + 7, "cpu")
    alone = weights.make_group(groups, 2, 2 ** 33 + 7, "cpu")
    for path, t in alone.items():
        node = whole
        for k in path:
            node = node[k]
        assert torch.equal(node, t)
    again = weights.make_group(groups, 2, 2 ** 33 + 8, "cpu")
    assert not torch.equal(again[("blocks", 1, "wr")],
                           alone[("blocks", 1, "wr")])
