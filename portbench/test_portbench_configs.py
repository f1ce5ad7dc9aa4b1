"""The configuration files against the benchmark, their published
sources and the port, and the weights made from them (CPU only)."""
from __future__ import annotations

import copy
import dataclasses
import math
import re
from typing import Dict, List

import pytest
import torch

from portbench import harness as H
from portbench import testing, weights

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# a width: a hidden, intermediate, latent, state or projection size, a
# head or its size, a feed-forward, LoRA or window size, an expansion
# factor, the experts a token takes
WIDTH = re.compile(r"(_dim|_rank)$|(^|_)d_|hidden|intermediate|latent|"
                   r"state|projection|head|embd|ffn|expan|lora|window|"
                   r"per_tok")
# counts that only a chip's share of a stated deployment may cut (the
# guide's floors: at least 8 experts, an eighth of the vocabulary); no
# configuration here states one, so none is cut
COUNT = re.compile(r"expert|vocab")
# the depth, which a one-card cut may take down to a whole period of the
# layer pattern and at least four layers
DEPTH = ("num_hidden_layers", "n_layer")
# the file's own keys; every other key at its top level is the source's,
# with the value this file runs
OWN = ("name", "source", "reference", "reduced", "assumed", "model",
       "score", "train")
BENCH = H.benchmark()
CELLS = testing.tiny_cells()

# each ``model`` field and the keys a source names it by (the first that
# the file holds is the one compared)
PUBLISHED = {
    "d_model": ("hidden_size", "n_embd"),
    "num_layers": ("num_hidden_layers", "n_layer"),
    "num_heads": ("num_attention_heads",),
    "num_kv_heads": ("num_key_value_heads",),
    "head_dim": ("head_dim", "head_size"),
    "d_ff": ("dim_ffn", "intermediate_size"),
    "vocab_size": ("vocab_size",),
    "rope_theta": ("rope_theta",),
    "rms_eps": ("rms_norm_eps",),
    "tie_embeddings": ("tie_word_embeddings",),
    "hybrid_period": ("attn_layer_period",),
    "hybrid_attn_pos": ("attn_layer_offset",),
    "moe.num_experts": ("num_experts",),
    "moe.experts_per_token": ("num_experts_per_tok",),
    "moe.d_ff_expert": ("moe_intermediate_size", "intermediate_size"),
    "moe.moe_every": ("decoder_sparse_step", "expert_layer_period"),
    "moe.moe_offset": ("expert_layer_offset",),
    "moe.norm_topk_prob": ("norm_topk_prob",),
    "mamba.d_state": ("mamba_d_state",),
    "mamba.d_conv": ("mamba_d_conv",),
    "mamba.expand": ("mamba_expand",),
    "mamba.dt_rank": ("mamba_dt_rank",),
    "rwkv.head_dim": ("head_size",),
}
# the layer pattern, held like a size
PATTERN = ("num_layers", "hybrid_period", "hybrid_attn_pos", "moe.moe_every",
           "moe.moe_offset")


def flat(tree: Dict, prefix: str = "") -> Dict:
    """{"moe.num_experts": 128, ...} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def source_keys(data: Dict) -> Dict:
    """The source's keys as the file runs them, nested groups dotted."""
    return flat({k: v for k, v in data.items() if k not in OWN})


def cuttable(key: str) -> bool:
    """Whether a one-card cut may change the source's ``key``."""
    return key in DEPTH or not (WIDTH.search(key) or COUNT.search(key))


def derived(src: Dict) -> Dict:
    """Sizes that a source gives by the rules of its family, not by a key
    of their own: heads of d / head_size, as many kv heads as heads,
    head_dim d / heads."""
    d = src.get("hidden_size", src.get("n_embd"))
    heads = src.get("num_attention_heads")
    if heads is None and d and src.get("head_size"):
        heads = d // src["head_size"]
    out = {}
    if heads:
        out.update(num_heads=heads,
                   num_kv_heads=src.get("num_key_value_heads", heads))
        if d and d % heads == 0:
            out["head_dim"] = d // heads
    return out


def is_size(field: str) -> bool:
    last = field.rsplit(".", 1)[-1]
    return field in PATTERN or bool(WIDTH.search(last) or COUNT.search(last))


def config_faults(data: Dict) -> List[str]:
    """What is wrong with a configuration file's statement of its model:
    a ``reduced`` key that is not the source's or that no cut may change;
    a depth cut below a whole period or four layers; a ``model`` field
    that differs from the source's key for it; a size that no key of the
    source gives, no rule derives and ``assumed`` does not state with its
    value first; where the name is an id of the port's registry, a field
    not cut that the registry sets otherwise."""
    bad = []
    src, reduced = source_keys(data), set(data["reduced"])
    assumed = data.get("assumed", {})
    for key in sorted(reduced):
        if not NAME.match(key) or not cuttable(key) or key not in src:
            bad.append(f"reduced {key!r}")
    model = flat(data["model"])
    if reduced & set(DEPTH):
        n = model["num_layers"]
        period = math.lcm(model.get("hybrid_period") or 1,
                          model.get("moe.moe_every") or 1)
        if n % period or n < max(period, 4):
            bad.append(f"num_layers {n} is not whole periods of {period} "
                       f"and at least 4")
    rules = derived(src)
    cut = set()
    for field in sorted(model):
        v = model[field]
        key = next((k for k in PUBLISHED.get(field, ()) if k in src), None)
        if key is not None:
            if key in reduced:
                cut.add(field)
            if v != src[key]:
                bad.append(f"{field} {v!r} != {key} {src[key]!r}")
        elif field in rules:
            if v != rules[field]:
                bad.append(f"{field} {v!r} != {rules[field]!r}, the "
                           f"source's by its family's rule")
        elif is_size(field):
            said = str(assumed.get(field.rsplit(".", 1)[-1], ""))
            if said.split(",")[0].split(" ")[0] != str(v):
                bad.append(f"{field} {v!r}: no key of the source, no rule "
                           f"and no statement under assumed")
    from repro_torch.configs import ARCH_IDS, get_config
    if data["name"] in ARCH_IDS:
        port = flat(dataclasses.asdict(get_config(data["name"])))
        for kind in ("score", "train"):
            if kind not in data:
                continue
            mine = flat(dataclasses.asdict(H.program_config(data, kind)))
            bad += [f"{f} {mine[f]!r} != the registry's {port[f]!r}"
                    for f in sorted(model) if f not in cut
                    and f in port and mine[f] != port[f]]
    return bad


@pytest.mark.parametrize("conf", [c["name"] for c in BENCH["configs"]])
def test_config_files_match_the_benchmark_and_the_port(conf):
    entry = next(c for c in BENCH["configs"] if c["name"] == conf)
    data = H.load_json(H.ROOT / entry["file"])
    assert data["name"] == conf and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"]
    assert config_faults(data) == []


def _qwen():
    return copy.deepcopy(H.load_json(H.HERE / "configs"
                                     / "qwen3-moe-30b-a3b.json"))


# AI21-Jamba2-Mini's config.json (https://huggingface.co/ai21labs/
# AI21-Jamba2-Mini/blob/main/config.json), its keys that set a size
JAMBA2_MINI = {
    "attn_layer_offset": 4, "attn_layer_period": 8,
    "expert_layer_offset": 1, "expert_layer_period": 2,
    "hidden_size": 4096, "intermediate_size": 14336, "mamba_d_conv": 4,
    "mamba_d_state": 16, "mamba_dt_rank": 256, "mamba_expand": 2,
    "num_attention_heads": 32, "num_experts": 16, "num_experts_per_tok": 2,
    "num_hidden_layers": 32, "num_key_value_heads": 8, "rms_norm_eps": 1e-06,
    "tie_word_embeddings": False, "vocab_size": 65536}
# the cut the next hybrid cell runs: two of its four superblocks
JAMBA2_MINI_CUT = {
    "family": "hybrid", "num_layers": 16, "d_model": 4096, "num_heads": 32,
    "num_kv_heads": 8, "head_dim": 128, "d_ff": 14336, "vocab_size": 65536,
    "rope_theta": 0.0, "rms_eps": 1e-06, "tie_embeddings": False,
    "hybrid_period": 8, "hybrid_attn_pos": 4,
    "moe": {"num_experts": 16, "experts_per_token": 2, "d_ff_expert": 14336,
            "moe_every": 2, "moe_offset": 1, "capacity_factor": 1.25,
            "norm_topk_prob": False},
    "mamba": {"d_state": 16, "d_conv": 4, "expand": 2, "dt_rank": 256}}


def _jamba2_mini(layers: int = 16) -> Dict:
    """A file of the cut Jamba2-Mini, a name of its own, the source's keys
    at the top level as the cut runs them."""
    model = copy.deepcopy(JAMBA2_MINI_CUT)
    model["num_layers"] = layers
    return dict(JAMBA2_MINI, num_hidden_layers=layers, name="jamba2-mini",
                reduced=["num_hidden_layers"], model=model)


def test_a_cut_configuration_passes_with_its_cut_reduced():
    data = _qwen()
    data["model"]["num_layers"] = 24
    assert config_faults(data) != []           # the source says 48
    data["num_hidden_layers"] = 24
    assert config_faults(data) != []           # the registry says 48
    data["reduced"] = ["num_hidden_layers"]
    assert config_faults(data) == []


def test_a_configuration_of_its_own_is_held_to_its_source():
    data = _jamba2_mini()
    assert config_faults(data) == []
    data["model"]["moe"]["moe_offset"] = 0
    assert config_faults(data) == ["moe.moe_offset 0 != expert_layer_offset 1"]


def test_a_size_the_source_derives_is_held_to_the_rule():
    data = _jamba2_mini()
    data["model"]["head_dim"] = 64             # Jamba's d / heads is 128
    assert config_faults(data) == [
        "head_dim 64 != 128, the source's by its family's rule"]
    data = _jamba2_mini()
    del data["num_key_value_heads"]            # then as many as heads: 32
    assert config_faults(data) == ["num_kv_heads 8 != 32, the source's by "
                                   "its family's rule"]


def test_a_size_no_source_gives_needs_its_value_assumed():
    data = _jamba2_mini()
    del data["mamba_d_conv"]
    assert config_faults(data) == ["mamba.d_conv 4: no key of the source, "
                                   "no rule and no statement under assumed"]
    data["assumed"] = {"d_conv": "3, a guess"}
    assert config_faults(data) != []
    data["assumed"] = {"d_conv": "4, Mamba-1's conv taps"}
    assert config_faults(data) == []


@pytest.mark.parametrize("layers,ok", [(16, True), (8, True), (12, False),
                                       (4, False)])
def test_a_depth_cut_keeps_whole_periods(layers, ok):
    assert (config_faults(_jamba2_mini(layers)) == []) == ok


@pytest.mark.parametrize("key,ok", [
    ("num_hidden_layers", True), ("n_layer", True), ("rope_theta", True),
    ("num_attention_heads", False), ("num_key_value_heads", False),
    ("num_experts", False), ("vocab_size", False), ("hidden_size", False),
    ("n_embd", False), ("intermediate_size", False),
    ("moe_intermediate_size", False), ("dim_ffn", False), ("head_dim", False),
    ("head_size", False), ("kv_lora_rank", False), ("mamba_d_state", False),
    ("mamba_d_conv", False), ("mamba_expand", False), ("mamba_dt_rank", False),
    ("num_experts_per_tok", False), ("sliding_window", False)])
def test_a_one_card_cut_changes_the_depth_and_never_a_width_or_count(key,
                                                                     ok):
    assert cuttable(key) == ok


@pytest.mark.parametrize("field,key,value", [
    ("d_model", "hidden_size", 1024),
    ("head_dim", "head_dim", 64),
    ("moe.d_ff_expert", "moe_intermediate_size", 384),
])
def test_a_registry_configuration_with_a_width_changed_fails(field, key,
                                                               value):
    data = _qwen()
    *outer, last = field.split(".")
    node = data["model"]
    for k in outer:
        node = node[k]
    node[last] = value
    assert config_faults(data) != []
    data["reduced"] = [key]                    # a width is never cut
    assert f"reduced {key!r}" in config_faults(data)
    data["reduced"] = []
    data[key] = value                          # nor restated
    assert any("registry" in f for f in config_faults(data))


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
