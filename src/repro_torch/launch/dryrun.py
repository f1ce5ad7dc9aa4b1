"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on ``meta``
tensors over a fake process group.

Counterpart of ``repro/launch/dryrun.py``.  For each cell this starts a
fake ``torch.distributed`` group of the production mesh's size (single
pod 16x16 = 256 ranks or multi-pod 2x16x16 = 512; the process is rank 0),
builds the parameters, optimizer state and inputs as ``meta`` DTensors
laid out by the sanitized shardings (``parallel/sharding.py``
``distribute_tree``), runs the train step, ``prefill`` or ``decode_step``
once under ``launch/op_analysis.py``'s counters, and records:

  * the argument bytes a rank holds (its blocks of params, state, inputs
    and cache), exactly, and the peak of live bytes a rank held during
    the run (``OpAnalysis``'s storage tracker: arguments plus every
    result until Python frees it), against the card's 80 GB;
  * FLOPs, traffic and collective bytes a rank, at local shapes, and the
    roofline terms with the H100 datasheet constants of
    ``launch/roofline.py``.

Nothing is compiled, so there is no ``memory_analysis`` or
``cost_analysis``: the counts are of the eager program (its traffic is
unfused), and ``trace_s`` (the run's wall time) takes the place of the
reference's ``lower_s``/``compile_s``; there is no ``xla_cost_analysis``.
Every family runs, so no cell of the matrix fails (jamba's train cells
step the Mamba token loop eagerly on ``meta``, ~5 h a cell on 8 CPU
cores); long_500k, the RWKV6 and hybrid cell that turns
on ``shard_seq``, decodes on a cache whose rows are split over the data
axis.  A train cell's 4 microbatches are the reference's global row
blocks, so its step moves the batch once, by an all-to-all
(``train/step.py`` ``_split_global``), counted with the other
collectives, as are the hybrid's all-to-alls of in_proj's column blocks
(``models/mamba.py`` ``_halves``).  A parameter
whose dim a mesh axis does not divide is kept whole on that axis
(``sanitize_shardings``: seamless-m4t-medium's vocab of 256206 on a
16-way ``model`` axis); ``replicated`` lists each such leaf with the
bytes a rank holds of it.

Artifacts land in ``experiments/artifacts_torch/<arch>__<shape>__<mesh>.json``.

Usage (from the repo root):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.config.base import (
    DECODE, PREFILL, SHAPES, TRAIN, ModelConfig, OptimConfig, RunConfig,
    ShapeConfig, ShardingConfig,
)
from repro_torch.configs import ARCH_IDS, cells, get_config, get_shape
from repro_torch.data.batches import make_specs
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.launch.roofline import HBM_BYTES, model_flops, roofline_terms
from repro_torch.models import (
    cache_logical_axes, decode_step, init_cache, init_params, param_axes,
    prefill,
)
from repro_torch.optim import state_axes
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel.context import fit, sharding_ctx
from repro_torch.parallel.sharding import (
    batch_shardings, check_distributed, distribute_tree, make_ctx,
    tree_paths, tree_shardings,
)
from repro_torch.train.step import make_opt_state, make_train_step

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "experiments", "artifacts_torch")

# Large models must serve/train fully sharded; small ones can keep the
# latency-friendly TP-only decode layout.
BIG_ARCHS = {"jamba-1.5-large-398b", "qwen2-vl-72b", "dbrx-132b",
             "qwen2.5-32b", "qwen3-moe-30b-a3b", "phi3-medium-14b"}


def _cell_run_config(arch: str, shape_name: str, *, policy: str,
                     micro: int, model: Optional[ModelConfig] = None,
                     shape: Optional[ShapeConfig] = None) -> RunConfig:
    cfg = model or get_config(arch)
    shape = shape or get_shape(shape_name)
    optim = OptimConfig()
    if arch == "jamba-1.5-large-398b":
        # 398B params: bf16 weights + blockwise-int8 moments to fit 16 GB
        cfg = cfg.replace(param_dtype="bfloat16")
        optim = OptimConfig(state_dtype="int8")
    if shape.kind in (PREFILL, DECODE):
        cfg = cfg.replace(param_dtype="bfloat16")   # serving runs bf16
    if policy == "auto":
        if shape.kind == TRAIN:
            policy = "fsdp"
        else:
            policy = "fsdp" if arch in BIG_ARCHS else "baseline"
    shard_seq = shape_name == "long_500k"
    return RunConfig(
        model=cfg, shape=shape,
        sharding=ShardingConfig(policy=policy, shard_seq=shard_seq),
        optim=optim, microbatches=micro)


def _fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0: its
    collectives move nothing, so a rank's run on ``meta`` tensors shows
    what it would compute and send."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tree: Any) -> int:
    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in tree_leaves(tree))


def lower_cell(arch: str, shape_name: str, mesh_kind: str, *,
               policy: str = "auto", micro: Optional[int] = None,
               lps: Optional[int] = None, model: Optional[ModelConfig] = None,
               mesh_shape: Optional[Sequence[int]] = None,
               shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    """Trace one cell; see the module docstring.  ``model`` replaces the
    arch's config, ``shape`` the cell's sizes and ``mesh_shape`` ((data,
    model) or (pod, data, model)) the production mesh (the tests' tiny
    cells).  Starts the fake group and destroys it before returning."""
    shape = shape or get_shape(shape_name)
    if micro is None:
        micro = 4 if shape.kind == TRAIN else 1
    run = _cell_run_config(arch, shape_name, policy=policy, micro=micro,
                           model=model, shape=shape)
    cfg = run.model
    if lps and cfg.num_layers % lps == 0 and cfg.family != "hybrid":
        cfg = cfg.replace(layers_per_step=lps)
        run = run.replace(model=cfg)
    multi = mesh_kind == "multi"
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi else (16, 16)
    n_dev = 1
    for n in mesh_shape:
        n_dev *= n
    _fake_group(n_dev)
    try:
        if tuple(mesh_shape) in ((16, 16), (2, 16, 16)):
            mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3,
                                        device_type="cpu")
        else:
            mesh = make_test_mesh(*mesh_shape[-2:],
                                  pods=mesh_shape[0] if len(mesh_shape) == 3
                                  else 0, device_type="cpu")
        return _trace(arch, shape_name, mesh_kind, run, mesh, n_dev)
    finally:
        dist.destroy_process_group()


def _trace(arch, shape_name, mesh_kind, run, mesh, n_dev) -> Dict[str, Any]:
    cfg, shape = run.model, run.shape
    ctx = make_ctx(mesh, run.sharding, decode=(shape.kind == DECODE))
    gen = torch.Generator()
    params = init_params(cfg, gen, "meta")
    p_axes = param_axes(cfg)
    p = distribute_tree(params, tree_shardings(ctx, p_axes))
    args: Dict[str, Any] = {"params": p}
    if shape.kind == TRAIN:
        opt = make_opt_state(run, params)
        o_sh = tree_shardings(ctx, state_axes(p_axes, run.optim))
        if run.optim.grad_compress == "int8":
            o_sh["ef_error"] = tree_shardings(ctx, p_axes)
        args["opt_state"] = distribute_tree(opt, o_sh)
        batch = make_specs(cfg, shape.global_batch, shape.seq_len)
        args["batch"] = distribute_tree(batch, batch_shardings(ctx, batch))
        step = make_train_step(run)
        call = lambda: step(args["params"], args["opt_state"], args["batch"])
        tokens = shape.global_batch * shape.seq_len
        train = True
    elif shape.kind == PREFILL:
        batch = make_specs(cfg, shape.global_batch, shape.seq_len)
        batch.pop("targets")
        args["batch"] = distribute_tree(batch, batch_shardings(ctx, batch))
        call = lambda: prefill(cfg, args["params"], args["batch"],
                               max_len=shape.seq_len)
        tokens = shape.global_batch * shape.seq_len
        train = False
    else:  # DECODE: one new token against a seq_len-deep cache
        B = shape.global_batch
        cache = init_cache(cfg, B, shape.seq_len, "meta")
        c_axes = cache_logical_axes(cfg, shard_seq=run.sharding.shard_seq)
        args["cache"] = distribute_tree(cache, tree_shardings(ctx, c_axes))
        tok = torch.empty((B, 1), dtype=torch.int32, device="meta")
        args["tokens"] = distribute_tree(
            {"t": tok}, {"t": ctx.sharding(("batch", None))})["t"]
        call = lambda: decode_step(cfg, args["params"], args["tokens"],
                                   args["cache"])
        tokens = B
        train = False
    check_distributed(args, "args")
    arg_bytes = _local_bytes(args)
    replicated = [
        {"leaf": path, "shape": list(t.shape), "spec": list(sh.spec),
         "bytes_per_device": _local_bytes(t)}
        for (path, t), (_, sh) in zip(tree_paths(p), tree_paths(
            tree_shardings(ctx, p_axes)))
        if fit(sh, tuple(t.shape)).spec != sh.spec]
    mf = model_flops(cfg.param_count(active_only=True), tokens, train=train)

    t0 = time.time()
    oa = OpAnalysis()
    oa.track(args)
    with sharding_ctx(ctx), oa:
        out = call()
        del out
    t_trace = time.time() - t0
    counts = oa.result()
    flops_dev = counts["flops"]
    terms = roofline_terms(flops_dev, counts["traffic_bytes"],
                           counts["collective_total"])
    peak = counts["peak_bytes"]
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": list(mesh.shape), "devices": int(n_dev),
        "policy": run.sharding.policy, "microbatches": run.microbatches,
        "tokens": tokens,
        "trace_s": round(t_trace, 2),
        "flops_per_device": flops_dev,
        "bytes_per_device": counts["traffic_bytes"],
        "collective_bytes_per_device": counts["collective_total"],
        "op_analysis": counts,
        "memory": {"argument_bytes": arg_bytes, "peak_bytes": peak,
                   "peak_tracker": "launch/op_analysis.py OpAnalysis: "
                                   "argument storages plus every op "
                                   "result's storage until it is freed",
                   "hbm_bytes": HBM_BYTES,
                   "fits_80gb": bool(peak <= HBM_BYTES)},
        "replicated": replicated,
        "model_flops_total": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / flops_dev if flops_dev else None,
        "roofline": terms,
        "roofline_constants": "H100 SXM datasheet (launch/roofline.py), "
                              "not measured",
    }


def save_artifact(art: Dict[str, Any], outdir: str) -> str:
    os.makedirs(outdir, exist_ok=True)
    name = f"{art['arch']}__{art['shape']}__{art['mesh']}"
    if art.get("tag"):
        name += f"__{art['tag']}"
    path = os.path.join(outdir, name + ".json")
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    return path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--policy", choices=("auto", "baseline", "fsdp"),
                    default="auto")
    ap.add_argument("--micro", type=int, default=None)
    ap.add_argument("--lps", type=int, default=None,
                    help="layers per scan step (remat grouping)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.normpath(ARTIFACTS))
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(arch, shape_name, mk) for arch in ARCH_IDS
                for shape_name in cells(arch) for mk in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape, mk) for mk in meshes]

    if args.all:
        # one subprocess per cell: bounds memory, isolates failures and the
        # process-global fake group
        failures = 0
        for arch, shape_name, mesh_kind in todo:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name,
                   "--mesh", mesh_kind, "--policy", args.policy,
                   "--out", args.out]
            if args.micro is not None:
                cmd += ["--micro", str(args.micro)]
            if args.lps is not None:
                cmd += ["--lps", str(args.lps)]
            if args.tag:
                cmd += ["--tag", args.tag]
            r = subprocess.run(cmd)
            failures += 1 if r.returncode else 0
        print(f"dry-run matrix done: {len(todo) - failures}/{len(todo)} OK",
              flush=True)
        return 1 if failures else 0

    failures = 0
    for arch, shape_name, mesh_kind in todo:
        label = f"{arch} x {shape_name} x {mesh_kind}"
        try:
            art = lower_cell(arch, shape_name, mesh_kind,
                             policy=args.policy, micro=args.micro,
                             lps=args.lps)
            if args.tag:
                art["tag"] = args.tag
            path = save_artifact(art, args.out)
            r, mem = art["roofline"], art["memory"]
            print(f"OK   {label}: dominant={r['dominant']} "
                  f"compute={r['compute_s']*1e3:.1f}ms "
                  f"memory={r['memory_s']*1e3:.1f}ms "
                  f"coll={r['collective_s']*1e3:.1f}ms "
                  f"args={mem['argument_bytes']/1e9:.2f}GB "
                  f"peak={mem['peak_bytes']/1e9:.2f}GB "
                  f"trace={art['trace_s']:.0f}s -> {path}", flush=True)
        except Exception as e:  # noqa: BLE001  (a cell's failure is reported)
            failures += 1
            print(f"FAIL {label}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
