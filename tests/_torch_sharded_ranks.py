"""Rank functions of the port's sharded runs, for ``_torch_dist.run_ranks``
(``tests/test_torch_sharded.py`` on the CPU, ``test_torch_sharded_gpu.py``
on the card).  Kept apart from the test files so that a spawned rank
imports torch and the port only, never JAX.

Each takes full tensors that every rank holds alike, lays them out with
``distribute_tree`` and returns plain tensors (gathered with
``full_tree``, or its own blocks with its mesh coordinate).
"""
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.config import (
    OptimConfig, RunConfig, ShapeConfig, ShardingConfig,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gmm as gm
from repro_torch.kernels import mamba_scan as mb
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import (
    cache_logical_axes, decode_step, loss_fn, param_axes, prefill,
)
from repro_torch.optim import global_norm, state_axes
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel.collectives import gloo_cuda_all_gather
from repro_torch.parallel.context import distribute, sharding_ctx
from repro_torch.parallel.sharding import (
    batch_shardings, distribute_tree, full_tree, make_ctx,
    sanitize_shardings, tree_shardings,
)
from repro_torch.train import make_opt_state, make_train_step


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def _plain(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _mesh(shape, device):
    """A (data, model) or (pod, data, model) mesh; CUDA ranks on gloo (the
    ranks sharing one card) route DTensor's all-gathers through c10d."""
    if device == "cuda" and dist.get_backend() == "gloo":
        gloo_cuda_all_gather()
    pods = shape[0] if len(shape) == 3 else 0
    return make_test_mesh(*shape[-2:], pods=pods, device_type=device)


def _run(cfg, policy, batch_size, seq, microbatches=1,
         state_dtype="float32"):
    return RunConfig(model=cfg, shape=ShapeConfig("t", "train", seq,
                                                  batch_size),
                     sharding=ShardingConfig(policy=policy),
                     optim=OptimConfig(state_dtype=state_dtype),
                     microbatches=microbatches)


def _pairs(placements):
    return tuple((type(p).__name__, getattr(p, "dim", None))
                 for p in placements)


def _placements(tree):
    """Each leaf's placements as (kind, dim) pairs."""
    return tree_map(lambda t: _pairs(t.placements), tree)


def _reset_launches():
    fa.flash_attention.route_launches = dict.fromkeys(fa.ROUTES, 0)
    gm.gmm.route_launches = dict.fromkeys(gm.ROUTES, 0)
    rw.rwkv6_scan.launches = mb.mamba_scan.launches = 0


def _launches():
    """This rank's kernel launches (by route where a kernel has routes)
    since ``_reset_launches`` (the kernels count CUDA launches only)."""
    return {"flash": dict(fa.flash_attention.route_launches),
            "gmm": dict(gm.gmm.route_launches),
            "wkv": rw.rwkv6_scan.launches, "scan": mb.mamba_scan.launches}


def jobs_rank(rank, world, jobs):
    """Several rank functions in one spawn of the group: ``jobs`` maps a
    name to (function, its arguments after rank and world)."""
    return {name: fn(rank, world, *args) for name, (fn, args) in
            jobs.items()}


def train_step_rank(rank, world, device, cfg, mesh_shape, params, batch,
                    microbatches=1, state_dtype="float32", policy="fsdp"):
    """One train step (``fsdp`` unless ``policy`` says otherwise) on a
    (data, model) mesh: the loss before it (no grad), the step's metrics,
    the moments gathered, whether the step ran in place and kept every
    leaf's placements."""
    mesh = _mesh(mesh_shape, device)
    run = _run(cfg, policy, batch["tokens"].shape[0],
               batch["tokens"].shape[1], microbatches, state_dtype)
    ctx = make_ctx(mesh, run.sharding)
    p_axes = param_axes(cfg)
    params, batch = _to(params, device), _to(batch, device)
    pd = distribute_tree(params, tree_shardings(ctx, p_axes))
    od = distribute_tree(make_opt_state(run, params),
                         tree_shardings(ctx, state_axes(p_axes, run.optim)))
    laid = make_opt_state(run, pd)     # made on the DTensors themselves
    same_layout = _placements(laid) == _placements(od) and all(
        a.to_local().shape == b.to_local().shape
        for a, b in zip(tree_leaves(laid), tree_leaves(od)))
    bd = distribute_tree(batch, batch_shardings(ctx, batch))
    before = (_placements(pd), _placements(od))
    with sharding_ctx(ctx):
        with torch.no_grad():
            loss = loss_fn(cfg, pd, bd)[0].full_tensor()
        p2, o2, metrics = make_train_step(run)(pd, od, bd)
    return dict(loss=loss.cpu(), metrics={k: v.cpu() for k, v in
                                          metrics.items()},
                m=_to(full_tree(o2["m"]), "cpu"),
                v=_to(full_tree(o2["v"]), "cpu"),
                count=int(o2["count"].full_tensor()),
                in_place=p2 is pd and o2 is od,
                kept=(_placements(p2), _placements(o2)) == before,
                plain_metrics=all(not isinstance(v, DTensor)
                                  for v in metrics.values()),
                state_on_dtensors=same_layout)


def refuse_plain_leaf_rank(rank, world, device, cfg, mesh_shape, params,
                           batch):
    """The sharded step given one plain leaf: the error it raises."""
    mesh = _mesh(mesh_shape, device)
    run = _run(cfg, "fsdp", batch["tokens"].shape[0],
               batch["tokens"].shape[1])
    ctx = make_ctx(mesh, run.sharding)
    p_axes = param_axes(cfg)
    pd = distribute_tree(params, tree_shardings(ctx, p_axes))
    od = distribute_tree(make_opt_state(run, params),
                         tree_shardings(ctx, state_axes(p_axes, run.optim)))
    bd = distribute_tree(batch, batch_shardings(ctx, batch))
    pd["blocks"][1]["ln2"] = pd["blocks"][1]["ln2"].to_local()
    try:
        with sharding_ctx(ctx):
            make_train_step(run)(pd, od, bd)
    except TypeError as e:
        return str(e)
    return None


def loss_rank(rank, world, device, cfgs, mesh_shape, params, batch):
    """``loss_fn`` under ``fsdp`` for each config of ``cfgs`` (same params),
    and whether the logits' layout kept the vocab on ``model``."""
    mesh = _mesh(mesh_shape, device)
    out = {}
    for name, cfg in cfgs.items():
        ctx = make_ctx(mesh, ShardingConfig(policy="fsdp"))
        pd = distribute_tree(_to(params, device),
                             tree_shardings(ctx, param_axes(cfg)))
        b = _to(batch, device)
        bd = distribute_tree(b, batch_shardings(ctx, b))
        _reset_launches()
        with sharding_ctx(ctx), torch.no_grad():
            total, metrics = loss_fn(cfg, pd, bd)
        out[name] = {k: _plain(v).cpu() for k, v in metrics.items()}
        out[name]["launches"] = _launches()
    return out


def prefill_rank(rank, world, device, cfg, mesh_shape, params, prompt,
                 max_len, policies):
    """``prefill`` under each policy: the last logits and the cache,
    gathered, and the cache's placements."""
    mesh = _mesh(mesh_shape, device)
    out = {}
    for policy in policies:
        ctx = make_ctx(mesh, ShardingConfig(policy=policy))
        pd = distribute_tree(_to(params, device),
                             tree_shardings(ctx, param_axes(cfg)))
        b = _to(prompt, device)
        bd = distribute_tree(b, batch_shardings(ctx, b))
        with sharding_ctx(ctx), torch.no_grad():
            logits, cache = prefill(cfg, pd, bd, max_len)
        out[policy] = dict(logits=logits.full_tensor().cpu(),
                           cache=_to(full_tree(cache), "cpu"),
                           placements=_placements(cache))
    return out


def decode_rank(rank, world, device, cfg, mesh_shape, params, prompt,
                max_len, ticks, policy="baseline", shard_seq=False):
    """Decode (``baseline`` unless ``policy`` says otherwise) on a (data,
    model) or (pod, data, model) mesh: prefill, then ``ticks`` greedy
    decode steps through the sharded cache, under the ``shard_seq`` decode
    rules (batch whole, the K/V rows split over data) if asked.  Returns
    each step's logits (gathered), the tokens fed, this rank's mesh
    coordinate, its own block of every cache entry after the prefill and
    after each step (``blocks``: the last), and whether the cache kept
    its layout (``cache_logical_axes``, sanitized)."""
    mesh = _mesh(mesh_shape, device)
    ctx = make_ctx(mesh, ShardingConfig(policy=policy, shard_seq=shard_seq),
                   decode=True)
    pd = distribute_tree(_to(params, device),
                         tree_shardings(ctx, param_axes(cfg)))
    b = _to(prompt, device)
    bd = distribute_tree(b, batch_shardings(ctx, b))
    want = None
    logits, tokens, kept = [], [], True
    _reset_launches()
    with sharding_ctx(ctx), torch.no_grad():
        lg, cache = prefill(cfg, pd, bd, max_len)
        prefill_launches = _launches()
        want = {k: _pairs(sh.placements) for k, sh in sanitize_shardings(
            tree_shardings(ctx, cache_logical_axes(cfg, shard_seq=shard_seq)),
            cache).items()}
        kept = _placements(cache) == want
        prefill_blocks = {k: v.to_local().clone().cpu()
                          for k, v in cache.items()}
        tick_blocks = []
        for _ in range(ticks):
            full = lg.full_tensor()
            logits.append(full.cpu())
            tok = full[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            tokens.append(tok.cpu())
            lg, cache = decode_step(cfg, pd, distribute(tok, "batch", None),
                                    cache)
            kept = kept and _placements(cache) == want
            tick_blocks.append({k: v.to_local().clone().cpu()
                                for k, v in cache.items()})
        logits.append(lg.full_tensor().cpu())
    return dict(logits=logits, tokens=tokens, coord=mesh.get_coordinate(),
                blocks=tick_blocks[-1] if ticks else prefill_blocks,
                tick_blocks=tick_blocks, prefill_blocks=prefill_blocks,
                kept=kept, prefill_launches=prefill_launches)


def global_norm_rank(rank, world, device, mesh_shape, tree):
    """``global_norm`` of ``tree`` laid out with replicated, sharded and
    doubly sharded leaves, against the same tree unsharded."""
    from repro_torch.parallel.context import NamedSharding
    mesh = _mesh(mesh_shape, device)
    specs = {"rep": (), "data": ("data",), "model": (None, "model"),
             "both": ("data", "model")}
    sh = {k: NamedSharding(mesh, specs[k]) for k in tree}
    dtree = distribute_tree(_to(tree, device), sh)
    return dict(sharded=float(global_norm(dtree)),
                plain=float(global_norm(tree)),
                leaves=len(tree_leaves(dtree)))


def remat_outside_ctx_rank(rank, world, device, cfg, mesh_shape, params,
                           batch):
    """``loss_fn``'s grads under remat "full" with the backward run inside
    the sharding context and again after leaving it (a CUDA backward runs
    on autograd's own thread, where the context is not active): both the
    same, gathered."""
    mesh = _mesh(mesh_shape, device)
    ctx = make_ctx(mesh, ShardingConfig(policy="fsdp"))
    out = []
    for inside in (True, False):
        pd = distribute_tree(_to(params, device),
                             tree_shardings(ctx, param_axes(cfg)))
        b = _to(batch, device)
        bd = distribute_tree(b, batch_shardings(ctx, b))
        for t in tree_leaves(pd):
            t.requires_grad_(True)
        with sharding_ctx(ctx):
            loss = loss_fn(cfg, pd, bd)[0]
            if inside:
                loss.backward()
        if not inside:
            loss.backward()
        out.append([t.grad.full_tensor().cpu() for t in tree_leaves(pd)])
    return out


def split_rank(rank, world, device, mesh_shape, cases):
    """``train/step.py`` ``_split_global`` on a batch laid out by
    ``batch_shardings`` (tokens [B, 3], VLM positions [3, B, 2], a
    frontend [B, 2, 4]), for each (B, microbatches) of ``cases``: whether
    every microbatch, gathered, equals the one-device split's and keeps
    the batch's placements."""
    from repro_torch.train.step import _split_global, _split_microbatches
    mesh = _mesh(mesh_shape, device)
    ctx = make_ctx(mesh, ShardingConfig(policy="fsdp"))
    ok = True
    for b, n in cases:
        gen = torch.Generator().manual_seed(b * n)
        batch = {"tokens": torch.arange(b * 3).reshape(b, 3),
                 "positions": torch.arange(3 * b * 2).reshape(3, b, 2),
                 "frontend": torch.randn(b, 2, 4, generator=gen)}
        bd = distribute_tree(_to(batch, device),
                             batch_shardings(ctx, batch))
        want = _split_microbatches(batch, n)
        for i, mb in enumerate(_split_global(bd, n)):
            for k, t in mb.items():
                ok = ok and t.placements == bd[k].placements and \
                    torch.equal(t.full_tensor().cpu(), want[k][i])
    return ok
