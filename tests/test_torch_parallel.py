"""The sharding rules, the DTensor layouts and the collectives on ``gloo``
meshes of 4 (data=2, model=2) and 8 (pod=2, data=2, model=2) processes,
against the reference on host devices.

Layouts: for qwen3-moe, rwkv6-3b and seamless-m4t-medium (tiny; seamless
with a vocab of 513, and caches of 3 sequences, so that some dims are not
divided and ``sanitize_shardings`` drops their axes; and caches of 4,
whose batch the (pod, data) pair of axes splits), both policies, every
leaf of the params and of the caches: the sanitized spec, and the
block of the global tensor each rank holds (``distribute_tensor``'s local
shard, located by its first element), equal to the spec and to the slice
``NamedSharding.devices_indices_map`` gives the device at the same mesh
coordinate, stacked axes aside.  Collectives: ``hierarchical_psum`` and
``compressed_psum`` on the reference test's input
(``tests/test_sharding_multidev.py``) and on one whose leading dim the
inner axis does not divide.  The reference and each mesh run once; limits
in ``_torch_dist.py``.
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist as D
from repro_torch import bridge
from repro_torch.config import ShardingConfig
from repro_torch.configs import get_tiny_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import (
    cache_logical_axes, init_cache, init_params, param_axes,
)
from repro_torch.optim.adamw import tree_map
from repro_torch.parallel import collectives as tcoll
from repro_torch.parallel.context import shard, sharding_ctx
from repro_torch.parallel.sharding import (
    make_ctx, sanitize_shardings, tree_shardings,
)

ARCHS = ("qwen3-moe-30b-a3b", "rwkv6-3b", "seamless-m4t-medium")
POLICIES = ("baseline", "fsdp")
MESHES = {"2x2": (2, 2), "2x2x2": (2, 2, 2)}
CACHE_B, CACHE_LEN = 3, 8
TOL = 1e-6


def _cfg(arch):
    cfg = get_tiny_config(arch)
    return cfg.replace(vocab_size=513) if arch.startswith("seamless") else cfg


def _inputs():
    """The reference test's x, and one whose 3 rows a shard the data
    axis's 2 ranks do not divide."""
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    x3 = (np.arange(12 * 16, dtype=np.float32).reshape(12, 16) - 50.0) * 0.37
    return {"x": x, "x3": x3}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_ref")
    np.savez(d / "inputs.npz", **_inputs())
    D.run_reference(f"""
        import json
        import jax, jax.numpy as jnp
        import numpy as np
        from jax.experimental.shard_map import shard_map
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from repro.config import ShardingConfig
        from repro.configs import get_tiny_config
        from repro.models import (cache_logical_axes, init_cache,
                                  init_params, param_axes)
        from repro.parallel.collectives import (compressed_psum,
                                                hierarchical_psum)
        from repro.parallel.sharding import (make_ctx, sanitize_shardings,
                                             tree_shardings)

        d = {str(d)!r}
        devs = np.array(jax.devices())
        meshes = {{
            '2x2': Mesh(devs[:4].reshape(2, 2), ('data', 'model')),
            '2x2x2': Mesh(devs[:8].reshape(2, 2, 2),
                          ('pod', 'data', 'model'))}}

        def flat(tree, prefix=''):
            out = {{}}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out.update(flat(v, prefix + k + '/'))
                else:
                    out[prefix + k] = v
            return out

        def entry(a):
            return list(a) if isinstance(a, tuple) else a

        layouts = {{}}
        for mname, mesh in meshes.items():
            for arch in {ARCHS!r}:
                cfg = get_tiny_config(arch)
                if arch.startswith('seamless'):
                    cfg = cfg.replace(vocab_size=513)
                trees = {{
                    'params': (param_axes(cfg), jax.eval_shape(
                        lambda: init_params(cfg, jax.random.PRNGKey(0)))),
                    'cache': (cache_logical_axes(cfg), jax.eval_shape(
                        lambda: init_cache(cfg, {CACHE_B}, {CACHE_LEN}))),
                    'cache4': (cache_logical_axes(cfg), jax.eval_shape(
                        lambda: init_cache(cfg, 4, {CACHE_LEN})))}}
                for policy in {POLICIES!r}:
                    ctx = make_ctx(mesh, ShardingConfig(policy=policy))
                    for tname, (axes, shapes) in trees.items():
                        sh = flat(sanitize_shardings(
                            tree_shardings(ctx, axes), shapes))
                        shp = flat(shapes)
                        leaves = {{}}
                        for path, s in sh.items():
                            shape = shp[path].shape
                            idx = s.devices_indices_map(shape)
                            blocks = {{}}
                            for coord in np.ndindex(mesh.devices.shape):
                                sl = idx[mesh.devices[coord]]
                                blocks[','.join(map(str, coord))] = [
                                    [x.start or 0,
                                     n if x.stop is None else x.stop]
                                    for x, n in zip(sl, shape)]
                            leaves[path] = dict(
                                spec=[entry(a) for a in s.spec],
                                shape=list(shape), blocks=blocks)
                        layouts['|'.join((mname, arch, policy, tname))] = \\
                            leaves
        with open(d + '/layouts.json', 'w') as f:
            json.dump(layouts, f)

        mesh = meshes['2x2x2']
        spec = P(('pod', 'data'), None)
        inputs = np.load(d + '/inputs.npz')
        out = {{}}
        for name in inputs.files:
            x = jnp.asarray(inputs[name])
            out['hier_' + name] = np.asarray(shard_map(
                lambda xs: hierarchical_psum(xs, 'pod', 'data'), mesh=mesh,
                in_specs=spec, out_specs=spec)(x))
            out['comp_' + name] = np.asarray(shard_map(
                lambda xs: compressed_psum(xs, 'data'), mesh=mesh,
                in_specs=spec, out_specs=spec)(x))
        np.savez(d + '/collectives.npz', **out)
    """, n_dev=8)
    with open(d / "layouts.json") as f:
        layouts = json.load(f)
    return layouts, dict(np.load(d / "collectives.npz"))


def _layouts(mesh):
    """This rank's block of every param and cache leaf, by arch, policy and
    tree: the sanitized spec, the local shape and the offset of the local
    shard in the global tensor."""
    from torch.distributed.tensor import distribute_tensor
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        trees = {
            "params": (param_axes(cfg),
                       init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")),
            "cache": (cache_logical_axes(cfg),
                      init_cache(cfg, CACHE_B, CACHE_LEN, "cpu")),
            "cache4": (cache_logical_axes(cfg),
                       init_cache(cfg, 4, CACHE_LEN, "cpu"))}
        for policy in POLICIES:
            ctx = make_ctx(mesh, ShardingConfig(policy=policy))
            for tname, (axes, tensors) in trees.items():
                sh = sanitize_shardings(tree_shardings(ctx, axes), tensors)

                def block(s, t):
                    whole = torch.arange(t.numel(), dtype=torch.float64
                                         ).reshape(t.shape)
                    local = distribute_tensor(whole, mesh, s.placements,
                                              src_data_rank=None).to_local()
                    first = int(local.reshape(-1)[0]) if local.numel() else 0
                    return dict(spec=[list(a) if isinstance(a, tuple) else a
                                      for a in s.spec],
                                shape=list(local.shape),
                                offset=[int(i) for i in np.unravel_index(
                                    first, tuple(t.shape))])

                out["|".join((arch, policy, tname))] = tree_map(block, sh,
                                                                tensors)
    return out


def _rank_2x2(rank, world):
    """Layouts on a (data=2, model=2) mesh, and ``shard`` under a ctx."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = tmesh.make_test_mesh(2, 2, device_type="cpu")
    res = dict(coord=mesh.get_coordinate(), names=mesh.mesh_dim_names,
               layouts=_layouts(mesh))
    x = torch.arange(8 * 4.0).reshape(8, 4)
    whole = distribute_tensor(x, mesh, [Replicate(), Replicate()],
                              src_data_rank=None)
    assert shard(whole, "batch", None) is whole       # no ctx: identity
    with sharding_ctx(make_ctx(mesh, ShardingConfig())):
        y = shard(whole, "batch", None)
        res["placements"] = y.placements == (Shard(0), Replicate())
        res["local"] = y.to_local()
        res["plain_passes"] = shard(x, "batch", None) is x
        try:
            shard(x, "batch")
            res["rank_check"] = False
        except ValueError:
            res["rank_check"] = True
    return res


def _rank_2x2x2(rank, world, inputs):
    """Layouts and both collectives on a (pod=2, data=2, model=2) mesh."""
    mesh = tmesh.make_test_mesh(2, 2, pods=2, device_type="cpu")
    coord = mesh.get_coordinate()
    k = coord[0] * 2 + coord[1]          # the (pod, data) shard, pod major
    res = dict(coord=coord, names=mesh.mesh_dim_names,
               layouts=_layouts(mesh))
    for name, x in inputs.items():
        rows = x.shape[0] // 4
        xs = torch.from_numpy(x[k * rows:(k + 1) * rows])
        before = xs.clone()
        res["hier_" + name] = tcoll.hierarchical_psum(xs, mesh, "pod",
                                                      "data")
        res["comp_" + name] = tcoll.compressed_psum(xs, mesh, "data")
        assert torch.equal(xs, before)
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_ranks")
    return {"2x2": D.run_ranks(_rank_2x2, 4, tmp),
            "2x2x2": D.run_ranks(_rank_2x2x2, 8, tmp, _inputs())}


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_ranks_sit_on_the_mesh_in_rank_order(ranks, mname):
    shape = MESHES[mname]
    names = ("data", "model") if len(shape) == 2 else \
        ("pod", "data", "model")
    for r, res in enumerate(ranks[mname]):
        assert tuple(res["coord"]) == tuple(np.unravel_index(r, shape))
        assert tuple(res["names"]) == names


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mname", sorted(MESHES))
def test_shard_layouts_match_reference(ref, ranks, mname, arch):
    cfg = _cfg(arch)
    stacks, subs = bridge._stacks(cfg), bridge._sublayers(cfg)
    for policy in POLICIES:
        for tname in ("params", "cache", "cache4"):
            want = ref[0]["|".join((mname, arch, policy, tname))]
            for res in ranks[mname]:
                coord = ",".join(map(str, res["coord"]))
                mine = res["layouts"]["|".join((arch, policy, tname))]
                for path, leaf in want.items():
                    blocks = leaf["blocks"][coord]
                    got, n = D.port_leaves(stacks, subs, mine, path) \
                        if tname == "params" else ([mine[path]], 0)
                    for lo, hi in blocks[:n]:         # stacked: whole
                        assert lo == 0
                    for g in got:
                        assert g["spec"] == leaf["spec"][n:], path
                        assert g["shape"] == [hi - lo for lo, hi
                                              in blocks[n:]], path
                        assert g["offset"] == [lo for lo, _ in blocks[n:]], \
                            path
    if arch.startswith("seamless"):
        # the rules shard the vocab (513) on model and the cache's batch
        # (3) on data: neither divides, so both fell back to replication
        for policy in POLICIES:
            key = "|".join((mname, arch, policy, "{}"))
            assert ref[0][key.format("params")]["embed/embedding"][
                "spec"][0] is None
            assert ref[0][key.format("cache")]["k"]["spec"][1] is None
    if mname == "2x2x2":
        assert ref[0]["|".join((mname, arch, "fsdp", "cache4"))][
            "index"]["spec"] == [["pod", "data"]]


@pytest.mark.parametrize("name", sorted(_inputs()))
@pytest.mark.parametrize("op", ["hier", "comp"])
def test_collectives_match_reference(ref, ranks, op, name):
    want = ref[1][f"{op}_{name}"]
    rows = want.shape[0] // 4
    for res in ranks["2x2x2"]:
        k = res["coord"][0] * 2 + res["coord"][1]
        np.testing.assert_allclose(res[f"{op}_{name}"].numpy(),
                                   want[k * rows:(k + 1) * rows],
                                   rtol=TOL, atol=TOL * np.abs(want).max())


def test_hierarchical_psum_is_the_sum_over_pod_and_data(ranks):
    """The reference test's own expectation: every (pod, data) shard holds
    the sum of the four shards."""
    x = _inputs()["x"]
    expect = x.reshape(4, 2, 16).sum(0)
    for res in ranks["2x2x2"]:
        np.testing.assert_allclose(res["hier_x"].numpy(), expect, rtol=TOL)


def test_shard_redistributes_a_dtensor_under_a_ctx(ranks):
    for res in ranks["2x2"]:
        b = res["coord"][0]
        assert res["placements"] and res["plain_passes"] and \
            res["rank_check"]
        want = torch.arange(8 * 4.0).reshape(8, 4)[4 * b:4 * (b + 1)]
        assert torch.equal(res["local"], want)


def test_production_mesh_shapes_and_names(monkeypatch):
    calls = []
    monkeypatch.setattr(tmesh, "init_device_mesh",
                        lambda *a, **kw: calls.append((a, kw)))
    tmesh.make_production_mesh()
    tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    tmesh.make_test_mesh(4, 2, pods=2, device_type="cpu")
    assert calls == [
        (("cuda", (16, 16)), {"mesh_dim_names": ("data", "model")}),
        (("cpu", (2, 16, 16)), {"mesh_dim_names": ("pod", "data", "model")}),
        (("cpu", (2, 4, 2)), {"mesh_dim_names": ("pod", "data", "model")})]


def test_importing_the_port_touches_no_process_group():
    import repro_torch.launch.mesh  # noqa: F401
    import repro_torch.parallel.ep_moe  # noqa: F401
    import repro_torch.parallel.sharding  # noqa: F401
    assert not dist.is_initialized()
