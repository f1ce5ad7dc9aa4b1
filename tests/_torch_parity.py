"""Helpers for the port's parity tests: one config, params and batch (or
data pipeline), two packages.  Parameters are made by one package and
carried to the other through ``repro_torch.bridge`` as numpy arrays
(``params``: JAX-made; ``port_params``: port-made); batches are numpy."""
import dataclasses
import os

import jax
import numpy as np
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_tiny_config as jax_tiny
from repro.data import pipeline as jpipe
from repro.data.batches import batch_shapes
from repro.models import init_params as jax_init
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_tiny_config as torch_tiny
from repro_torch.data import pipeline as tpipe
from repro_torch.models import init_params as torch_init


# the port's config fields that the reference lacks, each at the default
# that computes the reference's function
PORT_ONLY = {("moe", "norm_topk_prob"): True}


def reference_fields(tcfg, jcfg):
    """(``asdict`` of the port's config cut to the reference's fields,
    ``asdict`` of the reference's): each field that the port alone has
    must hold its ``PORT_ONLY`` default, and is then left out."""
    def cut(t, j, path=()):
        if not (isinstance(t, dict) and isinstance(j, dict)):
            return t
        for k in set(t) - set(j):
            assert path + (k,) in PORT_ONLY, (path, k)
            assert t[k] == PORT_ONLY[path + (k,)], (path, k, t[k])
        return {k: cut(t[k], j[k], path + (k,)) for k in t if k in j}
    j = dataclasses.asdict(jcfg)
    return cut(dataclasses.asdict(tcfg), j), j


def configs(arch, **kw):
    """(reference config, port config) of the tiny ``arch``, both replaced."""
    return jax_tiny(arch).replace(**kw), torch_tiny(arch).replace(**kw)


def params(jcfg, tcfg, seed=0):
    """(JAX params, the same params in the port on the CPU)."""
    jp = jax_init(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def batches(cfg, B, S, seed=0):
    """(JAX batch, port batch) of random tokens with positions 0..S-1 (of
    each of t, h, w for a VLM: [3, B, S]), shaped by the reference's
    ``batch_shapes``; an enc-dec or VLM batch adds standard normal
    ``frontend`` embeddings in the config's dtype (a VLM's S counts its
    frontend patches).  No targets."""
    rng = np.random.default_rng(seed)
    shapes = batch_shapes(cfg, B, S)
    tshape = shapes["tokens"][0]
    tokens = rng.integers(0, cfg.vocab_size, tshape).astype(np.int32)
    pshape = shapes["positions"][0]
    positions = np.broadcast_to(np.arange(pshape[-1], dtype=np.int32),
                                pshape).copy()
    jb = {"tokens": jax.numpy.asarray(tokens),
          "positions": jax.numpy.asarray(positions)}
    tb = {"tokens": torch.from_numpy(tokens).long(),
          "positions": torch.from_numpy(positions)}
    if "frontend" in shapes:
        fshape, fdtype = shapes["frontend"]
        f = jax.numpy.asarray(rng.standard_normal(fshape, dtype=np.float32)
                              ).astype(fdtype)
        jb["frontend"] = f
        tb["frontend"] = _to_torch(f)
    return jb, tb


def _to_torch(x):
    """A JAX or numpy array as a CPU tensor (bf16 carried bit for bit)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def port_params(tcfg, seed=0):
    """(the same params as a JAX tree, params made by the port on the CPU):
    the port's ``init_params`` is much faster than the reference's eager
    one, and parity needs only the same values in both."""
    tp = torch_init(tcfg, torch.Generator().manual_seed(seed), "cpu")
    jp = jax.tree.map(jax.numpy.array, params_to_numpy(tcfg, tp))  # copies
    return jp, tp


def assert_pipelines_agree(root, arch, *, batch=2, seq=16, n_batches=12,
                           restore_at=5):
    """The reference's and the port's ``DataPipeline`` for the tiny
    ``arch``, each over its own fabric under ``root`` with the same corpus:
    ``n_batches`` batches equal bit for bit (every entry: tokens, targets,
    positions, frontend), then a fresh port pipeline restored at the
    reference's state after ``restore_at`` batches reads the same batches
    on."""
    jcfg, tcfg = configs(arch)
    pipes = []
    for core, pipe, cfg, name, kw in (
            (jcore, jpipe, jcfg, "jax", {}),
            (tcore, tpipe, tcfg, "torch", {"device": "cpu"})):
        s = core.Fabric(core.FabricSpec.star(
            os.path.join(root, name, "h"), os.path.join(root, name, "site"))
        ).login("sci")
        pipe.SyntheticCorpus(s.client, "home/data", seed=3,
                             vocab=cfg.vocab_size, shard_tokens=500
                             ).materialize(2)
        pipes.append(pipe.DataPipeline(s.client, "home/data", cfg,
                                       batch=batch, seq=seq, n_shards=2,
                                       **kw))
    jp, tp = pipes

    def same(tb, jb):
        assert sorted(tb) == sorted(jb)
        for k, v in jb.items():
            got, want = tb[k], np.asarray(v)
            assert tuple(got.shape) == want.shape, k
            if want.dtype.name == "bfloat16":
                assert got.dtype == torch.bfloat16, k
                got, want = got.view(torch.int16), want.view(np.int16)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)

    state = None
    for i in range(n_batches):
        if i == restore_at:
            state = jp.state()
        same(tp.next_batch(), jp.next_batch())
    assert tp.state() == jp.state()
    fresh = tpipe.DataPipeline(tp.client, "home/data", tcfg, batch=batch,
                               seq=seq, n_shards=2, device="cpu")
    fresh.restore(state)
    jfresh = jpipe.DataPipeline(jp.client, "home/data", jcfg, batch=batch,
                                seq=seq, n_shards=2)
    jfresh.restore(state)
    for _ in range(n_batches - restore_at):
        same(fresh.next_batch(), jfresh.next_batch())
