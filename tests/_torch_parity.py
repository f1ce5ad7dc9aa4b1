"""Helpers for the port's parity tests: one config, params and batch, two
packages.  Parameters are made by one package and carried to the other
through ``repro_torch.bridge`` as numpy arrays (``params``: JAX-made;
``port_params``: port-made); token batches are numpy."""
import jax
import numpy as np
import torch

from repro.configs import get_tiny_config as jax_tiny
from repro.models import init_params as jax_init
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_tiny_config as torch_tiny
from repro_torch.models import init_params as torch_init


def configs(arch, **kw):
    """(reference config, port config) of the tiny ``arch``, both replaced."""
    return jax_tiny(arch).replace(**kw), torch_tiny(arch).replace(**kw)


def params(jcfg, tcfg, seed=0):
    """(JAX params, the same params in the port on the CPU)."""
    jp = jax_init(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def batches(cfg, B, S, seed=0):
    """(JAX batch, port batch) of random tokens with positions 0..S-1."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jb = {"tokens": jax.numpy.asarray(tokens),
          "positions": jax.numpy.asarray(positions)}
    tb = {"tokens": torch.from_numpy(tokens).long(),
          "positions": torch.from_numpy(positions)}
    return jb, tb


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
