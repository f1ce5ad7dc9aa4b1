"""Training: the program's train step over packed batches, one after
another, on one train state.

Set-up makes the weights from the seed, builds the step and its
optimizer state, and drives that same state through its first ``FIRST``
steps on batches 0, 1, ... (which also warm every shape up), reading as
it goes: each step's loss; after step 1, each leaf's first gradient as
the optimizer got it, from the first moment (m = (1 - b1) g, decoded
from its int8 codes); after the last, each leaf's change from the seed's
weights.  The window's units are the steps after those, on the batches
after theirs.

The check: the configuration's plain reference follows the same steps
in f32 (the layers recomputed one at a time for the backward, as
``remat="full"`` does) and the numbers are compared leaf by leaf.
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from portbench import flops, weights
from portbench.harness import Marks, program_config
from portbench.tokens import Pool
from portbench.reference.common import AdamW8, Prec, clip_, dq8, no_tf32

RATE = "train_tokens_per_s"
FIRST = 2          # steps the reference follows: two, not three, so that
                   # it takes less time than the window
MOVED = 1e-3       # a leaf moves if its first gradient is over this share
                   # of the median leaf's (in the reference)


def get(tree: Any, path: Tuple) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def decays(groups) -> Dict[Tuple, bool]:
    """Weight decay on a leaf of rank >= 2 where a layer index counts as
    an axis (the configuration's optimizer states it of stacked layers)."""
    return {path: len(shape) + sum(isinstance(k, int) for k in path) >= 2
            for _, leaves in groups for path, shape, _, _ in leaves}


def change_norms(params_of, groups, seed, device) -> Dict[Tuple, float]:
    """Each leaf's ||now - the seed's weights||, a group at a time."""
    out = {}
    for gi in range(len(groups)):
        for path, t0 in weights.make_group(groups, gi, seed, device).items():
            out[path] = float((params_of(path).float() - t0.float()).norm())
    return out


def worst_leaf(got: Dict, want: Dict, keys) -> float:
    """max over ``keys`` of |got - want| / max(want, the median leaf's)."""
    med = statistics.median(want[k] for k in keys)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keys)


def median_leaf(got: Dict, want: Dict, keys) -> float:
    """The median over ``keys`` of |got - want| / max(want, the median
    leaf's): the gap of a typical leaf, steady where a few small leaves'
    gaps are noise."""
    med = statistics.median(want[k] for k in keys)
    return statistics.median(abs(got[k] - want[k]) / max(want[k], med)
                             for k in keys)


def reference_steps(cell, pool: Pool, prec: Prec, steps: int = FIRST
                    ) -> Dict[str, Any]:
    """The reference's losses, first gradients and changes."""
    ref, m = cell.reference, cell.conf["model"]
    o = cell.conf["train"]["optim"]
    groups = ref.leaves(m, "float32")
    dev, seed, L = cell.device, cell.seed, m["num_layers"]
    n_micro = cell.traffic["microbatches"]
    no_tf32()
    flat = {}
    for gi in range(len(groups)):
        flat.update(weights.make_group(groups, gi, seed, dev))
    head_keys = [p for p, _, _, _ in groups[0][1]]
    layer_keys = [[p for p, _, _, _ in groups[i + 1][1]] for i in range(L)]
    opt = AdamW8(flat, o, decays(groups))
    losses, zs, first = [], [], None
    for s in range(steps):
        grads = {k: torch.zeros_like(t) for k, t in flat.items()}
        total = 0.0
        batch = pool.get(s)
        for mb in range(n_micro):
            rows = slice(mb * pool.batch // n_micro,
                         (mb + 1) * pool.batch // n_micro)
            loss, z = _micro(ref, m, flat, head_keys, layer_keys,
                             batch["tokens"][rows], batch["targets"][rows],
                             prec, grads)
            total += loss
        for g in grads.values():
            g.div_(n_micro)
        losses.append(total / n_micro)
        zs.append(z)
        clip_(grads, o["grad_clip"])
        opt.step(flat, grads)
        del grads
        if s == 0:
            first = {k: float(opt.first_moment(k).norm()) / (1 - o["b1"])
                     for k in flat}
    change = change_norms(flat.__getitem__, groups, seed, dev)
    return {"losses": losses, "z": zs, "first_grad": first,
            "change": change}


def _micro(ref, m, flat, head_keys, layer_keys, toks, tgts, prec,
           grads) -> Tuple[float, float]:
    """One microbatch's loss and z; its grads added into ``grads``.  The
    forward keeps each layer's input; the backward runs the layers again
    one at a time."""
    L = m["num_layers"]
    g0 = {k: flat[k] for k in head_keys}
    with torch.no_grad():
        h = ref.embed(g0, toks)
        stash = [h]
        for i in range(L):
            h, _ = ref.layer(m, _layer(ref, flat, layer_keys[i], i), h, prec)
            stash.append(h)
    # the head, with grads for h_L and its own leaves
    hL = stash[L].requires_grad_(True)
    hk = [k for k in head_keys if k != ("embed", "embedding")]
    for k in hk:
        flat[k].requires_grad_(True)
    with torch.enable_grad():
        out = ref.head(m, g0, hL, tgts, prec)
        loss = out["ce"] + out["z"]
        gs = torch.autograd.grad(loss, [hL] + [flat[k] for k in hk])
    for k in hk:
        flat[k].requires_grad_(False)
        grads[k] += gs[1 + hk.index(k)]
    gh = gs[0]
    loss_v, z = float(loss.detach()), float(out["z"].detach())
    for i in reversed(range(L)):
        keys = layer_keys[i]
        for k in keys:
            flat[k].requires_grad_(True)
        hin = stash[i].requires_grad_(True)
        with torch.enable_grad():
            hout, aux = ref.layer(m, _layer(ref, flat, keys, i), hin, prec)
            outs, gos = [hout], [gh]
            if aux is not None:
                outs.append(aux)
                gos.append(torch.ones_like(aux))
                loss_v += float(aux)
            gs = torch.autograd.grad(outs, [hin] + [flat[k] for k in keys],
                                     gos)
        for k in keys:
            flat[k].requires_grad_(False)
        for k, g in zip(keys, gs[1:]):
            grads[k] += g
        gh = gs[0]
        stash[i + 1] = None
    emb = ("embed", "embedding")
    grads[emb].index_add_(0, toks.reshape(-1).long(),
                          gh.reshape(-1, gh.shape[-1]))
    return loss_v, z


def _layer(ref, flat, keys, i):
    return ref.layer_of({k: flat[k] for k in keys}, i)


class Work:
    RATE = RATE

    def __init__(self, cell):
        self.cell = cell
        t = cell.traffic
        self.batch, self.seq = t["batch"], t["seq"]

    def setup(self) -> None:
        mark = Marks(self)
        from repro_torch.config import TRAIN, OptimConfig, RunConfig, \
            ShapeConfig
        from repro_torch.train import make_opt_state, make_train_step
        mark("program_import")
        c = self.cell
        o = c.conf["train"]["optim"]
        self.cfg = program_config(c.conf, "train")
        self.groups = c.reference.leaves(c.conf["model"],
                                         self.cfg.param_dtype)
        self.params = weights.make_params(self.groups, c.seed, c.device)
        mark("weights")
        self.pool = Pool(c.seed, c.traffic["pool_batches"], self.batch,
                         self.seq, self.cfg.vocab_size, c.device)
        mark("tokens")
        run = RunConfig(model=self.cfg, shape=ShapeConfig(
            "portbench", TRAIN, self.seq, self.batch),
            optim=OptimConfig(**o),
            microbatches=c.traffic["microbatches"])
        self.opt = make_opt_state(run, self.params)
        self.train = make_train_step(run)
        self.losses, self.zs = [], []
        for s in range(FIRST):
            self.params, self.opt, met = self.train(self.params, self.opt,
                                                    self.pool.get(s))
            self.losses.append(float(met["loss"]))
            self.zs.append(float(met["z"]))
            mark(f"step{s + 1}")
            if s == 0:
                self.first = self._first_grads(o)
        self.change = change_norms(lambda p: get(self.params, p),
                                   self.groups, c.seed, c.device)
        mark("readings")
        self.step_losses: List[torch.Tensor] = []

    def _first_grads(self, o) -> Dict[Tuple, float]:
        out = {}
        for _, leaves in self.groups:
            for path, _, _, _ in leaves:
                mq = get(self.opt["m"], path)
                m = dq8(mq["q"], mq["s"], o["int8_block"]) \
                    if isinstance(mq, dict) else mq.float()
                out[path] = float(m.norm()) / (1 - o["b1"])
        return out

    def step(self, i: int) -> int:
        self.params, self.opt, met = self.train(self.params, self.opt,
                                                self.pool.get(FIRST + i))
        self.step_losses.append(met["loss"].detach())
        return self.batch * self.seq

    def due(self, units: int) -> List[int]:
        return []          # the check reads the set-up's steps

    def flops_per_token(self) -> float:
        return 3 * flops.model_flops_per_token(self.cell.conf["model"],
                                               self.seq)

    def free(self) -> None:
        self.window_losses = [float(x) for x in self.step_losses]
        del self.params, self.opt, self.train
        if self.cell.device == "cuda":
            torch.cuda.empty_cache()

    def check(self, units: int) -> Tuple[List[Dict], int]:
        bad = sum(1 for x in self.window_losses if not np.isfinite(x))
        want = reference_steps(self.cell, self.pool, Prec(fp8=False))
        g = readings(self.losses, self.zs, self.first, self.change, want)
        self.readings = g
        checks = [{"name": k, "value": g[k], "limit": lim}
                  for k, lim in self.cell.limits.items()]
        return checks, bad


def readings(losses, zs, first, change, want) -> Dict[str, Any]:
    """The numbers compared (``limits/<cell>.json`` holds some of them;
    the others are printed beside them)."""
    keys = list(want["first_grad"])
    med = statistics.median(want["first_grad"][k] for k in keys)
    moved = [k for k in keys if want["first_grad"][k] >= MOVED * med]
    return {"loss_gap": max(abs(a - b) for a, b in
                            zip(losses, want["losses"])),
            "z_gap": max(abs(a - b) for a, b in zip(zs, want["z"])),
            "first_grad_gap": worst_leaf(first, want["first_grad"], keys),
            "change_gap": worst_leaf(change, want["change"], moved),
            "first_grad_median_gap": median_leaf(first, want["first_grad"],
                                                 keys),
            "change_median_gap": median_leaf(change, want["change"], moved),
            "leaves_left_out": len(keys) - len(moved),
            "losses": [losses, want["losses"]],
            "worst": {"first_grad": _worst(first, want["first_grad"], keys),
                      "change": _worst(change, want["change"], moved)}}


def _worst(got, want, keys, n: int = 4):
    med = statistics.median(want[k] for k in keys)
    gap = {k: abs(got[k] - want[k]) / max(want[k], med) for k in keys}
    top = sorted(keys, key=lambda k: -gap[k])[:n]
    return [["/".join(map(str, k)), gap[k], got[k], want[k]] for k in top]
