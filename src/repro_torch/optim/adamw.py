"""AdamW with optional blockwise-int8 moment quantization.

Counterpart of ``repro/optim/adamw.py``.  The int8 path stores ``m``/``v``
as int8 codes plus per-block f32 scales along the last dim (``v`` in the
sqrt domain), 2 bytes a parameter plus scales instead of 8.

The port's params are nested dicts whose ``blocks`` (and a hybrid
superblock's ``mamba``/``mlp``/``moe``) are lists of per-layer dicts where
the reference stacks the layers on a leading axis.  Two things follow:

- *Decay mask.*  The reference decays every leaf of rank >= 2 in its
  stacked layout, so a layer's norm scale [L, d] is decayed.  Here each
  list on a leaf's path counts as the axis it stands for, so the same
  leaves are decayed.
- *In place.*  ``adamw_update``, ``clip_by_global_norm`` write into the
  tensors they are given, under ``torch.no_grad()``, and return the same
  objects: at full width a second copy of the f32 parameters would not
  fit beside the grads and moments.  A large leaf is updated in slabs of
  rows, which bounds the temporaries and changes no result (every op is
  elementwise or works within a row's int8 blocks).

On a mesh the leaves are DTensors laid out by ``parallel/sharding.py``:
``global_norm`` reduces each leaf as DTensor does (a replicated element
counts once), and ``adamw_update`` brings each grad to its param's
placements, then updates each rank's own blocks.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.config.base import OptimConfig

Params = Any

# elements of one slab of a leaf's rows in ``adamw_update``
_SLAB = 1 << 25


# ---------------------------------------------------------------------------
# trees: nested dicts and lists of tensors
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of ``tree``, with the entries of ``rest`` at
    the same paths (which may be subtrees, such as an int8 moment's
    ``{"q", "s"}``); returns a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def _leaves_with_rank(tree: Any, *rest: Any, lists: int = 0,
                      ) -> Iterator[Tuple[Any, ...]]:
    """(leaf, entries of ``rest`` at its path, its rank in the reference's
    stacked layout: its own rank plus one for every list on its path)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_rank(v, *(r[k] for r in rest),
                                         lists=lists)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_rank(v, *(r[i] for r in rest),
                                         lists=lists + 1)
    else:
        yield (tree, *rest, tree.dim() + lists)


# ---------------------------------------------------------------------------
# blockwise int8 codec
# ---------------------------------------------------------------------------

def _blocks(n: int, block: int) -> int:
    return -(-n // block)


def q8_encode(x: torch.Tensor, block: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (codes int8 [..., D], scales f32 [..., nb])."""
    D = x.shape[-1]
    nb = _blocks(D, block)
    xb = torch.nn.functional.pad(x, (0, nb * block - D)).reshape(
        *x.shape[:-1], nb, block)
    scale = xb.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale == 0.0, 1.0, scale)
    codes = torch.round(xb / safe[..., None]).clamp_(-127, 127).to(torch.int8)
    return codes.reshape(*x.shape[:-1], nb * block)[..., :D], scale


def q8_decode(codes: torch.Tensor, scale: torch.Tensor, block: int
              ) -> torch.Tensor:
    D = codes.shape[-1]
    nb = scale.shape[-1]
    cp = torch.nn.functional.pad(codes, (0, nb * block - D))
    out = cp.reshape(*codes.shape[:-1], nb, block).float() * scale[..., None]
    return out.reshape(*codes.shape[:-1], nb * block)[..., :D]


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def init_state(params: Params, cfg: OptimConfig) -> Dict[str, Any]:
    """Zero moments beside ``params`` (same devices), ``count`` 0 (int32).
    On DTensor params each moment is laid out as ``state_axes`` lays it:
    like its param, an int8 moment's scales with the last dim's blocks
    unsharded; ``count`` replicated.  Each rank allocates its blocks only."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    def zq(p):
        p = p if p.dim() else p.reshape(1)
        nb = _blocks(p.shape[-1], cfg.int8_block)
        q = torch.zeros_like(p, dtype=torch.int8)
        shape = p.shape[:-1] + (nb,)
        if not isinstance(p, DTensor):
            return {"q": q, "s": torch.zeros(shape, dtype=torch.float32,
                                             device=p.device)}
        last = p.dim() - 1
        pl = tuple(Replicate() if x.is_shard(last) else x
                   for x in p.placements)
        local = p.to_local().shape[:-1] + (nb,)
        s = DTensor.from_local(
            torch.zeros(local, dtype=torch.float32, device=p.device),
            p.device_mesh, pl, run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
        return {"q": q, "s": s}

    mk = zq if cfg.state_dtype == "int8" else zeros
    first = tree_leaves(params)[0]
    count = torch.zeros((), dtype=torch.int32, device=first.device)
    if isinstance(first, DTensor):
        count = DTensor.from_local(count, first.device_mesh,
                                   [Replicate()] * first.device_mesh.ndim,
                                   run_check=False)
    return {"m": tree_map(mk, params), "v": tree_map(mk, params),
            "count": count}


def state_axes(param_axes_tree: Any, cfg: OptimConfig) -> Dict[str, Any]:
    """Logical axes of ``init_state``'s tree from the params' axes
    (``models.param_axes``): the moments follow their leaf's axes; an int8
    moment's scales ``s`` [..., nb] keep all but the last dim's, whose
    blocks are not sharded."""
    if cfg.state_dtype == "int8":
        def mk(ax):
            return {"q": ax, "s": ax[:-1] + (None,) if ax else (None,)}
        m = tree_map(mk, param_axes_tree)
        v = tree_map(mk, param_axes_tree)
    else:
        m = param_axes_tree
        v = param_axes_tree
    return {"m": m, "v": v, "count": ()}


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------

@torch.no_grad()
def global_norm(tree: Params) -> torch.Tensor:
    """The L2 norm of all the leaves, a plain 0-dim tensor.  A DTensor
    leaf's sum of squares is DTensor's own reduction, which counts a
    replicated element once (a sum of the local blocks followed by an
    all-reduce would count it once a replica)."""
    total = None
    for x in tree_leaves(tree):
        sq = x.float().square().sum()
        if isinstance(sq, DTensor):
            sq = sq.full_tensor()
        total = sq if total is None else total + sq
    return total.sqrt()


@torch.no_grad()
def clip_by_global_norm(grads: Params, max_norm: float,
                        ) -> Tuple[Params, torch.Tensor]:
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, gn


def _slabs(*tensors: Any) -> Iterator[Tuple[Any, ...]]:
    """The same slab of rows of every tensor (or ``{"q", "s"}`` pair):
    whole leaves when small or of rank < 2."""
    p = tensors[0]
    if p.dim() < 2 or p.numel() <= _SLAB:
        yield tensors
        return
    rows = max(1, _SLAB // (p.numel() // p.shape[0]))
    for r in range(0, p.shape[0], rows):
        yield tuple({k: v[r:r + rows] for k, v in t.items()}
                    if isinstance(t, dict) else t[r:r + rows]
                    for t in tensors)


@torch.no_grad()
def adamw_update(grads: Params, state: Dict[str, Any], params: Params,
                 lr: torch.Tensor, cfg: OptimConfig) -> Tuple[Params, Dict]:
    """One AdamW step, in place: ``params`` and ``state``'s moments and
    count are overwritten; returns (params, state), the same objects."""
    count = state["count"] + 1
    cf = _local(count).float() if isinstance(count, DTensor) else count.float()
    bc1 = 1.0 - cfg.b1 ** cf
    bc2 = 1.0 - cfg.b2 ** cf
    blk = cfg.int8_block
    use_q8 = cfg.state_dtype == "int8"

    def upd(g, m, v, p, wd):
        g32 = g.float()
        if use_q8:
            g2 = g32 if g32.dim() else g32.reshape(1)
            m_f = q8_decode(m["q"], m["s"], blk)
            # v codes live in the sqrt domain: a linear int8 grid on v
            # rounds small second moments to 0 and the step
            # m/(sqrt(v)+eps) explodes; quantizing sqrt(v) bounds the
            # error of sqrt(v) itself
            v_f = q8_decode(v["q"], v["s"], blk).square()
            m_new = cfg.b1 * m_f + (1 - cfg.b1) * g2
            v_new = cfg.b2 * v_f + (1 - cfg.b2) * g2.square()
        else:
            m_new = cfg.b1 * m + (1 - cfg.b1) * g32
            v_new = cfg.b2 * v + (1 - cfg.b2) * g32.square()
        step = (m_new / bc1) / ((v_new / bc2).sqrt() + cfg.eps)
        if use_q8 and not g32.dim():
            step = step.reshape(())
        p32 = p.float()
        p.copy_(p32 - lr * (step + wd * p32))
        if use_q8:
            for st, x in ((m, m_new), (v, v_new.sqrt())):
                q, s = q8_encode(x, blk)
                st["q"].copy_(q)
                st["s"].copy_(s)
        else:
            m.copy_(m_new)
            v.copy_(v_new)

    for p, g, m, v, rank in _leaves_with_rank(params, grads, state["m"],
                                              state["v"]):
        wd = cfg.weight_decay if rank >= 2 else 0.0
        with _local_blocks(p, g, m, v, use_q8) as (pl, gl, ml, vl):
            for ps, gs, ms, vs in _slabs(pl, gl, ml, vl):
                upd(gs, ms, vs, ps, wd)
    state["count"] = count
    return params, state


class _local_blocks:
    """A leaf's param, grad and moments as the plain tensors to update in
    place: themselves off a mesh; on a mesh, each rank's blocks, the grad
    first brought to the param's placements (autograd may hand it back
    partial or otherwise laid out).  An int8 moment keeps whole blocks of
    ``int8_block`` along the last dim, whose scales ``s`` are not sharded
    there (``state_axes``); so where the last dim is sharded, its blocks
    would straddle the shards, and the leaf is gathered along the last
    dim instead: every rank on those mesh dims updates the whole rows, and
    the param and codes are cut back to its block on exit."""

    def __init__(self, p, g, m, v, use_q8: bool):
        self.p, self.g, self.m, self.v = p, g, m, v
        self.use_q8 = use_q8
        self.gather = None

    def __enter__(self):
        p, g, m, v = self.p, self.g, self.m, self.v
        if not isinstance(p, DTensor):
            return p, g, m, v
        mesh = p.device_mesh
        g = g.redistribute(mesh, p.placements)
        last = p.dim() - 1
        rows = tuple(Replicate() if pl.is_shard(last) else pl
                     for pl in p.placements)
        if not self.use_q8 or rows == p.placements or p.dim() == 0:
            return tuple(_local(t) for t in (p, g, m, v))
        self.gather = rows
        self.rows = [t.redistribute(mesh, rows).to_local()
                     for t in (p, g, m["q"], v["q"])]
        pr, gr, mq, vq = self.rows
        return (pr, gr, {"q": mq, "s": m["s"].to_local()},
                {"q": vq, "s": v["s"].to_local()})

    def __exit__(self, *exc):
        if self.gather is None or exc[0] is not None:
            return False
        mesh = self.p.device_mesh
        for whole, t in zip((self.rows[0], self.rows[2], self.rows[3]),
                            (self.p, self.m["q"], self.v["q"])):
            mine = DTensor.from_local(whole, mesh, self.gather,
                                      run_check=False)
            t.to_local().copy_(mine.redistribute(mesh, t.placements)
                               .to_local())
        return False


def _local(t):
    """A DTensor's local block (or an int8 moment's ``{"q", "s"}``)."""
    if isinstance(t, dict):
        return {k: v.to_local() for k, v in t.items()}
    return t.to_local()
