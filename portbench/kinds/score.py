"""Scoring: the program's eval step over packed batches, one after another.

A unit is one batch of ``batch`` x ``seq`` tokens through
``make_eval_step``; its answer is the batch's ce, z and aux.  Of the
units of the check's sample it is also what the blocks were handed and
gave (the calls that ``models.model._scan_blocks`` makes; a block is a
layer, or a hybrid's superblock of ``hybrid_period`` layers): the first
block's input, every row of it, and the residual stream of
``check_rows`` of the batch's rows (drawn from the seed) at each later
block's input and after the last; and the final hidden state of every
row (the input of ``models.model._logits``).  The sample is
``check_batches`` of the first ``check_from`` units, drawn from the seed
before the window; a sampled unit that the window did not reach runs
after it.

The check makes the sample's tokens and the weights again from the seed
and runs the configuration's plain reference over them in f32, a block
at a time (``Prec(fp8=True)``: the control).  Besides the batch's ce, z
and aux it runs each block on the program's own input to that block, so
that each block is held to the reference alone (``step_gap``), the
start (the embedding) with it: a random model's residual stream drifts
from the f32 one through its depth by rounding alone, so the final
hidden state's widest row (``hidden_gap``) is read, and the blocks are
judged one by one.  Of the final hidden state it also reads the whole
batch's gap and the median token's (``hidden_rms_gap``,
``hidden_median_gap``), which a few tokens whose routing flips between
bf16 and f32 leave alone.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import flops, tokens, weights
from portbench.harness import BenchError, Marks, program_config
from portbench.reference.common import Prec, no_tf32
from portbench.tokens import Pool

RATE = "score_tokens_per_s"
ANSWERS = ("ce", "z", "aux")
MODEL = "repro_torch.models.model"     # where _scan_blocks and _logits live


def sample(seed: int, n: int, k: int, stream: int = 1) -> List[int]:
    """k of the first n units (or rows), drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [tokens.stream_seed(seed), stream]))
    return sorted(int(i) for i in rng.choice(n, size=min(k, n),
                                             replace=False))


def check_rows(cell) -> List[int]:
    """The rows whose every block is checked (none: the blocks are not
    captured, and no ``step_gap`` is read).  An MoE layer routes the
    whole batch under one capacity, so a block run on some of its rows
    is another function: with experts, every row or none."""
    t = cell.traffic
    if not t["check_rows"]:
        return []
    if (cell.conf["model"].get("moe") or {}).get("num_experts", 0) > 0 \
            and t["check_rows"] < t["batch"]:
        raise BenchError(f"{cell.name}: with experts, check_rows is 0 or "
                         f"at least the batch ({t['batch']})")
    return sample(cell.seed, t["batch"], t["check_rows"], stream=2)


def blocks(ref, m: Dict) -> int:
    """The blocks that ``models.model._scan_blocks`` steps: the family's
    ``blocks`` where its reference defines one (a hybrid's superblocks),
    else one a layer."""
    return ref.blocks(m) if hasattr(ref, "blocks") else m["num_layers"]


def run_block(ref, m: Dict, make, b: int, xs: List[torch.Tensor],
              prec: Prec) -> List:
    """Block b on each of ``xs``: [(h, aux or None)], ``make(g)`` making
    weight group g: the family's ``block`` where its reference defines
    one, else layer b from group b + 1."""
    if hasattr(ref, "block"):
        return ref.block(m, make, b, xs, prec)
    p = ref.layer_of(make(b + 1), b)
    return [ref.layer(m, p, x, prec) for x in xs]


def reference(cell, pool: Pool, idx: List[int], prec: Prec,
              forced: Optional[Dict[str, Dict[int, List]]] = None
              ) -> Dict[int, Dict]:
    """The reference over batches ``idx``, the weights made again a block
    at a time (``run_block``): each batch's ce, z, aux, embedding (``start``), final
    hidden state (``hidden``, f32, before the final norm) and residual
    stream of the check's rows at each block's input and after the last
    (``layers``); and, for each ``forced[what][i]`` (such a list of a
    run's own states), each block run on that run's input to it
    (``forced[what]``)."""
    ref, m = cell.reference, cell.conf["model"]
    groups = ref.leaves(m, cell.conf["score"]["param_dtype"])
    rows = check_rows(cell)
    forced = forced or {}
    no_tf32()

    def make(g: int) -> Dict:
        return weights.make_group(groups, g, cell.seed, cell.device)

    with torch.no_grad():
        g0 = make(0)
        h = {i: ref.embed(g0, pool.get(i)["tokens"]) for i in idx}
        start = dict(h)
        layers = {i: [h[i][rows]] if rows else None for i in idx}
        aux = {i: 0.0 for i in idx}
        led = {w: {i: [] for i in f} for w, f in forced.items()}
        for b in range(blocks(ref, m)):
            ins = [(w, i, states[b]) for w, f in forced.items()
                   for i, states in f.items()
                   if b < len(states) and states[b] is not None]
            outs = run_block(ref, m, make, b, [h[i] for i in idx]
                             + [x.float() for _, _, x in ins], prec)
            for i, (hi, a) in zip(idx, outs):
                h[i] = hi
                if rows:
                    layers[i].append(hi[rows])
                if a is not None:
                    aux[i] += float(a)
            ran = {(w, i): y for (w, i, _), (y, _)
                   in zip(ins, outs[len(idx):])}
            for w, f in forced.items():
                for i in f:
                    led[w][i].append(ran.get((w, i)))
        out = {}
        for i in idx:
            hi = h.pop(i)
            r = ref.head(m, g0, hi, pool.get(i)["targets"], prec)
            out[i] = {"ce": float(r["ce"]), "z": float(r["z"]),
                      "aux": aux[i], "hidden": hi, "start": start[i],
                      "layers": layers[i],
                      "forced": {w: led[w][i] for w in led if i in led[w]}}
    return out


def rel(got: Optional[torch.Tensor], want: torch.Tensor,
        scale: Optional[torch.Tensor] = None) -> float:
    """The widest over the rows of ||got - want|| / ||scale|| (``scale``
    defaults to ``want``); inf where ``got`` is missing or its shape
    differs."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return float("inf")
    g, w = got.float().flatten(1), want.float().flatten(1)
    s = w if scale is None else scale.float().flatten(1)
    return float(((g - w).norm(dim=1) / s.norm(dim=1)).max())


def hidden_gap(got: Optional[torch.Tensor], want: torch.Tensor) -> float:
    """The final hidden state's widest gap over the batch's rows."""
    return rel(got, want)


def hidden_spread(got: Optional[torch.Tensor], want: torch.Tensor
                  ) -> Tuple[float, float]:
    """The final hidden state's gap over the whole batch (||got - want|| /
    ||want||) and the median over its tokens of each token's gap: a few
    tokens whose routing flips move neither much; inf where the shapes
    differ."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return float("inf"), float("inf")
    g = got.float().flatten(0, -2)
    w = want.float().flatten(0, -2)
    whole = float((g - w).norm() / w.norm())
    tokens = (g - w).norm(dim=1) / w.norm(dim=1)
    return whole, float(tokens.median())


def step_gaps(start: Optional[torch.Tensor],
              states: Optional[List[torch.Tensor]], embed: torch.Tensor,
              forced: List[Optional[torch.Tensor]]) -> List[float]:
    """Of one batch: the start's gap (the run's input to the first block
    against the reference's embedding, every row, over its norm), then
    each block's of the check rows (the run's output against the
    reference's block on the run's own input, over the reference's update
    ||block(x) - x||)."""
    n = len(forced)
    if states is None or len(states) != n + 1:
        return [float("inf")] * (n + 1)
    out = [rel(start, embed)]
    for l in range(n):
        if forced[l] is None:
            out.append(float("inf"))
            continue
        out.append(rel(states[l + 1], forced[l], forced[l]
                       - states[l].float()))
    return out


def gaps(got: Dict[int, Dict], want: Dict[int, Dict], what: str = "program"
         ) -> Dict[str, float]:
    """The widest gap of each answer over the batches compared."""
    out = {f"{a}_gap": max(abs(got[i][a] - want[i][a]) for i in want)
           for a in ANSWERS}
    out["hidden_gap"] = max(hidden_gap(got[i].get("hidden"),
                                       want[i]["hidden"]) for i in want)
    spread = [hidden_spread(got[i].get("hidden"), want[i]["hidden"])
              for i in want]
    out["hidden_rms_gap"] = max(x[0] for x in spread)
    out["hidden_median_gap"] = max(x[1] for x in spread)
    if all(want[i]["layers"] is not None for i in want):
        out["step_gap"] = max(max(step_gaps(
            got[i].get("start"), got[i].get("layers"), want[i]["start"],
            want[i]["forced"].get(what, []))) for i in want)
    return out


def rows_over(got: Dict[int, Dict], want: Dict[int, Dict],
              limits: Dict[str, float]) -> int:
    """How many of the batches compared have a gap over its limit."""
    return sum(1 for i in want if any(
        gaps({i: got[i]}, {i: want[i]})[k] > lim
        for k, lim in limits.items()))


class Capture:
    """While installed, what the program's forward hands its blocks and
    its head: the residual stream of ``rows`` at each block's input and
    after the last (``None`` where the forward got another number of rows
    than the batch has), and the head's input."""

    def __init__(self, rows: List[int], batch: int):
        self.module = importlib.import_module(MODEL)
        self.rows, self.batch = rows, batch
        self.layers: List[Optional[torch.Tensor]] = []
        self.start = self.hidden = None

    def _rows(self, h: torch.Tensor) -> Optional[torch.Tensor]:
        if h.shape[0] != self.batch:
            return None
        return h.detach()[self.rows]

    def __enter__(self):
        scan, logits = self.module._scan_blocks, self.module._logits
        self.orig = scan, logits

        def layered(cfg, blocks, h, apply_fn):
            def apply(lp, hh):
                if not self.layers:
                    self.start = hh.detach().clone()
                self.layers.append(self._rows(hh))
                return apply_fn(lp, hh)
            out = scan(cfg, blocks, h, apply)
            self.layers.append(self._rows(out[0]))
            return out

        def head(cfg, p, h):
            self.hidden = h.detach().clone()
            return logits(cfg, p, h)

        self.module._logits = head
        if self.rows:
            self.module._scan_blocks = layered
        return self

    def __exit__(self, *exc):
        self.module._scan_blocks, self.module._logits = self.orig


class Work:
    RATE = RATE

    def __init__(self, cell):
        self.cell = cell
        t = cell.traffic
        self.batch, self.seq = t["batch"], t["seq"]

    def setup(self) -> None:
        mark = Marks(self)
        from repro_torch.config import PREFILL, RunConfig, ShapeConfig
        from repro_torch.train import make_eval_step
        mark("program_import")
        c = self.cell
        self.cfg = program_config(c.conf, "score")
        groups = c.reference.leaves(c.conf["model"], self.cfg.param_dtype)
        self.params = weights.make_params(groups, c.seed, c.device)
        mark("weights")
        self.pool = Pool(c.seed, c.traffic["pool_batches"], self.batch,
                         self.seq, self.cfg.vocab_size, c.device)
        mark("tokens")
        run = RunConfig(model=self.cfg, shape=ShapeConfig(
            "portbench", PREFILL, self.seq, self.batch))
        self.eval = make_eval_step(run)
        self.answers: Dict[int, Dict[str, torch.Tensor]] = {}
        self.sampled = sample(c.seed, c.traffic["check_from"],
                              c.traffic["check_batches"])
        self.rows = check_rows(c)
        for j in range(c.traffic["warmup_units"]):
            self.eval(self.params, self.pool.get(0))
            mark(f"warmup{j}")

    def step(self, i: int) -> int:
        if i in self.sampled:
            with Capture(self.rows, self.batch) as cap:
                out = self.eval(self.params, self.pool.get(i))
        else:
            out = self.eval(self.params, self.pool.get(i))
        self.answers[i] = {a: out[a].detach() for a in ANSWERS}
        if i in self.sampled:
            self.answers[i].update(start=cap.start, hidden=cap.hidden,
                                   layers=cap.layers)
        return self.batch * self.seq

    def due(self, units: int) -> List[int]:
        return [i for i in self.sampled if i >= units]

    def flops_per_token(self) -> float:
        return flops.model_flops_per_token(self.cell.conf["model"], self.seq)

    def free(self) -> None:
        del self.params, self.eval
        if self.cell.device == "cuda":
            torch.cuda.empty_cache()

    def check(self, units: int) -> Tuple[List[Dict], int]:
        got = {i: answers(ans) for i, ans in self.answers.items()}
        bad = sum(1 for i in range(units) if not all(
            np.isfinite(got[i][a]) for a in ANSWERS))
        forced = {"program": {i: got[i]["layers"] for i in self.sampled}} \
            if self.rows else None
        want = reference(self.cell, self.pool, self.sampled, Prec(fp8=False),
                         forced)
        g = gaps(got, want)
        checks = [{"name": k, "value": g[k], "limit": lim}
                  for k, lim in self.cell.limits.items()]
        self.readings = {"sampled": self.sampled, "rows": self.rows,
                         "gaps": g, "signed": {
                             a: [got[i][a] - want[i][a]
                                 for i in self.sampled] for a in ANSWERS}}
        return checks, bad + rows_over(got, want, self.cell.limits)


def answers(ans: Dict) -> Dict:
    """A unit's answers as numbers, its captured states as they are."""
    return {a: (float(v) if a in ANSWERS else v)
            for a, v in ans.items()}
