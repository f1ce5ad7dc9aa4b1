"""Batched serving engine: slot-based continuous batching over the KV cache.

Counterpart of ``repro/serve/engine.py``, tick for tick.  ``ServeEngine``
holds a fixed pool of batch slots.  Requests are admitted into free slots
and prefilled one at a time (prompt lengths vary); then all slots decode
together, one ``decode_step`` per tick.  As in the reference, only the
first token of a request (at admission) is sampled with its temperature;
every later token is the argmax.  Sampling draws from the engine's own
``torch.Generator``.  The shared cache is updated in place.

The enc-dec and VLM families are refused (``check_servable``): the
reference's engine cannot serve them either (its admission batch has no
``frontend``, which the enc-dec encoder needs, and its [1, S] positions
give M-RoPE NaN), and the port adds no serving path the reference lacks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config.base import ENCDEC, VLM, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import (
    cache_batch_axes, decode_step, init_cache, prefill,
)


def check_servable(cfg: ModelConfig) -> None:
    """Raise for a family the reference's engine cannot serve."""
    if cfg.family == ENCDEC:
        raise NotImplementedError(
            f"{cfg.name}: the engine serves no enc-dec model; the "
            "reference's admits a batch without the encoder's 'frontend' "
            "and raises KeyError (ROADMAP Queue 3, reference caveats)")
    if cfg.family == VLM:
        raise NotImplementedError(
            f"{cfg.name}: the engine serves no VLM; the reference's passes "
            "[1, S] positions to M-RoPE, which wants [3, B, S], and emits "
            "NaN logits (ROADMAP Queue 3, reference caveats)")


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    output: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class SlotState:
    rid: int = -1
    active: bool = False
    remaining: int = 0


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 4,
                 max_len: int = 512, seed: int = 0,
                 device: DeviceLike = "cuda"):
        check_servable(cfg)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.cache = init_cache(cfg, slots, max_len, self.device)
        self.batch_axes = cache_batch_axes(cfg)
        self.slot_states = [SlotState() for _ in range(slots)]
        self.requests: Dict[int, Request] = {}
        self.queue: List[int] = []
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # per-slot last emitted token (feeds the next decode step)
        self.last_tokens = np.zeros((slots, 1), np.int64)
        self.tokens_generated = 0

    # ---- admission ----------------------------------------------------------
    def add_request(self, req: Request) -> None:
        self.requests[req.rid] = req
        self.queue.append(req.rid)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slot_states):
            if not s.active:
                return i
        return None

    def _admit(self) -> int:
        """Prefill queued requests into free slots."""
        admitted = 0
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                break
            rid = self.queue.pop(0)
            req = self.requests[rid]
            toks = torch.tensor(req.prompt, dtype=torch.long,
                                device=self.device)[None, :]
            S = toks.shape[1]
            batch = {
                "tokens": toks,
                "positions": torch.arange(S, dtype=torch.int32,
                                          device=self.device)[None, :],
            }
            logits, cache1 = prefill(self.cfg, self.params, batch,
                                     max_len=self.max_len)
            # splice this request's prefilled cache into the shared pool
            self._splice_cache(slot, cache1)
            tok = self._sample(logits[:, -1, :], req.temperature)
            req.output.append(int(tok[0]))
            self.last_tokens[slot, 0] = int(tok[0])
            st = self.slot_states[slot]
            st.rid, st.active, st.remaining = rid, True, \
                req.max_new_tokens - 1
            admitted += 1
        return admitted

    def _splice_cache(self, slot: int, cache1: Any) -> None:
        """Overwrite slot ``slot`` of the pool with a one-request cache.

        Each entry splices along its own batch axis (``cache_batch_axes``):
        axis 1 for dense and hybrid k/v [L, B, max_len, kv] and the RWKV6
        tshift/cshift [L, B, d] and wkv [L, B, H, D, D]; axis 2 for the
        hybrid conv [nb, n_mamba, B, K-1, di] and ssm [nb, n_mamba, B, di,
        N]; axis 0 for ``index`` [B].  (The reference splices every entry
        along axis 1, which puts a hybrid request's Mamba state in the
        wrong place; ROADMAP lists it.)
        """
        for k, pool in self.cache.items():
            pool.narrow(self.batch_axes[k], slot, 1).copy_(cache1[k])

    # ---- sampling --------------------------------------------------------------
    def _sample(self, logits: torch.Tensor, temperature: float) -> np.ndarray:
        if temperature <= 0.0:
            return logits.argmax(dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0] \
            .cpu().numpy()

    # ---- one engine tick -----------------------------------------------------
    def step(self) -> int:
        """Admit + one decode for all active slots.  Returns tokens emitted."""
        self._admit()
        if not any(s.active for s in self.slot_states):
            return 0
        toks = torch.from_numpy(self.last_tokens).to(self.device)
        logits, self.cache = decode_step(self.cfg, self.params, toks,
                                         self.cache)
        emitted = 0
        nxt = logits[:, 0, :].argmax(dim=-1).cpu().numpy()
        for i, st in enumerate(self.slot_states):
            if not st.active:
                continue
            req = self.requests[st.rid]
            tok = int(nxt[i])
            req.output.append(tok)
            self.last_tokens[i, 0] = tok
            st.remaining -= 1
            emitted += 1
            self.tokens_generated += 1
            if st.remaining <= 0:
                req.done = True
                st.active = False
                st.rid = -1
        return emitted

    def run_until_done(self, max_ticks: int = 1000) -> None:
        for _ in range(max_ticks):
            if not self.queue and not any(s.active for s in self.slot_states):
                return
            self.step()
