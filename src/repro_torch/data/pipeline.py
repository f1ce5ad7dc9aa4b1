"""Data pipeline: deterministic synthetic token shards served through XUFS
(``repro/data/pipeline.py``).

Shards live as objects in the home store (the "input data" of the paper's
workflow §2.1, step 3); the pipeline reads them through the XufsClient so
they are whole-object cached, prefetched in parallel, and survive home
disconnects once cached — the trainer never stalls on the WAN.

Determinism: shard contents are a pure function of (seed, shard_index), so
an elastic re-shard or a restart resumes exactly.  The shards are numpy's
draws, as the reference's, so the shard files in the home store and the
batches equal the reference's bit for bit; ``next_batch`` returns int32
torch tensors on the pipeline's device.  Enc-dec and VLM batches add a
``frontend`` input, numpy's standard normal draws seeded by the cursor
(cast to the config's dtype on the device), and a VLM's positions are
[3, B, S].
"""
from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.core.namespace import XufsClient
from repro_torch.data.batches import Batch, batch_shapes
from repro_torch.device import DeviceLike, resolve_device


def synth_tokens(seed: int, shard: int, n: int, vocab: int) -> np.ndarray:
    """Deterministic Zipf-distributed token stream.

    The skewed unigram distribution gives the stream learnable statistics
    (entropy well below ``ln(vocab)``), so a working trainer measurably
    reduces loss on it — uniform tokens would leave nothing to learn and
    make loss-decrease checks a coin flip.
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, shard]))
    probs = 1.0 / np.arange(1, vocab + 1, dtype=np.float64)
    probs /= probs.sum()
    return rng.choice(vocab, size=n, p=probs).astype(np.int32)


@dataclass
class ShardSpec:
    index: int
    path: str
    tokens: int


class SyntheticCorpus:
    """Writes deterministic token shards into a home store via a client."""

    def __init__(self, client: XufsClient, prefix: str, *, seed: int,
                 vocab: int, shard_tokens: int = 262_144):
        self.client = client
        self.prefix = prefix.rstrip("/")
        self.seed = seed
        self.vocab = vocab
        self.shard_tokens = shard_tokens

    def shard_path(self, i: int) -> str:
        return f"{self.prefix}/shard_{i:06d}.npy"

    def materialize(self, n_shards: int) -> List[ShardSpec]:
        specs = []
        for i in range(n_shards):
            toks = synth_tokens(self.seed, i, self.shard_tokens, self.vocab)
            buf = io.BytesIO()
            np.save(buf, toks, allow_pickle=False)
            with self.client.open(self.shard_path(i), "w") as f:
                f.write(buf.getvalue())
            specs.append(ShardSpec(i, self.shard_path(i), self.shard_tokens))
        self.client.sync()
        return specs


class DataPipeline:
    """Iterates model batches from XUFS-cached shards with read-ahead."""

    def __init__(self, client: XufsClient, prefix: str, cfg: ModelConfig, *,
                 batch: int, seq: int, seed: int = 0, n_shards: int = 4,
                 read_ahead: int = 1, device: DeviceLike = "cuda"):
        self.client = client
        self.prefix = prefix.rstrip("/")
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.n_shards = n_shards
        self.read_ahead = read_ahead
        self.device = resolve_device(device)
        self._shard_cache: Dict[int, np.ndarray] = {}
        self._cursor = 0          # global token cursor
        self.stalls = 0

    # ---- shard access ------------------------------------------------------
    def _load_shard(self, i: int) -> np.ndarray:
        i = i % self.n_shards
        if i not in self._shard_cache:
            path = f"{self.prefix}/shard_{i:06d}.npy"
            with self.client.open(path) as f:
                self._shard_cache[i] = np.load(io.BytesIO(f.read()),
                                               allow_pickle=False)
            # bounded cache: drop shards far behind the cursor
            if len(self._shard_cache) > self.read_ahead + 2:
                oldest = min(self._shard_cache)
                if oldest != i:
                    del self._shard_cache[oldest]
        return self._shard_cache[i]

    def _take(self, n: int) -> np.ndarray:
        out = np.empty(n, np.int32)
        got = 0
        while got < n:
            shard0 = self._load_shard(0)
            st = len(shard0)
            idx = self._cursor + got
            si, off = divmod(idx, st)
            shard = self._load_shard(si)
            take = min(n - got, st - off)
            out[got:got + take] = shard[off:off + take]
            got += take
        self._cursor += n
        # read-ahead: warm the next shard through the cache
        st = len(self._load_shard(0))
        nxt = (self._cursor // st) + 1
        self._load_shard(nxt)
        return out

    # ---- batches --------------------------------------------------------------
    def next_batch(self) -> Batch:
        shapes = batch_shapes(self.cfg, self.batch, self.seq)
        toks_shape = shapes["tokens"][0]
        n = int(np.prod(toks_shape)) + 1
        flat = self._take(n)
        tokens = flat[:-1].reshape(toks_shape)
        targets = flat[1:].reshape(shapes["targets"][0])
        pshape, pdtype = shapes["positions"]
        out = {
            "tokens": torch.tensor(tokens, device=self.device),
            "targets": torch.tensor(targets, device=self.device),
            "positions": torch.arange(pshape[-1], dtype=pdtype,
                                      device=self.device
                                      ).expand(pshape).contiguous(),
        }
        if "frontend" in shapes:
            fshape, fdtype = shapes["frontend"]
            rng = np.random.default_rng(self._cursor)
            out["frontend"] = torch.from_numpy(
                rng.standard_normal(fshape, dtype=np.float32)
            ).to(self.device).to(fdtype)
        return out

    def __iter__(self) -> Iterator[Batch]:
        while True:
            yield self.next_batch()

    # ---- resumability ----------------------------------------------------------
    def state(self) -> Dict:
        return {"cursor": self._cursor}

    def restore(self, state: Dict) -> None:
        self._cursor = int(state["cursor"])
