"""Striped transfers (paper §3.3): >64 KB moves across up to 12 streams.

``StripePlan`` is pure logic (tested exhaustively with hypothesis);
``StripedTransfer`` executes a plan over the simulated transport: each
stripe is its own concurrent channel reservation, so the elapsed time is
the max over the stripe channels (not the sum).  ``begin()`` issues the
reservations without advancing the clock — the async primitive replica
fan-out pipelines on — while ``send()`` is the blocking wrapper.

Every stripe reservation individually charges the per-endpoint NIC
budget at both ends (``Network._charge_nic``), so striping a payload
12-wide cannot exceed the shared uplink: the stripes serialize through
the NIC at the budget rate and the group completion stretches to the
NIC backlog exactly as one aggregate transfer would.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.bulk import BulkSpec, ensure_channel_width, grant_streams
from repro_torch.core.transport import (
    Endpoint, KB, Network, Transfer, TransferBatch, TransferRequest,
)

STRIPE_THRESHOLD = 64 * KB   # transfers above this are striped
MIN_BLOCK = 64 * KB          # minimum stripe block size
MAX_STRIPES = 12             # parallel TCP connections


@dataclass(frozen=True)
class StripePlan:
    total: int
    stripes: Tuple[Tuple[int, int], ...]   # (offset, length) per stripe

    @property
    def n_streams(self) -> int:
        return len(self.stripes)


def plan_stripes(nbytes: int, max_stripes: int = MAX_STRIPES,
                 min_block: int = MIN_BLOCK,
                 threshold: int = STRIPE_THRESHOLD) -> StripePlan:
    """Split ``nbytes`` into <= max_stripes contiguous ranges of >= min_block
    (the last stripe takes the remainder).  Below threshold: single stream.
    """
    if nbytes <= threshold:
        return StripePlan(nbytes, ((0, nbytes),) if nbytes else ())
    n = min(max_stripes, max(nbytes // min_block, 1))
    base = nbytes // n
    stripes: List[Tuple[int, int]] = []
    off = 0
    for i in range(n):
        ln = base if i < n - 1 else nbytes - off
        stripes.append((off, ln))
        off += ln
    return StripePlan(nbytes, tuple(stripes))


def reassemble(plan: StripePlan, parts: List[bytes]) -> bytes:
    """Stitch stripe payloads back together (order-independent by offset)."""
    assert len(parts) == plan.n_streams
    buf = bytearray(plan.total)
    for (off, ln), part in zip(plan.stripes, parts):
        assert len(part) == ln, (len(part), ln)
        buf[off:off + ln] = part
    return bytes(buf)


class TransferGroup:
    """The in-flight stripes of one logical payload, backed by ONE
    reservation batch (``Network.transfer_batch``)."""

    __slots__ = ("plan", "batch")

    def __init__(self, plan: StripePlan, batch: TransferBatch):
        self.plan = plan
        self.batch = batch

    @property
    def transfers(self) -> List[Transfer]:
        """Per-stripe records (materialized lazily from the batch)."""
        return self.batch.transfers

    @property
    def completion(self) -> float:
        """When the whole payload has landed: max over stripe channels."""
        return self.batch.completion


@dataclass
class StripedTransfer:
    """Moves payloads between endpoints with striping + clock accounting."""

    network: Network
    max_stripes: int = MAX_STRIPES
    # optional bulk policy (repro_torch.core.bulk): when set, the plan width
    # follows the granted stream budget — BDP/NIC/payload-derived — and
    # the channel pool is raised to carry it.  None (default) keeps the
    # fixed MAX_STRIPES constant, plans and traces bit-identical; a
    # fixed-width spec (adapt=False, max_streams=12) is likewise
    # provably identical because the payload clamp mirrors
    # ``plan_stripes``' own ``nbytes // min_block`` bound.
    spec: Optional[BulkSpec] = None

    def begin(self, src: str, dst: str, payload: bytes, *,
              encrypted: bool = False, max_stripes: Optional[int] = None,
              not_before: float = 0.0) -> TransferGroup:
        """Reserve one channel per stripe; the clock does not move.

        Each stripe is a single stream holding a ``link_bw / n`` share at
        most, so for equal stripes the group completion matches the old
        aggregate n-stream model — but the stripes now occupy channels,
        letting unrelated transfers overlap with them.
        """
        if max_stripes is None and self.spec is not None:
            width = grant_streams(self.network, src, dst, len(payload),
                                  self.spec)
            ensure_channel_width(self.network, width)
        else:
            width = max_stripes or self.max_stripes
        plan = plan_stripes(len(payload), max_stripes=width)
        n = max(plan.n_streams, 1)
        reqs = [
            TransferRequest(src, dst, "stripe", ln, n, encrypted, not_before)
            for _off, ln in plan.stripes
        ] or [TransferRequest(src, dst, "stripe", 0, 1, encrypted,
                              not_before)]
        batch = self.network.transfer_batch(reqs)
        # exercise the real data path: split + reassemble must round-trip
        parts = [payload[off:off + ln] for off, ln in plan.stripes]
        assert reassemble(plan, parts) == payload
        return TransferGroup(plan, batch)

    def send(self, src: str, dst: str, payload: bytes, *,
             encrypted: bool = False,
             max_stripes: Optional[int] = None) -> float:
        """Blocking transfer; returns the modeled (parallel) elapsed
        seconds the caller observed."""
        t0 = self.network.clock
        group = self.begin(src, dst, payload, encrypted=encrypted,
                           max_stripes=max_stripes)
        self.network.wait_batch(group.batch)
        return self.network.clock - t0
