"""Bulk-transfer plane: adaptive parallel streams over the event engine.

XUFS's headline claim is wide-area throughput competitive with
high-performance file systems, but a fixed ≤12-stream pool leaves a
high bandwidth-delay-product link mostly idle: 12 window-limited TCP
streams of ``per_stream_bw`` each cap the pair at
``12 x per_stream_bw`` no matter how fat the link is.  Following the
GridFTP line (Allcock et al.) and xDFS (Poshtkohi et al.), this module
makes the stream count a *per-transfer decision*:

  * :func:`grant_streams` — the static budget.  The number of
    window-limited streams needed to fill the path is the
    bandwidth-delay product over the per-stream window,

        n* = ceil(BDP / per-stream window)
           = ceil((latency x path_bw) / (latency x per_stream_bw))
           = ceil(path_bw / per_stream_bw)

    where ``path_bw`` is the link bandwidth clamped by any NIC budget
    at either endpoint (streams beyond a NIC cap buy nothing).  The
    grant is further clamped to the payload (one stream per
    ``MIN_STREAM_BYTES``) and to the spec's ``[min_streams,
    max_streams]`` window.  With ``adapt=False`` the derivation is
    skipped entirely and the grant is the fixed ``max_streams``
    (payload-clamped) — a *fixed-width plan*, the mode whose traces are
    provably bit-identical to the legacy 12-stream constant when
    ``max_streams == 12`` (``tests/test_bulk.py``).
  * :class:`BulkTransfer` — the AIMD executor.  A payload moves in
    *waves* of ``width x probe_bytes`` striped through ONE
    :meth:`~repro_torch.core.transport.Network.transfer_batch` reservation
    batch; after each wave the achieved throughput (wave bytes over
    wave elapsed on the virtual clock) feeds the congestion-control
    rule: **additive increase** (``+grow_step``) while a wave improves
    on the best observed throughput by more than
    ``improve_threshold``, **multiplicative decrease** (``x backoff``)
    when a wave degrades against the previous one by more than
    ``degrade_threshold`` — NIC backlog from competing traffic is
    exactly what stretches a wave's completion, so the width follows
    the congestion state the static grant cannot see.  The first wave
    starts at the granted n*, not at 1: the static budget seeds the
    search, adaptation only corrects it.
  * :func:`ensure_channel_width` — a granted width beyond
    ``Network.channels_per_pair`` raises the pool (the engine pads
    idle channel columns; ``transport.py`` supports raising the width
    mid-run, never lowering it).

Gating: everything here is opt-in.  A :class:`BulkSpec` reaches the
fabric via ``ReplicaPolicy(bulk=...)`` / ``FabricSpec(bulk=...)``
(``docs/fabric.md``); with the spec unset, striping keeps the fixed
12-stream constant, repair sources stay as they were, and every trace
is bit-identical to the pre-bulk engine (``benchmarks/fig_bulk.py``
gates this).  ``third_party`` additionally lets the replica fabric
move maintenance bytes directly between storage endpoints
(replica→replica) instead of through the client's NIC — the selection
itself lives in ``repro_torch.core.replication`` (``docs/maintenance.md``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from repro_torch.core.transport import KB, MB, Network

#: One stream per this many payload bytes at most — matches striping's
#: ``MIN_BLOCK`` so a granted plan never stripes below the legacy block.
MIN_STREAM_BYTES = 64 * KB


@dataclass(frozen=True)
class BulkSpec:
    """Declarative bulk-transfer policy (frozen, validates on build).

    ``min_streams``/``max_streams`` bound every granted width.
    ``probe_bytes`` is the per-stream wave size the AIMD loop probes
    with (a wave moves ``width x probe_bytes``); waves shorter than the
    path's BDP amortize latency poorly, so size it at least
    ``latency x per_stream_bw``.  ``adapt=False`` freezes the width at
    ``max_streams`` (payload-clamped) and moves the payload in one
    wave — the fixed-width mode whose plans are bit-identical to the
    legacy constant when ``max_streams == 12``.  ``third_party``
    gates replica→replica maintenance movement
    (:meth:`repro_torch.core.replication.ReplicaSet.third_party_source`).
    """

    min_streams: int = 1
    max_streams: int = 64
    probe_bytes: int = 16 * MB
    adapt: bool = True
    third_party: bool = True
    grow_step: int = 4
    backoff: float = 0.5
    improve_threshold: float = 0.05
    degrade_threshold: float = 0.15

    def __post_init__(self) -> None:
        if self.min_streams < 1:
            raise ValueError(
                f"min_streams must be >= 1: {self.min_streams}")
        if self.max_streams < self.min_streams:
            raise ValueError(
                f"max_streams ({self.max_streams}) < min_streams "
                f"({self.min_streams})")
        if self.probe_bytes <= 0:
            raise ValueError(
                f"probe_bytes must be > 0: {self.probe_bytes}")
        if self.grow_step < 1:
            raise ValueError(f"grow_step must be >= 1: {self.grow_step}")
        if not (0.0 < self.backoff < 1.0):
            raise ValueError(
                f"backoff must be in (0, 1): {self.backoff}")
        if self.improve_threshold < 0 or self.degrade_threshold < 0:
            raise ValueError(
                "improve/degrade thresholds must be >= 0: "
                f"{self.improve_threshold}, {self.degrade_threshold}")


def grant_streams(network: Network, src: str, dst: str, nbytes: int,
                  spec: BulkSpec) -> int:
    """Stream budget for one ``src -> dst`` transfer of ``nbytes``.

    ``adapt=True``: the BDP-derived fill count ``ceil(path_bw /
    per_stream_bw)`` with ``path_bw`` NIC-clamped, bounded by the
    payload and the spec window.  ``adapt=False``: the fixed
    ``max_streams`` (payload-clamped) — no derivation, so the grant
    cannot depend on budgets or link shape (the fixed-width identity
    mode).
    """
    chunks = max(1, nbytes // MIN_STREAM_BYTES) if nbytes > 0 else 1
    if not spec.adapt:
        width = min(spec.max_streams, chunks)
    else:
        link = network.link_between(src, dst)
        path_bw = link.link_bw
        for ep in (src, dst):
            b = network.nic_budget(ep)
            if b is not None and b < path_bw:
                path_bw = b
        fill = max(1, -(-int(path_bw) // max(int(link.per_stream_bw), 1)))
        width = min(spec.max_streams, fill, chunks)
    return max(spec.min_streams, width)


def ensure_channel_width(network: Network, width: int) -> None:
    """Raise the per-pair channel pool to carry ``width`` concurrent
    streams.  Raising pads idle columns (indistinguishable from
    never-used channels — the regression test in ``tests/test_bulk.py``
    holds this); lowering mid-run is unsupported and never attempted."""
    if width > int(network.channels_per_pair):
        network.channels_per_pair = int(width)


@dataclass(frozen=True)
class BulkResult:
    """Outcome of one bulk push: the figure-of-merit record the
    benchmark reports (virtual-clock elapsed, per-wave width history,
    achieved throughput)."""

    src: str
    dst: str
    nbytes: int
    elapsed_s: float
    waves: int
    widths: Tuple[int, ...]
    throughput_bps: float


class BulkTransfer:
    """AIMD bulk mover: waves of parallel streams sized by observables.

    Each wave is one ``transfer_batch`` reservation batch of ``width``
    same-pair stripes (``concurrency=width``, so each stream holds a
    window-limited ``link_bw / width`` share at most), waited to
    completion before the next wave is sized — the wait IS the
    throughput probe.  ``push`` works on sizes (checkpoint-scale
    transfers should not materialize gigabytes); ``send`` wraps real
    payload bytes.
    """

    def __init__(self, network: Network,
                 spec: Optional[BulkSpec] = None):
        self.network = network
        self.spec = spec if spec is not None else BulkSpec()

    def grant(self, src: str, dst: str, nbytes: int) -> int:
        return grant_streams(self.network, src, dst, nbytes, self.spec)

    def push(self, src: str, dst: str, nbytes: int, *,
             method: str = "bulk",
             wave_cb: Optional[Callable[[int, int, int, float], None]]
             = None) -> BulkResult:
        """Move ``nbytes`` from ``src`` to ``dst``; the clock advances
        to the last wave's completion.  ``wave_cb(wave_index, width,
        wave_bytes, wave_elapsed_s)`` observes each wave (progress
        reporting; tests use it to inject competing traffic between
        waves)."""
        net = self.network
        spec = self.spec
        t0 = net.clock
        if nbytes <= 0:
            return BulkResult(src=src, dst=dst, nbytes=0, elapsed_s=0.0,
                              waves=0, widths=(), throughput_bps=0.0)
        width = self.grant(src, dst, nbytes)
        ensure_channel_width(net, min(spec.max_streams, width))
        widths = []
        sent = 0
        best_tput = 0.0
        prev_tput: Optional[float] = None
        while sent < nbytes:
            remaining = nbytes - sent
            w = max(1, min(width, max(1, remaining // MIN_STREAM_BYTES)))
            ensure_channel_width(net, w)
            chunk = min(remaining, w * spec.probe_bytes) if spec.adapt \
                else remaining
            base = chunk // w
            lens = [base] * (w - 1) + [chunk - base * (w - 1)]
            wave_t0 = net.clock
            batch = net.transfer_batch(
                [(src, dst, method, ln, w, False, 0.0) for ln in lens])
            net.wait_batch(batch)
            dt = net.clock - wave_t0
            tput = chunk / dt if dt > 0 else float("inf")
            widths.append(w)
            sent += chunk
            if wave_cb is not None:
                wave_cb(len(widths) - 1, w, chunk, dt)
            if spec.adapt and sent < nbytes:
                if prev_tput is not None and \
                        tput < prev_tput * (1.0 - spec.degrade_threshold):
                    # congestion: a wave lost ground against the last
                    # one (NIC backlog stretched its completion) —
                    # multiplicative decrease
                    width = max(spec.min_streams,
                                int(width * spec.backoff))
                elif tput > best_tput * (1.0 + spec.improve_threshold):
                    # still improving on the best observed: additive
                    # increase, up to the spec ceiling
                    width = min(spec.max_streams, width + spec.grow_step)
                if tput > best_tput:
                    best_tput = tput
                prev_tput = tput
        elapsed = net.clock - t0
        return BulkResult(
            src=src, dst=dst, nbytes=nbytes, elapsed_s=elapsed,
            waves=len(widths), widths=tuple(widths),
            throughput_bps=nbytes / elapsed if elapsed > 0 else 0.0)

    def send(self, src: str, dst: str, payload: bytes, *,
             method: str = "bulk") -> BulkResult:
        """Blocking transfer of real payload bytes (``push`` on the
        payload's size — the wire model only prices sizes)."""
        return self.push(src, dst, len(payload), method=method)
