"""Pipelined small-file pre-fetch (paper §3.3).

On first ``chdir`` into a mounted directory, every file smaller than
64 KB is fetched over the simulated transport.  Each fill is a
single-stream channel reservation on the (client, source) pair; the
channel clock pipelines them — up to ``Network.channels_per_pair`` (12)
fills proceed concurrently and the 13th queues behind the earliest-free
channel — so the elapsed time is the max over channel queues, not the
serial sum.  That is what makes the paper's Fig. 4 source-build workload
fast on first touch.  Fills route to the fresh replica with the lowest
estimated completion when a replica fabric is mounted (so a saturating
source sheds later fills to the next-cheapest holder); sources on
different pairs overlap fully.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.core.cache import VALID, DIRTY
from repro_torch.core.store import ObjectStat
from repro_torch.core.transport import (
    DisconnectedError, Transfer, TransferRequest,
)

SMALL_FILE = 64 * 1024


@dataclass
class Prefetcher:
    client: "XufsClient"          # noqa: F821 (circular-light)
    small_file: int = SMALL_FILE

    def prefetch_small(self, prefix: str, stats: List[ObjectStat]) -> int:
        cl = self.client
        todo = []
        for st in stats:
            if st.is_dir or st.size >= self.small_file:
                continue
            entry = cl.cache.lookup(st.path)
            if entry is not None and entry.state in (VALID, DIRTY) \
                    and entry.stat.version >= st.version:
                continue
            todo.append(st)
        if not todo:
            return 0

        m = cl._mount_for(todo[0].path)
        # queue-aware replica routing prices each fill against the live
        # channel state INCLUDING the fills already issued (that is the
        # load-shedding feedback loop) — those must keep reserving
        # inline.  Static routing reads no queue state, so the whole
        # wave can be reserved as one same-epoch batch at the end —
        # bit-identical reservations, one event-queue entry.
        batched = m.replicas is None or not m.replicas.queue_aware
        fetched = 0
        transfers: List[Transfer] = []
        reqs: List[TransferRequest] = []
        for st in todo:
            # cheapest fresh source first (the route is priced with the
            # file's actual size, so queue depth and NIC backlog from
            # the fills already issued steer later fills away from a
            # saturating source); home is the terminal source
            data = fresh = src = None
            for server_name, store, token in cl._read_sources(
                    m, st.path, nbytes=st.size):
                if cl.network.is_partitioned(cl.name, server_name):
                    continue
                try:
                    data, fresh = store.get(token, st.path)
                except FileNotFoundError:
                    continue
                src = server_name
                break
            if data is None:
                continue
            # one stream per fill, pipelined over the pair's channel pool
            if batched:
                reqs.append(
                    TransferRequest(src, cl.name, "prefetch", len(data)))
            else:
                transfers.append(
                    cl.network.transfer(src, cl.name, "prefetch",
                                        len(data)))
            cl.cache.store_data(st.path, data, fresh, state=VALID)
            cl.cache.misses += 1
            cl.cache.record_fill(src)
            if m.replicas is not None:
                # a prefetch hit is a read for LRU purposes (wire-free)
                m.replicas.note_read(src, st.path)
            fetched += 1
        # block until the last fill lands: overlapped elapsed, not the sum
        if reqs:
            cl.network.wait_batch(cl.network.transfer_batch(reqs))
        cl.network.wait_all(transfers)
        return fetched
