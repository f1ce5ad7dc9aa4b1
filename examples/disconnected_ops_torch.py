"""Paper-native scenario (§2.1 workflow + disconnected operation):

1. a scientist's laptop (home) holds source + input data;
2. the pod site mounts the namespace, prefetches the source tree, caches
   the big input, and starts producing results with write-behind;
3. the laptop drops off the network MID-RUN — the job keeps going from
   cache, queueing its outputs in the WAL;
4. the laptop returns; the queue drains; a callback invalidation proves
   coherency after a home-side edit;
5. raw output in a *localized directory* never crosses the WAN.

The port's counterpart of ``examples/disconnected_ops.py``, on the port's
copy of the fabric (``repro_torch.core``): the same scenario and prints.

    PYTHONPATH=src python examples/disconnected_ops_torch.py
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import (
    DisconnectedError, Fabric, FabricSpec, MountSpec, SiteSpec,
)


def main() -> None:
    with tempfile.TemporaryDirectory() as td:
        fabric = Fabric(FabricSpec(sites=(
            SiteSpec("laptop", root=td + "/laptop"),
            SiteSpec("pod", root=td + "/pod"),
        )))
        net = fabric.network
        s = fabric.login("ewalker", home="laptop", site="pod",
                         mounts=[MountSpec("home/",
                                           ("home/scratch/raw/",))])
        tok = s.token

        # laptop: project files
        for i in range(20):
            s.server.store.put(tok, f"home/src/mod{i}.c",
                               b"code\n" * 500)
        s.server.store.put(tok, "home/input/data.bin", b"\x01" * 50_000_000)

        # pod: cd (parallel prefetch) + cache the big input
        n = s.client.chdir("home/src")
        print(f"prefetched {n} small sources; WAN clock {net.clock:.2f}s")
        with s.client.open("home/input/data.bin") as f:
            data = f.read()
        print(f"cached {len(data):,}B input; WAN clock {net.clock:.2f}s")

        # laptop leaves the network (the paper's core assumption!)
        net.partition("pod", "laptop")
        print("-- laptop disconnected --")
        with s.client.open("home/input/data.bin") as f:
            assert f.read() == data          # still served, from cache
        for step in range(3):
            with s.client.open(f"home/results/step{step}.out", "w") as f:
                f.write(b"result" * 1000)
            with s.client.open("home/scratch/raw/dump.bin", "w") as f:
                f.write(b"\x00" * 10_000_000)    # localized: stays on pod
        queued = len(s.client.oplog.pending())
        print(f"queued {queued} ops while offline "
              f"(raw dump localized, not queued)")

        # laptop comes back; the WAL drains in order
        net.heal("pod", "laptop")
        drained = s.client.sync()
        print(f"-- reconnected: drained {drained} ops --")
        got, _ = s.server.store.get(tok, "home/results/step2.out")
        assert got == b"result" * 1000
        try:
            s.server.store.get(tok, "home/scratch/raw/dump.bin")
            raise AssertionError("localized file leaked to home!")
        except FileNotFoundError:
            print("localized raw output never left the pod  ✓")

        # coherency: home-side edit invalidates the pod's cache
        stale = s.client.reconnect()
        s.server.store.put(tok, "home/src/mod0.c", b"edited\n")
        s.client.pump_callbacks()
        with s.client.open("home/src/mod0.c") as f:
            assert f.read() == b"edited\n"
        print("callback invalidation + refetch  ✓")
        print(f"final WAN clock {net.clock:.2f}s, "
              f"bytes shipped {net.bytes_sent:,}")


if __name__ == "__main__":
    main()
