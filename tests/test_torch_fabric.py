"""repro_torch.core: the port's copy of the XUFS fabric against
``repro.core``.  Each file is the reference's with ``repro.core`` renamed,
and the same scenario through either package gives the same wire trace,
clock, RPC counts, cache fills and home contents."""
import dataclasses
import importlib
import json
import os
from pathlib import Path

import pytest

import repro.core
import repro_torch.core

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro" / "core"
PORT = ROOT / "src" / "repro_torch" / "core"
PACKAGES = ("repro", "repro_torch")
KB, MB = 1024, 1024 * 1024


@pytest.mark.parametrize("name", sorted(p.name for p in REF.glob("*.py")))
def test_copy_is_the_reference_renamed(name):
    ref = (REF / name).read_text()
    assert ref.replace("repro.core", "repro_torch.core") == \
        (PORT / name).read_text()


def test_module_sets_and_public_names_match():
    assert sorted(p.name for p in PORT.glob("*.py")) == \
        sorted(p.name for p in REF.glob("*.py"))
    assert repro_torch.core.__all__ == repro.core.__all__
    assert sorted(n for n in dir(repro_torch.core) if not n.startswith("_")) \
        == sorted(n for n in dir(repro.core) if not n.startswith("_"))


# ---- trace identity ---------------------------------------------------------

def _core(pkg):
    return importlib.import_module(f"{pkg}.core")


def _store_state(store):
    """Every object under the store's ``data/``: (bytes, version, vector
    timestamp).  ``meta/*.json`` also holds an ``mtime`` from the host's
    clock, so only its version is read."""
    out = {}
    data = os.path.join(store.root, "data")
    for dirpath, _, files in os.walk(data):
        for fn in files:
            path = os.path.relpath(os.path.join(dirpath, fn), data)
            with open(os.path.join(dirpath, fn), "rb") as f:
                blob = f.read()
            with open(os.path.join(store.root, "meta", path + ".json")) as f:
                version = json.load(f)["version"]
            out[path] = (blob, version, store.vts_of(path))
    return out


def _observe(s, clients=()):
    net = s.network
    out = {
        "trace": list(net.trace),
        "clock": net.clock,
        "rpcs": dict(net.per_endpoint_rpcs),
        "bytes": dict(net.per_endpoint_bytes),
        "fills": [dict(c.cache.fills_from) for c in (s.client, *clients)],
        "home": _store_state(s.server.store),
    }
    if s.replicas is not None:
        out["replicas"] = {name: _store_state(rep.store) for name, rep
                           in sorted(s.replicas.replicas.items())}
    return out


def _chaos(c, root, seed=3, lease=True):
    """``tests/test_chaos.py`` ``_run``: two writers, three replicas with a
    majority quorum and write leases, links cut by a seeded plan."""
    spec = c.FabricSpec.star(
        f"{root}/home", f"{root}/site",
        replica_latencies={"r1": 0.005, "r2": 0.015},
        link=c.LinkModel(latency_s=0.060),
        extra_sites=(c.SiteSpec("site2", root=f"{root}/site2"),))
    fab = c.Fabric(spec)
    s = fab.login("sci", replicas=c.ReplicaPolicy(
        sites=("r1", "r2"), write_quorum="majority",
        write_lease=c.WriteLeaseSpec(ttl_s=10.0) if lease else None))
    bob = fab.attach(s, "site2", owner="bob", mounts=[c.MountSpec("home/")])
    net = s.network
    t0 = net.clock
    fab.arm_faults(c.FaultPlan.chaos(
        (("site", "home"), ("site2", "home"), ("home", "r1"),
         ("home", "r2")), seed=seed, horizon_s=50.0, events=6, start_s=t0))
    writers = (s.client, bob)
    for rnd in range(4):
        for client, owner in zip(writers, ("sci", "bob")):
            with client.open("home/shared/chaos.bin", "w") as f:
                f.write(f"{owner}:{rnd}:".encode() * 997)
            client.pump()
        net.advance(12.5)
        for client in writers:
            client.pump()
            client.reconcile()
    net.advance(max(0.0, t0 + 50.0 - net.clock) + 15.0)
    for _ in range(3):
        for client in writers:
            client.pump()
            client.reconcile()
    s.replicas.resync()
    out = _observe(s, (bob,))
    out["conflicts"] = [(k.path, k.ours_data, k.theirs_data)
                        for cl in writers for k in cl.conflicts]
    return out


def _disconnected(c, root):
    """Cached read and queued writes while partitioned, then a heal and
    ``replay()``."""
    s = c.Fabric(c.FabricSpec.star(f"{root}/home", f"{root}/site")).login(
        "sci", mounts=[c.MountSpec("home/", ("home/scratch/raw/",))])
    s.server.store.put(s.token, "home/data/x", b"cached" * 100)
    with s.client.open("home/data/x") as f:
        f.read()
    s.network.partition("site", "home")
    with s.client.open("home/data/x") as f:
        assert f.read() == b"cached" * 100
    for i in range(3):
        with s.client.open(f"home/out/offline{i}", "w") as f:
            f.write(bytes([48 + i]) * (40 * KB * (i + 1)))
    with s.client.open("home/scratch/raw/local", "w") as f:
        f.write(b"never ships")
    assert s.client.pump() == 0
    s.network.heal("site", "home")
    s.client.replay()
    return _observe(s)


def _striped(c, root):
    """A large-file fetch striped under an adaptive ``BulkSpec``, read
    repair on a lagging replica, and a 2 MB write drained through the
    flusher."""
    s = c.Fabric(c.FabricSpec.star(
        f"{root}/home", f"{root}/site",
        replica_latencies={"r1": 0.005, "r2": 0.015},
        link=c.LinkModel(latency_s=0.060))).login(
            "sci", replicas=c.ReplicaPolicy(
                sites=("r1", "r2"),
                bulk=c.BulkSpec(max_streams=16, third_party=True)))
    net, path = s.network, "home/data/ckpt.bin"
    s.server.store.put(s.token, path, b"A" * (1 * MB))
    s.replicas.resync()
    s.server.store.put(s.token, path, b"B" * (3 * MB))
    net.partition("home", "r2")
    net.partition("r1", "r2")
    s.replicas.resync()
    net.heal("home", "r2")
    net.heal("r1", "r2")
    with s.client.open(path) as f:
        assert f.read() == b"B" * (3 * MB)
    for p in s.replicas.begin_repair_path(path):
        net.wait(p.ack)
        s.replicas.complete_apply(p)
    with s.client.open("home/data/out.bin", "w") as f:
        f.write(b"C" * (2 * MB))
    s.client.sync()
    net.drain()
    return _observe(s)


def _quiet(c):
    return c.MaintenanceSpec(resync_period_s=1e6, repair_period_s=1e6,
                             lease_period_s=1e6, reconcile_period_s=1e6,
                             lock_lease_s=120.0)


def _eviction(c, root):
    """``tests/test_eviction.py`` scheduled evict: LRU trim of a bounded
    replica to its low watermark."""
    ev = c.EvictionSpec(capacity=640 * KB, high_watermark=0.9,
                        low_watermark=0.5, scan_period_s=10.0)
    spec = dataclasses.replace(c.FabricSpec.star(
        f"{root}/home", f"{root}/site", replica_latencies={"r1": 0.005},
        link=c.LinkModel(latency_s=0.060)), maintenance=_quiet(c))
    s = c.Fabric(spec).login("sci", replicas=c.ReplicaPolicy(
        sites=("r1",), eviction=ev))
    for i in range(10):
        with s.client.open(f"home/d/f{i}.bin", "w") as f:
            f.write(bytes([65 + i]) * (64 * KB))
        s.client.pump()
    for i in (0, 1):
        s.client.cache.evict(f"home/d/f{i}.bin")
        with s.client.open(f"home/d/f{i}.bin") as f:
            f.read()
    s.scheduler.run_until(s.network.clock + ev.scan_period_s + 0.5)
    out = _observe(s)
    rep = s.replicas.replicas["r1"]
    out["resident"] = sorted(rep.resident)
    out["evictions"] = rep.evictions
    return out


def _dead_letter(c, root):
    """A lease task dead-lettered under a 40 s partition, then revived."""
    spec = dataclasses.replace(c.FabricSpec.star(
        f"{root}/home", f"{root}/site", link=c.LinkModel(latency_s=0.060)),
        maintenance=c.MaintenanceSpec())
    fab = c.Fabric(spec)
    s = fab.login("sci")
    assert s.client.lock("home/d/f")
    with s.client.open("home/d/f", "w") as f:
        f.write(b"L" * (100 * KB))
    net = s.network
    t0 = net.clock
    fab.arm_faults(c.FaultPlan(events=(
        c.PartitionEvent(at_s=t0, a="site", b="home", duration_s=40.0),)))
    s.scheduler.run_until(t0 + 40.0)
    r = s.maintenance_report()
    assert r.dead_lettered == 1
    letters = [(d.task, d.attempts, d.backoff_s, d.first_failed_at,
                d.dead_at) for d in r.dead_letters]
    s.scheduler.revive("lease:sci@site")
    s.scheduler.run_until(net.clock + 11.0)
    s.client.sync()
    out = _observe(s)
    out["dead_letters"] = letters
    out["report"] = (s.maintenance_report().tasks_run,
                     s.maintenance_report().retries)
    return out


@pytest.mark.parametrize("scenario", [_chaos, _disconnected, _striped,
                                      _eviction, _dead_letter],
                         ids=lambda f: f.__name__.strip("_"))
def test_same_scenario_same_trace(tmp_path, scenario):
    ref, port = (scenario(_core(pkg), str(tmp_path / pkg))
                 for pkg in PACKAGES)
    assert len(ref["trace"]) > 0
    assert ref.keys() == port.keys()
    for key in ref:
        assert port[key] == ref[key], key


def test_chaos_seeds_differ_but_packages_agree(tmp_path):
    """A second seed and no write leases: another trace, the same in both
    packages (the comparison is not vacuous)."""
    a = _chaos(_core("repro"), str(tmp_path / "a"), seed=3)
    b = _chaos(_core("repro"), str(tmp_path / "b"), seed=11, lease=False)
    assert a["trace"] != b["trace"]
    c = _chaos(_core("repro_torch"), str(tmp_path / "c"), seed=11,
               lease=False)
    assert c == b
