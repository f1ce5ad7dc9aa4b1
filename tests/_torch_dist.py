"""Helpers for the port's multi-process tests: ranks of a ``gloo`` job on
the CPU, and the reference run in a subprocess with host devices.

Neither can hang the suite: every rank's process group has a timeout of
``PG_TIMEOUT`` seconds, ``run_ranks`` kills ranks still running at its
limit, and ``run_reference`` gives its subprocess a limit.  Ranks meet
through a ``FileStore`` in the test's own temp dir, so tests running side
by side share no port.  A rank function is a module-level function
``fn(rank, world, *args)``; its arguments go to the ranks, and what it
returns comes back, through ``torch.save`` files (arguments pickled into
the spawn pipe would hold each start until the previous rank has read
them).
"""
import datetime
import os
import subprocess
import sys
import textwrap
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PG_TIMEOUT = 60       # seconds a collective may wait for a peer
RANKS_LIMIT = 100     # seconds a whole multi-process run may take
REFERENCE_LIMIT = 110  # seconds the reference's subprocess may take


def port_leaves(stacks, sublayers, tree, name):
    """The leaves of a port tree (``param_axes``' layout: stacks as lists
    of per-layer dicts) at the reference's leaf path ``name``, and how many
    stacked axes the reference puts before them.  ``stacks`` and
    ``sublayers`` are ``bridge._stacks(cfg)`` and ``bridge._sublayers(cfg)``.
    """
    head, _, rest = name.partition("/")
    if head not in stacks:
        return [_get(tree, name)], 0
    sub, _, leaf = rest.partition("/")
    if sub in sublayers:
        return [lp[leaf] for block in tree[head] for lp in block[sub]], 2
    return [_get(block, rest) for block in tree[head]], 1


def _get(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _rank_main(fn, rank, world, out_dir):
    try:
        torch.set_num_threads(1)
        args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
        store = os.path.join(out_dir, "store")
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn, world, tmp_path, *args, limit=RANKS_LIMIT):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes of one
    ``gloo`` group; returns their results in rank order, or raises with the
    failed ranks' tracebacks, or after ``limit`` seconds."""
    out_dir = tmp_path / f"ranks-{fn.__name__}"
    out_dir.mkdir()
    torch.save(args, out_dir / "args.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(5)
    errors = {r: (out_dir / f"rank{r}.err").read_text()
              for r in range(world) if (out_dir / f"rank{r}.err").exists()}
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"ranks hung past {limit} s: {hung}; exit codes "
            f"{[p.exitcode for p in procs]}\n" + "\n".join(
                f"--- rank {r} ---\n{e}" for r, e in errors.items()))
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def run_reference(body, n_dev, limit=REFERENCE_LIMIT):
    """Run ``body`` (Python) in a subprocess whose JAX has ``n_dev`` host
    CPU devices; returns its stdout."""
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = (
            "--xla_force_host_platform_device_count={n_dev}")
        os.environ["JAX_PLATFORMS"] = "cpu"
        import sys
        sys.path.insert(0, {SRC!r})
    """) + textwrap.dedent(body)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=limit)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    return r.stdout
