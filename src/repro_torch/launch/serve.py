"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Counterpart of ``repro/launch/serve.py``.  As the reference does, it
publishes the seeded weights into the home store of a two-site XUFS
fabric under ``--workdir`` (by default a temp dir, removed once the
weights are restored), restores them at the serving site through the
fabric (striped fetch + small-tensor prefetch) onto the device, prints
the restore's modeled WAN seconds, and serves from the restored weights.
The checkpoint is the reference's, leaf for leaf
(``repro_torch.checkpoint``, through ``bridge.state_to_reference``), so
for the same arch the WAN clock reads the same.  The launcher selects
the CUDA kernels
(``attention_impl="pallas"``: dense prefill runs the flash-attention
kernel; ``scan_impl="pallas"``: the MoE expert products run the
grouped-matmul kernel, and the RWKV6 and Mamba full-sequence forwards
their scan kernels, though prefill keeps the paths that return the
state, as in the reference), serves synthetic requests under continuous
batching and prints tokens/s with the device.

``--arch qwen3-moe-30b-a3b`` serves the MoE family at full width on one
80 GB card (61.1 GB of bf16 weights).  ``--arch jamba-1.5-large-398b``
(with its experts) and ``--arch dbrx-132b`` run only with ``--tiny``, on
the card or with ``--device cpu``: at full width one jamba superblock
with its four MoE layers is 90.5 GB and dbrx 263 GB, more than one card
holds, and they wait for the multi-device slice (ROADMAP port slice
(g)).  The enc-dec and VLM archs are refused before any weights are
made (``serve.engine.check_servable``): the reference's engine cannot
serve them.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, Tuple

import torch

from repro_torch.bridge import state_from_reference, state_to_reference
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config.base import ModelConfig
from repro_torch.configs import ARCH_IDS, get_config, get_tiny_config
from repro_torch.core import Fabric, FabricSpec, SiteSpec
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serve.engine import Request, ServeEngine, check_servable


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def restore_over_fabric(cfg: ModelConfig, params: Any, workdir: str,
                        ) -> Tuple[Any, Dict[str, float]]:
    """Publish ``params`` into the home store of a two-site fabric under
    ``workdir`` and restore them at the serving site onto their device.

    Returns (the restored params, numbers): ``bytes`` of the leaves,
    host seconds of ``save``, ``sync`` and ``restore``, and the modeled
    WAN seconds of the save (write-behind, so spent in ``sync``) and of
    the restore.
    """
    fabric = Fabric(FabricSpec(sites=(
        SiteSpec("home", root=os.path.join(workdir, "home")),
        SiteSpec("site", root=os.path.join(workdir, "site")),
    )))
    net = fabric.network
    s = fabric.login("server")
    tree = state_to_reference(cfg, {"params": params})
    dev = tree_leaves(params)[0].device
    mgr = CheckpointManager(s.client, f"home/models/{cfg.name}")
    _sync(dev)
    clock0, t0 = net.clock, time.perf_counter()
    mgr.save(0, tree)
    t1 = time.perf_counter()
    s.client.sync()
    t2, clock1 = time.perf_counter(), net.clock
    restored, _ = mgr.restore(tree)
    _sync(dev)
    t3 = time.perf_counter()
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(tree["params"]))
    return state_from_reference(cfg, restored)["params"], dict(
        bytes=nbytes, save_s=t1 - t0, sync_s=t2 - t1, restore_s=t3 - t2,
        save_wan_s=clock1 - clock0, restore_wan_s=net.clock - clock1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-8b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default="")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = (get_tiny_config(args.arch) if args.tiny
           else get_config(args.arch)).replace(param_dtype="bfloat16",
                                               attention_impl="pallas",
                                               scan_impl="pallas")
    check_servable(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    with tempfile.TemporaryDirectory(prefix="xufs_serve_") as tmp:
        params, info = restore_over_fabric(cfg, params, args.workdir or tmp)
    print(f"weights restored through XUFS in {info['restore_wan_s']:.2f}s "
          "WAN")

    engine = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                         seed=args.seed, device=dev)
    for i in range(args.requests):
        engine.add_request(Request(
            rid=i, prompt=[1 + (i * 7 + j) % (cfg.vocab_size - 2)
                           for j in range(3 + i % 5)],
            max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    ticks = 0
    while engine.queue or any(st.active for st in engine.slot_states):
        engine.step()
        ticks += 1
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"{cfg.name}: {args.requests} requests, {engine.tokens_generated} "
          f"tokens, {ticks} ticks, {engine.tokens_generated / dt:.1f} tok/s "
          f"on {device_name(dev)}")


if __name__ == "__main__":
    main()
