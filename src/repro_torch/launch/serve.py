"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Counterpart of ``repro/launch/serve.py``.  The reference publishes its
weights through the XUFS fabric and restores them before it serves; the
port has no fabric yet (ROADMAP port slice (a)), so the weights come from
the port's seeded init.  The launcher selects the CUDA kernels
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
(g)).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_tiny_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve.engine import Request, ServeEngine


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


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
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = (get_tiny_config(args.arch) if args.tiny
           else get_config(args.arch)).replace(param_dtype="bfloat16",
                                               attention_impl="pallas",
                                               scan_impl="pallas")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, dev)

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
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"{cfg.name}: {args.requests} requests, {engine.tokens_generated} "
          f"tokens, {ticks} ticks, {engine.tokens_generated / dt:.1f} tok/s "
          f"on {device_name(dev)}")


if __name__ == "__main__":
    main()
