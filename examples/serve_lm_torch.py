"""Batched serving example on the PyTorch port: weights arrive through the
XUFS fabric (striped restore + small-tensor prefetch), then a
continuous-batching engine serves a stream of requests.  The port's
counterpart of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.bridge import state_from_reference, state_to_reference
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_tiny_config
from repro_torch.core import Fabric, FabricSpec, SiteSpec
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args().device)
    with tempfile.TemporaryDirectory() as td:
        fabric = Fabric(FabricSpec(sites=(
            SiteSpec("home", root=td + "/home"),
            SiteSpec("site", root=td + "/site"),
        )))
        net = fabric.network
        s = fabric.login("server")
        cfg = get_tiny_config("qwen3-8b").replace(param_dtype="bfloat16",
                                                  attention_impl="pallas")

        # publisher side: push weights into the home store, under the
        # reference's leaf names and layout
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = init_params(cfg, gen, dev)
        tree = state_to_reference(cfg, {"params": params})
        mgr = CheckpointManager(s.client, "home/models/qwen3-tiny")
        mgr.save(0, tree)
        s.client.sync()
        print(f"published weights; WAN bytes {net.bytes_sent:,}")

        # serving side: striped restore through the cache, onto the device
        clock0 = net.clock
        restored, manifest = mgr.restore(tree)
        print(f"weights restored in {net.clock - clock0:.2f}s WAN time "
              f"(step {manifest['step']})")

        params = state_from_reference(cfg, restored)["params"]
        engine = ServeEngine(cfg, params, slots=4, max_len=128, device=dev)
        requests = [
            Request(rid=i, prompt=list(range(1 + i, 6 + i)),
                    max_new_tokens=12)
            for i in range(10)
        ]
        for r in requests:
            engine.add_request(r)
        ticks = 0
        while any(not r.done for r in requests):
            engine.step()
            ticks += 1
        print(f"served {len(requests)} requests in {ticks} engine ticks, "
              f"{engine.tokens_generated} tokens generated on {dev}")
        for r in requests[:3]:
            print(f"  rid={r.rid} output={r.output}")


if __name__ == "__main__":
    main()
