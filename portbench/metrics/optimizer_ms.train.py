"""Device ms of the optimizer a train step: CUDA events around the train
step's calls of ``clip_by_global_norm`` and ``adamw_update`` (the
program's own functions, wrapped where ``train/step.py`` calls them)."""

CLIP = "repro_torch.train.step:clip_by_global_norm"
ADAMW = "repro_torch.train.step:adamw_update"
ENTRIES = [("repro_torch.train.step", "clip_by_global_norm", None),
           ("repro_torch.train.step", "adamw_update", None)]


def read(t):
    rows = t["calls"].get(CLIP, []) + t["calls"].get(ADAMW, [])
    if not rows:
        return None
    return sum(r["ms"] for r in rows) / t["traced_units"]
