"""The model-FLOPs share of the card's bf16 peak over the window: the
window's tokens times ``flops.model_flops_per_token`` (three times that
for a train step: forward and backward, recomputation not counted),
over the window's seconds, against 989 TFLOP/s.  The card's power limit
is the result's ``card``."""
from portbench import flops


def read(t):
    if t["window_s"] <= 0 or t["model_flops"] <= 0:
        return None
    return 100.0 * t["model_flops"] / t["window_s"] / flops.MFU_PEAK
