"""The kernels have no backward: refuse a launch that autograd would need.

A CUDA kernel fills its output through ctypes, so the output has no
``grad_fn``.  Without this check a loss built on it would backpropagate
to the end and hand back ``None`` grads for every weight upstream of the
kernel.  The reference raises in the same place (``jax.grad`` through a
Pallas call fails), and it trains on the plain paths; so does the port.
"""
from __future__ import annotations

import torch


def check_no_grad(kernel: str, impl_flag: str, *tensors: torch.Tensor
                  ) -> None:
    """Raise ``RuntimeError`` when grad mode is on and any of ``tensors``
    requires grad; ``impl_flag`` names the config field that selects the
    plain path (``attention_impl`` or ``scan_impl``)."""
    if not torch.is_grad_enabled():
        return
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {kernel} CUDA kernel has no backward: an input requires "
            f"grad under grad mode. Train on {impl_flag}=\"xla\" (as the "
            f"reference does), or call it under torch.no_grad()")
