"""What the plain references share: products in a stated precision, the
RMS norm, the head's loss in row blocks, and (for training) AdamW with
blockwise int8 moments and its schedule, written from the configuration's
statement of them.

Plain PyTorch in float32 with TF32 off; nothing here imports the program.
``Prec(fp8=True)`` is the control: every product's operands rounded to
float8 before an f32 product, e4m3 forward and e5m2 for the gradient
that a backward product takes (one scale a tensor, its largest magnitude
to the format's largest), the step below the bf16 that the
configurations state.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Z_LOSS = 1e-4          # the loss's z term: 1e-4 mean(logsumexp^2)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def fp8_round(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to a float8 format with one scale for the tensor."""
    x = x.detach()
    amax = x.abs().amax().float().clamp(min=1e-30)
    s = amax / FP8[fmt]
    return (x / s).to(fmt).to(x.dtype) * s


class _Fp8Product(torch.autograd.Function):
    """op(a, b) on operands rounded to e4m3; its backward takes the
    incoming gradient rounded to e5m2 into the same product's
    gradients (a float8 cast alone passes no gradient)."""

    @staticmethod
    def forward(ctx, op, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        ctx.op = op
        return op(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        with torch.enable_grad():
            a = qa.requires_grad_(ctx.needs_input_grad[1])
            b = qb.requires_grad_(ctx.needs_input_grad[2])
            out = ctx.op(a, b)
            want = [t for t in (a, b) if t.requires_grad]
            got = iter(torch.autograd.grad(
                out, want, fp8_round(g, torch.float8_e5m2)))
        return (None, next(got) if a.requires_grad else None,
                next(got) if b.requires_grad else None)


def _matmul(a, b):
    return a @ b


class Prec:
    """The precision of the products: f32, or the fp8 control."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return _Fp8Product.apply(_matmul, a, b)
        return a @ b

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        if self.fp8:
            return _Fp8Product.apply(functools.partial(torch.einsum, eq),
                                     a, b)
        return torch.einsum(eq, a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def head_loss(prec: Prec, h: torch.Tensor, norm: torch.Tensor,
              unembed: torch.Tensor, targets: torch.Tensor, eps: float,
              rows: int = 2048) -> Dict[str, torch.Tensor]:
    """ce and z of h [T, d] against targets [T], the logits made a block
    of ``rows`` tokens at a time (a [T, V] f32 tensor need not fit)."""
    w = unembed.float()
    lse_all, tgt_all = [], []
    for r0 in range(0, h.shape[0], rows):
        hn = rmsnorm(h[r0:r0 + rows], norm, eps)
        logits = prec.mm(hn, w)
        lse_all.append(torch.logsumexp(logits, -1))
        tgt_all.append(logits.gather(1, targets[r0:r0 + rows, None].long()
                                     )[:, 0])
    lse, tgt = torch.cat(lse_all), torch.cat(tgt_all)
    return {"ce": (lse - tgt).mean(), "z": Z_LOSS * lse.square().mean()}


# ---------------------------------------------------------------------------
# training: the optimizer as the configuration states it
# ---------------------------------------------------------------------------

def lr_at(step: int, o: Dict) -> float:
    """Linear warm-up over ``warmup_steps`` from 0, then cosine decay to a
    tenth of ``lr`` at ``total_steps``."""
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    total = max(o["total_steps"] - o["warmup_steps"], 1)
    frac = min(max((step - o["warmup_steps"]) / total, 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * frac))
    return o["lr"] * warm * (0.1 + 0.9 * cos)


def q8(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 along the last dim: codes round(x / s) in [-127, 127]
    with s = the block's largest magnitude / 127 (a zero block: s = 0)."""
    D = x.shape[-1]
    nb = -(-D // block)
    xb = F.pad(x, (0, nb * block - D)).reshape(*x.shape[:-1], nb, block)
    s = xb.abs().amax(-1) / 127.0
    codes = torch.round(xb / torch.where(s == 0, 1.0, s)[..., None]
                        ).clamp(-127, 127).to(torch.int8)
    return codes.reshape(*x.shape[:-1], nb * block)[..., :D], s


def dq8(codes: torch.Tensor, s: torch.Tensor, block: int) -> torch.Tensor:
    D = codes.shape[-1]
    nb = s.shape[-1]
    c = F.pad(codes.float(), (0, nb * block - D)).reshape(
        *codes.shape[:-1], nb, block)
    return (c * s[..., None]).reshape(*codes.shape[:-1], nb * block)[..., :D]


class AdamW8:
    """AdamW whose moments live as blockwise int8 codes (the second in the
    square-root domain), decoded, updated in f32 and encoded each step;
    decay on the leaves the configuration names (``decay`` per key)."""

    def __init__(self, params: Dict[str, torch.Tensor], o: Dict,
                 decay: Dict[str, bool]):
        self.o, self.decay, self.count = o, decay, 0
        blk = o["int8_block"]
        self.m = {k: q8(torch.zeros_like(p), blk) for k, p in params.items()}
        self.v = {k: q8(torch.zeros_like(p), blk) for k, p in params.items()}

    def first_moment(self, key: str) -> torch.Tensor:
        return dq8(*self.m[key], self.o["int8_block"])

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        o, blk = self.o, self.o["int8_block"]
        lr = lr_at(self.count, o)
        self.count += 1
        bc1 = 1.0 - o["b1"] ** self.count
        bc2 = 1.0 - o["b2"] ** self.count
        for k, p in params.items():
            g = grads[k]
            m = o["b1"] * dq8(*self.m[k], blk) + (1 - o["b1"]) * g
            v = o["b2"] * dq8(*self.v[k], blk).square() \
                + (1 - o["b2"]) * g.square()
            upd = (m / bc1) / ((v / bc2).sqrt() + o["eps"])
            wd = o["weight_decay"] if self.decay[k] else 0.0
            p.copy_(p - lr * (upd + wd * p))
            self.m[k] = q8(m, blk)
            self.v[k] = q8(v.sqrt(), blk)


def clip_(grads: Dict[str, torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the grads in place to a global L2 norm of at most
    ``max_norm``; returns the norm before."""
    gn = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return gn
