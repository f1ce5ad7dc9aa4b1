"""Chunked WKV6 scan (RWKV6 "Finch" time mixing): CUDA kernel + plain.

Counterpart of ``repro/kernels/rwkv6_scan.py``.  ``rwkv6_scan`` launches
the hand-written kernel ``csrc/rwkv6_scan.cu`` for a CUDA tensor and runs
``rwkv6_scan_plain`` for a CPU tensor; there is no other route and no
fallback.  The plain version repeats the reference kernel's chunked
log-space math in PyTorch ops.  For a chunk of C tokens with per-token
per-channel decay w_t in (0, 1]:

    L_t  = sum_{j<=t} log w_j                   (chunk-local)
    y_t  = (r_t * e^{L_{t-1}}) S_0              (inter-chunk)
         + sum_{s<t} [r_t . (k_s * e^{L_{t-1}-L_s})] v_s
         + (r_t . (u * k_t)) v_t                (bonus)
    S'   = diag(e^{L_C}) S_0 + sum_s (k_s * e^{L_C-L_s})^T v_s

Every exponent is <= 0.  Unlike the reference (which asserts
``S % chunk == 0``), any S works: the last chunk is cut short.

The CUDA kernel runs one block a chunk and (b, h), in three passes: the
chunk-local pass (the intra-chunk term, cut into 16-token sub-chunks, and
the chunk's own state term U_c), the state pass (the state entering each
chunk, handed from the block of one chunk to the next through device
memory) and the inter-chunk pass.  ``rwkv6_scan_factored`` runs the same
passes in PyTorch ops, so the CPU tests hold the decomposition to the
reference; no path calls it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import check_no_grad

CHUNK = 64
HEAD_DIMS = (32, 64)


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r,k,v,w: [B,H,S,D]; u: [H,D] -> y [B,H,S,D] float32, in PyTorch ops."""
    B, H, S, D = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uu = u.float()[None, :, None, :]                   # [1,H,1,D]
    state = torch.zeros(B, H, D, D, dtype=torch.float32, device=r.device)
    out = torch.empty(B, H, S, D, dtype=torch.float32, device=r.device)
    for c0 in range(0, S, CHUNK):
        rc, kc, vc, wc = (t[:, :, c0:c0 + CHUNK] for t in (r, k, v, w))
        C = rc.shape[2]
        logw = torch.log(torch.clamp(wc, min=1e-37))
        L = torch.cumsum(logw, dim=2)                  # [B,H,C,D]
        L_prev = L - logw
        y = (rc * torch.exp(L_prev)) @ state           # inter-chunk
        expo = L_prev[:, :, :, None, :] - L[:, :, None, :, :]  # [B,H,C,C,D]
        tri = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)
        gated = torch.where(tri[:, :, None], torch.exp(expo), 0.0)
        A = torch.einsum("bhtd,bhsd,bhtsd->bhts", rc, kc, gated)
        A = A + torch.diag_embed((rc * uu * kc).sum(-1))
        out[:, :, c0:c0 + C] = y + A @ vc
        L_total = L[:, :, -1:]                         # [B,H,1,D]
        k_dec = kc * torch.exp(L_total - L)
        state = (torch.exp(L_total[:, :, 0])[..., None] * state
                 + k_dec.transpose(-1, -2) @ vc)
    return out


def rwkv6_scan_factored(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's three passes in PyTorch ops: r,k,v,w [B,H,S,D];
    u [H,D] -> y [B,H,S,D] float32.

    Chunks of 64 tokens (a ragged last one padded with r = k = v = 0,
    w = 1), each cut into four sub-chunks of 16.  Diagonal 16 x 16 blocks
    of A take the decay pair by pair, as the product of w between s and t;
    an off-diagonal block (s in sub-chunk j < i, t's) factors it through L
    at b_i = 16 i - 1 and b_{j+1}:
    e^{L_{t-1} - L_{b_i}} e^{L_{b_i} - L_{b_{j+1}}} e^{L_{b_{j+1}} - L_s},
    every exponent <= 0.
    """
    B, H, S, D = r.shape
    C, SUB = CHUNK, 16
    NC, NS = -(-S // C), C // SUB
    pad = NC * C - S
    r, k, v, w = (t.float() for t in (r, k, v, w))
    if pad:
        z = lambda t, x: torch.nn.functional.pad(t, (0, 0, 0, pad), value=x)
        r, k, v, w = z(r, 0.0), z(k, 0.0), z(v, 0.0), z(w, 1.0)
    blocks = lambda t: t.reshape(B, H, NC, C, D)
    r, k, v = blocks(r), blocks(k), blocks(v)
    logw = torch.log(torch.clamp(w, min=1e-37)).reshape(B, H, NC, NS, SUB, D)
    # 16-token chains, then the totals of the sub-chunks before each
    local = torch.cumsum(logw, dim=4)
    tot = local[:, :, :, :, -1:]
    L = (local + torch.cumsum(tot, dim=3) - tot).reshape(B, H, NC, C, D)
    Lp = torch.nn.functional.pad(L, (0, 0, 1, 0))[:, :, :, :C]   # L_{t-1}
    sub = lambda t: t.reshape(B, H, NC, NS, SUB, D)
    rs, ks, Ls, Lps = sub(r), sub(k), sub(L), sub(Lp)

    # diagonal blocks: the decay between s < t is the product of w over
    # s < j < t (diagonal t - s = delta of P), then the bonus
    W = torch.clamp(w, min=1e-37).reshape(B, H, NC, NS, SUB, D)
    P = torch.zeros(B, H, NC, NS, SUB, SUB, D, device=r.device)
    run = torch.ones_like(W)                         # indexed by t
    for delta in range(1, SUB):
        if delta > 1:
            run = torch.cat([run[..., :delta, :], run[..., delta:, :]
                             * W[..., 1:SUB - delta + 1, :]], dim=-2)
        P.diagonal(-delta, -3, -2).copy_(
            run[..., delta:, :].transpose(-1, -2))
    Adiag = torch.einsum("...td,...sd,...tsd->...ts", rs, ks, P)
    Adiag = Adiag + torch.diag_embed(
        (rs * u.float()[None, :, None, None, None, :] * ks).sum(-1))

    # off-diagonal blocks: rq g_ij kl^T for j < i
    Lb = Lps[..., 0, :]                                    # L_{b_i}
    Le = Ls[..., -1, :]                                    # L_{b_{j+1}}
    rq = rs * torch.exp(Lps - Lb[..., None, :])
    kl = ks * torch.exp(Le[..., None, :] - Ls)
    before = torch.ones(NS, NS, dtype=torch.bool,
                        device=r.device).tril(-1)          # j < i
    gexp = Lb[..., :, None, :] - Le[..., None, :, :]       # [..,i,j,D]
    g = torch.where(before[:, :, None],
                    torch.exp(torch.where(before[:, :, None], gexp, 0.0)),
                    0.0)
    Aoff = torch.einsum("...itd,...ijd,...jsd->...itjs", rq, g, kl)
    eye = torch.eye(NS, device=r.device)
    A = (Aoff + torch.einsum("...its,ij->...itjs", Adiag, eye)
         ).reshape(B, H, NC, C, C)

    # the chunk's own state term: kl with the gain e^{L_{C-1} - L_{b_{j+1}}}
    Lend = L[:, :, :, -1]                                  # [B,H,NC,D]
    kd = kl * torch.exp(Lend[:, :, :, None, None] - Le[..., None, :])
    U = kd.reshape(B, H, NC, C, D).transpose(-1, -2) @ v
    dec = torch.exp(Lend)
    # the state pass: the state entering each chunk
    E = [torch.zeros(B, H, D, D, dtype=torch.float32, device=r.device)]
    for c in range(NC - 1):
        E.append(dec[:, :, c, :, None] * E[-1] + U[:, :, c])
    E = torch.stack(E, dim=2)                              # [B,H,NC,D,D]
    # the inter-chunk pass, with the intra-chunk term
    y = (r * torch.exp(Lp)) @ E + A @ v
    return y.reshape(B, H, NC * C, D)[:, :, :S]


def _check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"want r = k = v = w [B,H,S,D]; got {tuple(r.shape)},"
                         f" {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}")
    B, H, S, D = r.shape
    if tuple(u.shape) != (H, D):
        raise ValueError(f"want u [H,D] = {(H, D)}; got {tuple(u.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported; kernel has {HEAD_DIMS}")
    if S < 1 or B * H < 1:
        raise ValueError("empty input")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
    if r.stride(-1) != 1:
        raise ValueError(f"r's last dim must be dense; strides {r.stride()}")
    if any(t.stride() != r.stride() for t in (k, v, w)):
        raise ValueError(f"r, k, v, w must share strides; got {r.stride()}, "
                         f"{k.stride()}, {v.stride()}, {w.stride()}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")


def _entry():
    fn = _build.load("rwkv6_scan").rwkv6_scan_f32
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong)] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, mark=None) -> torch.Tensor:
    """Launch the kernel on the current stream; returns y.

    ``mark``, if given, is called with "flags" before the flags are
    zeroed, with "scan" before the kernel is launched and with None after
    it: a caller may record a CUDA event there to time each.  Counts
    nothing; ``rwkv6_scan`` does.
    """
    mark = mark or (lambda name: None)
    B, H, S, D = r.shape
    BH, NC = B * H, -(-S // CHUNK)
    y = torch.empty_like(r)
    # the state entering each chunk but the first, [BH][NC-1][D][D]
    state = torch.empty(BH * (NC - 1) * D * D, dtype=torch.float32,
                        device=r.device)
    strides = lambda t: (ctypes.c_longlong * 3)(*t.stride()[:3])
    with torch.cuda.device(r.device):
        mark("flags")
        flags = torch.zeros(BH * NC + 1, dtype=torch.int32, device=r.device)
        stream = torch.cuda.current_stream().cuda_stream
        mark("scan")
        err = _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                       u.data_ptr(), state.data_ptr(), flags.data_ptr(),
                       y.data_ptr(), BH, H, S, D, strides(r), strides(y),
                       stream)
        mark(None)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    return y


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r,k,v,w: [B,H,S,D] f32; u: [H,D] f32 -> y [B,H,S,D] f32.

    On a CUDA tensor this launches the CUDA kernel (D in {32, 64}, any S,
    chunks of 64) on the current stream, or raises; ``launches`` counts
    one per call.  The kernel reads r, k, v, w through their
    strides, which they share (the last is 1), and y is laid out as
    ``torch.empty_like(r)`` lays it: a transposed view of [B,S,H,D]
    tensors goes in and comes out without a copy.
    """
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda, not {r.device}")
    _check(r, k, v, w, u)
    check_no_grad("rwkv6_scan", "scan_impl", r, k, v, w, u)
    y = _launch(r, k, v, w, u)
    rwkv6_scan.launches += 1
    return y


rwkv6_scan.launches = 0   # calls that launched the kernel (CUDA tensors)
