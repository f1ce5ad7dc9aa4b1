"""The CUDA kernels (flash attention, WKV6 scan, selective scan, grouped
matmul, the MoE's dispatch and combine) against their plain versions, on
the card (the MoE layer through them against its ``"xla"`` path) (flash also at the
enc-dec family's non-causal shapes and through a tiny enc-dec and VLM
prefill and decode), and each wrapper's grad guard; a tiny train step on the card against the CPU's, the
eval step through flash while the train step refuses it; the data
pipeline's batches on the card against the CPU's, and a tiny ``Trainer``
whose restore after a crash equals a cold restore.

Skips without a CUDA card.  On the card (no JAX needed):

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gmm as tgmm
from repro_torch.kernels import mamba_scan as tmb
from repro_torch.kernels import moe_permute as tmp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rwkv6_scan as trw
from test_torch_moe_permute import _ulps


def _inputs(seed, dtype, *shapes):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(getattr(torch, dtype)).cuda()
            for s in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,q_offset", [
    (1, 2, 2, 128, 128, 64, True, 0),
    (2, 4, 2, 256, 256, 64, False, 0),
    (1, 8, 1, 128, 128, 128, True, 0),
    (2, 2, 2, 128, 384, 64, True, 256),
    (1, 32, 8, 777, 777, 128, True, 0),      # ragged, qwen3-8b heads
    (1, 4, 2, 5, 300, 128, True, 295),       # few rows, long kv
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(B, Hq, Hkv, Sq, Skv, D, causal, q_offset,
                                   dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _inputs(Sq + Skv, dtype, (B, Hq, Sq, D), (B, Hkv, Skv, D),
                      (B, Hkv, Skv, D))
    launches = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == launches + 1
    want = tfa.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,q_offset", [
    (1, 32, 8, 777, 777, 128, True, 0),      # ragged Sq, qwen3-8b heads
    (2, 8, 2, 300, 500, 128, False, 0),      # Sq != Skv, not causal
    (2, 4, 2, 128, 384, 64, True, 256),      # q_offset = 256
    (1, 4, 2, 77, 333, 64, True, 256),       # ragged both, q_offset
    (4, 32, 4, 256, 256, 128, True, 0),      # qwen3-moe heads
    (2, 4, 2, 300, 300, 16, True, 0),        # tiny head dims: mma.sync
    (1, 4, 4, 200, 333, 32, False, 0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_model_layout_takes_its_route(B, Hq, Hkv, Sq, Skv, D, causal,
                                            q_offset, dtype):
    """ops.flash_attention on [B,S,H,D] tensors: the kernel reads the
    transposed views through their strides, writes o in the model layout
    (contiguous [B,Sq,Hq,D]), and the launch takes ``tfa.route``'s kernel;
    against the plain version at 2e-2 (bf16) or 2e-5 (f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(Sq + Skv + D)
    q, k, v = (torch.randn(B, S, H, D, generator=gen).to(dt).cuda()
               for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    kernel = tfa.route(dt, D)
    launches = tfa.flash_attention.launches
    by_route = tfa.flash_attention.route_launches[kernel]
    got = tops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == launches + 1
    assert tfa.flash_attention.route_launches[kernel] == by_route + 1
    assert got.shape == (B, Sq, Hq, D) and got.is_contiguous()
    tr = lambda t: t.transpose(1, 2)
    want = tr(tfa.flash_attention_plain(tr(q), tr(k), tr(v), causal=causal,
                                        q_offset=q_offset))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv", [
    (4, 1024, 1024),      # seamless encoder self-attention
    (4, 64, 1024),        # cross-attention in prefill: text against frames
    (1, 200, 777),        # ragged both
    (4, 1, 1024),         # cross-attention in a decode step: one query row
    (4, 1, 777),          # one query row, ragged frames
    (2, 1, 33),           # one query row, one short kv tile
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_cross_attention_takes_its_route(B, Sq, Skv, dtype):
    """The enc-dec family's non-causal shapes at its 16/16 heads and head
    dim 64 (bf16: the wgmma route; f32: the f32 route), through
    ``ops.flash_attention``, against the plain version at 2e-2 (bf16) or
    2e-5 (f32) element-wise, and against the plain version in f32 at a
    relative RMS error of 1e-2 (bf16) or 1e-4 (f32).  The outputs average
    hundreds of keys and are ~0.05, so only the second limit fails a
    kernel that shrinks every output by a few percent, as keys past the
    end left unmasked would."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    H, D = 16, 64
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(Sq + Skv)
    q, k, v = (torch.randn(B, S, H, D, generator=gen).to(dt).cuda()
               for S in (Sq, Skv, Skv))
    kernel = tfa.route(dt, D)
    assert kernel == ("wgmma" if dtype == "bfloat16" else "f32")
    by_route = tfa.flash_attention.route_launches[kernel]
    got = tops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert tfa.flash_attention.route_launches[kernel] == by_route + 1
    tr = lambda t: t.transpose(1, 2)
    want = tr(tfa.flash_attention_plain(tr(q), tr(k), tr(v), causal=False))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    want32 = tr(tfa.flash_attention_plain(tr(q).float(), tr(k).float(),
                                          tr(v).float(), causal=False))
    err = got.float() - want32
    rms = float(torch.linalg.vector_norm(err)
                / torch.linalg.vector_norm(want32))
    rms_tol = 1e-2 if dtype == "bfloat16" else 1e-4
    assert rms <= rms_tol, (f"rms_rel_err={rms} > {rms_tol}, "
                            f"max_abs_err={float(err.abs().max())}")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-72b"])
def test_encdec_and_vlm_decode_on_flash_match_plain_path(arch):
    """A tiny config at head dim 64 in f32 on the card: prefill and three
    greedy decode steps through flash (the enc-dec cross-attention with
    one query row) against the plain attention path; logits within 1e-4,
    the same tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_tiny_config
    from repro_torch.data import make_batch
    from repro_torch.models import decode_step, init_params, prefill
    cfg = get_tiny_config(arch).replace(
        head_dim=64, dtype="float32", param_dtype="float32",
        attention_impl="pallas",
        mrope_sections=(16, 8, 8) if arch == "qwen2-vl-72b" else ())
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    batch = make_batch(cfg, 2, 48, device="cuda")
    plain = cfg.replace(attention_impl="xla")
    outs = []
    for c in (cfg, plain):
        launches = tfa.flash_attention.launches
        logits, cache = prefill(c, params, batch, max_len=64)
        toks, seq = logits[:, -1].argmax(-1, keepdim=True), [logits]
        for _ in range(3):
            logits, cache = decode_step(c, params, toks, cache)
            toks = logits[:, -1].argmax(-1, keepdim=True)
            seq.append(logits)
        torch.cuda.synchronize()
        outs.append((seq, tfa.flash_attention.launches - launches))
    (ks, kn), (ps, pn) = outs
    assert kn > 0 and pn == 0
    for a, b in zip(ks, ps):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        assert torch.equal(a[:, -1].argmax(-1), b[:, -1].argmax(-1))


def _guarded_calls():
    """One small CUDA call of each kernel wrapper: (name, fn, args)."""
    dev = "cuda"
    bf = dict(device=dev, dtype=torch.bfloat16)
    ids = torch.tensor([[0, 1], [1, 2], [2, 3], [3, 0]], device=dev)
    pos = torch.tensor([[0, 0], [1, 0], [1, 0], [1, 3]], device=dev)
    return [
        ("flash_attention", tfa.flash_attention,
         [torch.randn(1, 2, 64, 64, **bf) for _ in range(3)]),
        ("rwkv6_scan", trw.rwkv6_scan,
         [torch.randn(1, 2, 64, 64, device=dev) for _ in range(3)]
         + [torch.rand(1, 2, 64, 64, device=dev),
            torch.randn(2, 64, device=dev)]),
        ("mamba_scan", tmb.mamba_scan,
         [-torch.rand(32, 16, device=dev), torch.rand(1, 64, 32, device=dev),
          torch.randn(1, 64, 16, device=dev),
          torch.randn(1, 64, 16, device=dev),
          torch.randn(1, 64, 32, device=dev)]),
        ("gmm", tgmm.gmm,
         [torch.randn(64, 64, **bf), torch.randn(2, 64, 64, **bf),
          torch.tensor([32, 32], dtype=torch.int32, device=dev)]),
        ("gmm_equal", tgmm.gmm_equal,
         [torch.randn(2, 32, 64, **bf), torch.randn(2, 64, 64, **bf)]),
        ("moe_dispatch", tmp.moe_dispatch,
         [torch.randn(4, 64, **bf), ids, pos, 4, 3]),
        ("moe_combine", tmp.moe_combine,
         [torch.randn(4, 4, 64, **bf), ids, pos,
          torch.full((4, 2), 0.5, device=dev)]),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("which", range(7), ids=[
    "flash_attention", "rwkv6_scan", "mamba_scan", "gmm", "gmm_equal",
    "moe_dispatch", "moe_combine"])
def test_cuda_wrapper_refuses_grad_and_runs_without(which):
    """A CUDA kernel has no backward: under grad mode an input that
    requires grad is refused before any launch; under torch.no_grad() the
    same call launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    name, fn, args = _guarded_calls()[which]
    counter = tgmm.gmm if name.startswith("gmm") else fn
    args[0].requires_grad_(True)
    launches = counter.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    assert counter.launches == launches
    with torch.no_grad():
        out = fn(*args)
    torch.cuda.synchronize()
    assert counter.launches == launches + 1
    assert bool(torch.isfinite(out).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,S,D,decay", [
    (2, 3, 128, 64, None),        # the JAX sweep's shape
    (1, 2, 64, 32, None),         # D = 32
    (1, 40, 777, 64, None),       # ragged, rwkv6-3b heads
    (2, 4, 100, 32, None),        # ragged, two chunks
    (1, 2, 1, 64, None),          # one token
    (1, 1, 256, 64, 1e-6),        # strong decay
    (4, 40, 2048, 32, None),      # the forward's shape at D = 32
    (1, 40, 777, 64, "mixed"),    # per-channel decays from 1e-6 to 1
    (2, 40, 64, 64, None),        # one chunk: no state to carry
])
def test_rwkv6_scan_kernel_matches_plain(B, H, S, D, decay):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(S * D + H)
    r, k, v = (torch.randn(B, H, S, D, generator=gen) for _ in range(3))
    if decay is None:
        w = torch.exp(-torch.exp(torch.randn(B, H, S, D, generator=gen)))
    elif decay == "mixed":
        w = torch.logspace(-6, 0, D).expand(B, H, S, D).contiguous()
    else:
        w = torch.full((B, H, S, D), decay)
    u = torch.randn(H, D, generator=gen)
    x = [t.cuda() for t in (r, k, v, w, u)]
    launches = trw.rwkv6_scan.launches
    got = trw.rwkv6_scan(*x)
    torch.cuda.synchronize()
    assert trw.rwkv6_scan.launches == launches + 1
    want = trw.rwkv6_scan_plain(*x).cpu().numpy()
    got = got.cpu().numpy()
    assert not np.isnan(got).any()
    if decay is None:      # scale-normalised, as tests/test_kernels.py
        scale = float(np.abs(want).max()) + 1.0
        np.testing.assert_allclose(got / scale, want / scale, rtol=2e-4,
                                   atol=2e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,D", [(2, 100, 4, 64), (1, 777, 40, 64),
                                     (2, 128, 3, 32)])
def test_rwkv6_scan_kernel_model_layout(B, S, H, D):
    """ops.rwkv6_scan hands the kernel [B,S,H,D] tensors as strided views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(S + H)
    r, k, v = (torch.randn(B, S, H, D, generator=gen).cuda() for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, S, H, D, generator=gen))).cuda()
    u = torch.randn(H, D, generator=gen).cuda()
    launches = trw.rwkv6_scan.launches
    got = tops.rwkv6_scan(r, k, v, w, u)
    torch.cuda.synchronize()
    assert trw.rwkv6_scan.launches == launches + 1
    assert got.shape == (B, S, H, D) and got.is_contiguous()
    tr = lambda t: t.transpose(1, 2).contiguous()
    want = trw.rwkv6_scan_plain(tr(r), tr(k), tr(v), tr(w), u).transpose(1, 2)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    scale = float(np.abs(want).max()) + 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_rwkv6_scan_kernel_unaligned_rows():
    """Rows that start off a 16-byte boundary (views into [.., D + 1]
    tensors) take the kernel's scalar loads and stores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, H, S, D = 2, 3, 200, 64
    gen = torch.Generator().manual_seed(7)
    wide = lambda x: x.cuda()[..., 1:]
    r, k, v = (wide(torch.randn(B, H, S, D + 1, generator=gen))
               for _ in range(3))
    w = wide(torch.exp(-torch.exp(torch.randn(B, H, S, D + 1,
                                              generator=gen))))
    u = torch.randn(H, D, generator=gen).cuda()
    assert r.stride(2) % 4 != 0
    launches = trw.rwkv6_scan.launches
    got = trw.rwkv6_scan(r, k, v, w, u)
    torch.cuda.synchronize()
    assert trw.rwkv6_scan.launches == launches + 1
    want = trw.rwkv6_scan_plain(r, k, v, w, u).cpu().numpy()
    got = got.cpu().numpy()
    scale = float(np.abs(want).max()) + 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,di,N,dt", [
    (1, 64, 32, 8, None),         # the JAX sweep's shapes
    (2, 128, 64, 16, None),
    (1, 256, 128, 16, None),
    (1, 777, 16384, 16, None),    # ragged S, jamba's d_inner
    (2, 100, 200, 8, None),       # ragged S and di
    (1, 1, 128, 16, None),        # one token
    (1, 256, 256, 16, 30.0),      # strong decay: exp underflows to 0
    (1, 2048, 256, 16, 1e-3),     # weak decay
    (1, 4096, 16384, 16, 1e-3),   # weak decay over serving's longest prompt
])
def test_mamba_scan_kernel_matches_plain(B, S, di, N, dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(S + di + N)
    A = -torch.exp(torch.randn(di, N, generator=gen))
    if dt is None:
        dtv = torch.nn.functional.softplus(torch.randn(B, S, di,
                                                       generator=gen))
    else:
        dtv = torch.full((B, S, di), dt)
    b, c = (torch.randn(B, S, N, generator=gen) for _ in range(2))
    x = torch.randn(B, S, di, generator=gen)
    xs = [t.cuda() for t in (A, dtv, b, c, x)]
    launches = tmb.mamba_scan.launches
    got, hT = tmb.mamba_scan(*xs, return_state=True)
    torch.cuda.synchronize()
    assert tmb.mamba_scan.launches == launches + 1
    want, want_h = (t.cpu().numpy() for t in
                    tmb.mamba_scan_plain(*xs, return_state=True))
    # as tests/test_kernels.py: 1e-4 of the output's scale, for y and hT
    for g, w in ((got.cpu().numpy(), want), (hT.cpu().numpy(), want_h)):
        assert g.shape == w.shape and np.isfinite(g).all()
        scale = float(np.abs(w).max()) + 1.0
        np.testing.assert_allclose(g / scale, w / scale, rtol=1e-4,
                                   atol=1e-4)
    # without the state: the same y, one launch more
    alone = tmb.mamba_scan(*xs)
    assert tmb.mamba_scan.launches == launches + 2
    np.testing.assert_array_equal(alone.cpu().numpy(), got.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("N", [8, 16])
def test_mamba_scan_each_state_dim_matches_plain(N):
    """Each N instance of the kernel through ``_launch``, on a ragged S
    and di (4-byte copies) and on a di of 16-byte rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for B, S, di in ((2, 77, 130), (1, 300, 512)):
        gen = torch.Generator().manual_seed(N + di)
        A = -torch.exp(torch.randn(di, N, generator=gen))
        dtv = torch.nn.functional.softplus(torch.randn(B, S, di,
                                                       generator=gen))
        b, c = (torch.randn(B, S, N, generator=gen) for _ in range(2))
        x = torch.randn(B, S, di, generator=gen)
        xs = [t.cuda() for t in (A, dtv, b, c, x)]
        y = torch.empty_like(xs[-1])
        hT = torch.empty(B, di, N, device="cuda")
        tmb._launch(*xs, y, hT)
        want = tmb.mamba_scan_plain(*xs, return_state=True)
        for g, w in zip((y, hT), want):
            scale = float(w.abs().max()) + 1.0
            np.testing.assert_allclose((g / scale).cpu().numpy(),
                                       (w / scale).cpu().numpy(),
                                       rtol=1e-4, atol=1e-4)


def _gmm_scaled_err(got, want_f32):
    """max |got - want| / max |want|, in f32."""
    return float((got.float() - want_f32).abs().max()) / \
        max(float(want_f32.abs().max()), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,K,N", [
    ([128, 128, 128, 128], 64, 128),     # the JAX sweep's cases
    ([100, 0, 300, 112], 64, 128),
    ([0, 0, 512, 0], 64, 128),
    ([1, 2, 3, 506], 64, 128),
    ([5, 0, 70, 1, 300], 100, 200),      # K, N past whole tiles; not 8s
    ([641] * 8, 2048, 768),              # capacity groups, gate/up widths
    ([9, 9, 9], 768, 2048),              # decode groups, down widths
    ([641] * 4, 768, 2048),              # qwen3-moe shapes at 4 experts
    ([161] * 4, 2048, 768),
    ([0, 1, 63, 64, 65, 127, 128, 129, 641], 256, 384),   # half tiles
    ([5, 0, 70, 1, 300], 200, 136),      # K past BK, N past BN: 8s
    ([(g * 7) % 23 for g in range(300)], 64, 128),       # 300 groups
    ([(g * 5) % 11 for g in range(1000)], 72, 64),       # 3 scan chunks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_kernel_matches_plain(sizes, K, N, dtype):
    """f32: scaled error 1e-5; bf16: one rounding of the f32 product
    (2^-8 of the output scale, within 4e-3).  The launch goes through the
    route that ``tgmm.route`` names for the dtype and shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(sum(sizes) + K + N)
    M, G = sum(sizes) + 7, len(sizes)       # 7 rows past the last group
    lhs = torch.randn(M, K, generator=gen).to(getattr(torch, dtype)).cuda()
    rhs = torch.randn(G, K, N, generator=gen).to(getattr(torch, dtype)).cuda()
    gs = torch.tensor(sizes, dtype=torch.int32).cuda()
    launches = tgmm.gmm.launches
    kernel = tgmm.route(lhs.dtype, K, N, G)
    by_route = tgmm.gmm.route_launches[kernel]
    got = tgmm.gmm(lhs, rhs, gs)
    torch.cuda.synchronize()
    assert tgmm.gmm.launches == launches + 1
    assert tgmm.gmm.route_launches[kernel] == by_route + 1
    assert got.dtype == lhs.dtype and got.shape == (M, N)
    want = tgmm.gmm_plain(lhs.float(), rhs.float(), gs)
    assert float(got[sum(sizes):].float().abs().max()) == 0.0
    tol = 1e-5 if dtype == "float32" else 4e-3
    assert _gmm_scaled_err(got, want) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("G,R,K,N", [(8, 641, 256, 96), (4, 9, 100, 40),
                                     (3, 200, 64, 128), (4, 641, 768, 2048),
                                     (4, 9, 2048, 768), (5, 64, 200, 136),
                                     (12, 100, 200, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_equal_matches_einsum(G, R, K, N, dtype):
    """The capacity layout: one launch against the f32 einsum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(G * R + K)
    x = torch.randn(G, R, K, generator=gen).to(getattr(torch, dtype)).cuda()
    w = torch.randn(G, K, N, generator=gen).to(getattr(torch, dtype)).cuda()
    launches = tgmm.gmm.launches
    kernel = tgmm.route(x.dtype, K, N, G)
    by_route = tgmm.gmm.route_launches[kernel]
    got = tops.gmm_equal(x, w)
    torch.cuda.synchronize()
    assert tgmm.gmm.launches == launches + 1 and got.shape == (G, R, N)
    assert tgmm.gmm.route_launches[kernel] == by_route + 1
    want = torch.einsum("grk,gkn->grn", x.float(), w.float())
    tol = 1e-5 if dtype == "float32" else 4e-3
    assert _gmm_scaled_err(got, want) <= tol


def _moe_routes(T, E, k, d, dtype, cf=1.25, seed=0):
    """One random route of the MoE layer's own ``_slots``, skewed towards a
    few experts so that some overflow: (x [T,d], ids, pos [T,k], gate_w
    [T,k], C), on the card."""
    from repro_torch.models import moe as tmoe

    class M:
        num_experts, experts_per_token, capacity_factor = E, k, cf
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(T, d, generator=gen)
    router = torch.randn(d, E, generator=gen) * d ** -0.5
    router[:, : max(E // 16, 1)] += 0.05
    C = tmoe._capacity(M, T)
    ids, pos, _, gate_w, _ = tmoe._slots(M, router, x, C)
    return (x.to(dtype).cuda(), ids.view(T, k).cuda(), pos.view(T, k).cuda(),
            gate_w.cuda(), C)


def _bits(t):
    """t's elements as integers of their width: equal bits, equal ints."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


# (T, E, k, d, dtype): the scoring cell's layer (C 640), decode ticks
# (C = k), rows of 154, 4100 and 8200 bytes (2-, 4- and 8-byte vectors;
# 77 is no multiple of 8), f32 and f16
MOE_SHAPES = [(8192, 128, 8, 2048, torch.bfloat16),
              (1, 128, 8, 2048, torch.bfloat16),
              (16, 128, 8, 2048, torch.bfloat16),
              (300, 16, 4, 77, torch.bfloat16),
              (300, 16, 4, 2050, torch.bfloat16),
              (300, 16, 4, 4100, torch.bfloat16),
              (300, 16, 4, 77, torch.float32),
              (512, 32, 8, 2048, torch.float32),
              (256, 32, 8, 1024, torch.float16)]
MOE_IDS = ["cell", "decode1", "decode16", "d77-bf16", "d2050", "d4100",
           "d77-f32", "f32", "f16"]


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,k,d,dtype", MOE_SHAPES, ids=MOE_IDS)
def test_moe_dispatch_kernel_matches_plain_bit_for_bit(T, E, k, d, dtype):
    """A copy: every row of [E, C+1, d] equal to the plain version's in
    every bit, kept rows and zeros alike, the parking slot zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, ids, pos, _, C = _moe_routes(T, E, k, d, dtype, seed=T + d)
    if T <= 16:
        assert C == k
    launches = tmp.moe_dispatch.launches
    got = tops.moe_dispatch(x, ids, pos, E, C)
    torch.cuda.synchronize()
    assert tmp.moe_dispatch.launches == launches + 1
    want = tmp.moe_dispatch_plain(x, ids, pos, E, C)
    assert got.shape == (E, C + 1, d) and got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    assert not bool(got[:, C].any())
    assert 0 < int((pos < C).sum()) < T * k or T <= 16


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,k,d,dtype", MOE_SHAPES, ids=MOE_IDS)
def test_moe_combine_kernel_matches_plain(T, E, k, d, dtype):
    """Within one ulp of the dtype: both round each product and sum in
    f32 in the order j = 0..k-1, so only the f32 summation order could
    part them.  The parking slot holds garbage here: a dropped assignment
    must add nothing, so those rows may never reach the sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, ids, pos, gate_w, C = _moe_routes(T, E, k, d, dtype, seed=T + d + 1)
    gen = torch.Generator(device="cuda").manual_seed(T)
    ye = torch.randn(E, C + 1, d, generator=gen, device="cuda").to(dtype)
    launches = tmp.moe_combine.launches
    got = tops.moe_combine(ye, ids, pos, gate_w)
    torch.cuda.synchronize()
    assert tmp.moe_combine.launches == launches + 1
    assert got.shape == (T, d) and got.dtype == dtype
    ye[:, C] = float("nan")          # the kernel never reads these rows
    again = tops.moe_combine(ye, ids, pos, gate_w)
    assert torch.equal(_bits(again), _bits(got))
    ye[:, C] = 0
    want = tmp.moe_combine_plain(ye, ids, pos, gate_w)
    assert _ulps(got, want) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
def test_moe_layer_through_the_kernels_matches_xla(arch):
    """``moe_apply`` under ``"pallas"`` (dispatch, gmm, combine kernels) on
    the card against ``"xla"`` on the card, at ``tests/test_torch_moe.py``'s
    f32 tolerance; each kernel launched once a layer call, as many as a
    traced unit's ``moe.dispatch`` spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import tracing
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import moe as tmoe
    cfg = get_tiny_config(arch).replace(dtype="float32",
                                        param_dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, chunk_tokens=32))
    p = tmoe.moe_init(cfg, torch.Generator().manual_seed(1),
                      torch.device("cpu"))
    p = {n: t.cuda() for n, t in p.items()}
    x = torch.randn(2, 48, cfg.d_model,
                    generator=torch.Generator().manual_seed(2)).cuda()
    want, want_aux = tmoe.moe_apply(cfg.replace(scan_impl="xla"), p, x)
    launches = (tmp.moe_dispatch.launches, tmp.moe_combine.launches)
    was = tracing.enabled()
    tracing.clear()
    tracing.enable()
    try:
        with torch.no_grad(), tracing.unit("u", x):
            got, aux = tmoe.moe_apply(cfg.replace(scan_impl="pallas"), p, x)
        t = tracing.totals()
    finally:
        (tracing.enable if was else tracing.disable)()
        tracing.clear()
    calls = 3                                   # 96 tokens in chunks of 32
    assert (tmp.moe_dispatch.launches, tmp.moe_combine.launches) == \
        (launches[0] + calls, launches[1] + calls)
    assert t["spans"]["moe.dispatch"]["calls"] == calls
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


def _tiny_run(**model_kw):
    from repro_torch.config import OptimConfig, RunConfig, SHAPES
    from repro_torch.configs import get_tiny_config
    cfg = get_tiny_config("qwen3-4b").replace(**model_kw)
    return RunConfig(model=cfg, shape=SHAPES["train_4k"], microbatches=2,
                     optim=OptimConfig(warmup_steps=1))


def _tiny_params_and_batch(run, device):
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import tree_map
    cpu = init_params(run.model, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, run.model.vocab_size, (4, 33)))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:],
             "positions": torch.arange(32).expand(4, 32).contiguous()}
    return (tree_map(lambda p: p.to(device), cpu),
            {k: v.to(device) for k, v in batch.items()})


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu():
    """One tiny train step (f32 activations, 2 microbatches) on the card and
    on the CPU: metrics at 1e-5, params and moments within 1e-4 of each
    leaf's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import make_opt_state, make_train_step
    run = _tiny_run(dtype="float32")
    out = {}
    for device in ("cpu", "cuda"):
        params, batch = _tiny_params_and_batch(run, device)
        state = make_opt_state(run, params)
        params, state, metrics = make_train_step(run)(params, state, batch)
        out[device] = (metrics, [t.cpu() for t in tree_leaves(
            [params, state["m"], state["v"]])])
    for k, want in out["cpu"][0].items():
        np.testing.assert_allclose(float(out["cuda"][0][k]), float(want),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.gpu
def test_eval_step_runs_flash_and_train_step_refuses_it():
    """Under ``attention_impl="pallas"`` the eval step launches the flash
    kernel once a layer; the train step raises through the grad guard."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import make_eval_step, make_opt_state, \
        make_train_step
    run = _tiny_run(attention_impl="pallas")
    params, batch = _tiny_params_and_batch(run, "cuda")
    launches = tfa.flash_attention.launches
    metrics = make_eval_step(run)(params, batch)
    assert tfa.flash_attention.launches == launches + run.model.num_layers
    assert bool(torch.isfinite(metrics["ce"]))
    state = make_opt_state(run, params)
    with pytest.raises(RuntimeError, match="no backward"):
        make_train_step(run)(params, state, batch)
    assert all(not p.requires_grad for p in tree_leaves(params))


def _tiny_fabric(root):
    from repro_torch.core import Fabric, FabricSpec
    from repro_torch.data import SyntheticCorpus
    s = Fabric(FabricSpec.star(str(root / "h"), str(root / "s"))).login("sci")
    SyntheticCorpus(s.client, "home/data", seed=0, vocab=512,
                    shard_tokens=1000).materialize(2)
    return s


def _tiny_pipeline(s, run, device):
    from repro_torch.data import DataPipeline
    return DataPipeline(s.client, "home/data", run.model, batch=4, seq=32,
                        n_shards=2, device=device)


@pytest.mark.gpu
def test_pipeline_batches_on_card_equal_cpu(tmp_path):
    """The same shards give the same batches on the card as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run = _tiny_run()
    s = _tiny_fabric(tmp_path)
    card, host = _tiny_pipeline(s, run, "cuda"), _tiny_pipeline(s, run, "cpu")
    for _ in range(20):                       # 20 x 129 tokens: two wraps
        got, want = card.next_batch(), host.next_batch()
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].is_cuda and got[k].dtype == v.dtype == torch.int32
            assert torch.equal(got[k].cpu(), v), k
    assert card.state() == host.state()


@pytest.mark.gpu
def test_trainer_on_card_restores_as_a_cold_restore(tmp_path):
    """A tiny Trainer on the card saves at step 2 and crashes at step 3; the
    state it restores equals, bit for bit and with the data cursor, what a
    fresh trainer restores cold at that moment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import FaultEvent, FaultMonitor, Trainer
    run = _tiny_run()
    s = _tiny_fabric(tmp_path)
    mon = FaultMonitor(n_workers=2, schedule=[
        FaultEvent(step=3, worker=1, kind="crash")])
    tr = Trainer(run, _tiny_pipeline(s, run, "cuda"),
                 CheckpointManager(s.client, "home/ckpt"), monitor=mon,
                 ckpt_every=2, device="cuda")
    seen = {}
    restore = tr.restore_latest

    def restoring():
        ok = restore()
        seen["restored"] = (tr.step, tr.pipeline.state(), {
            k: t.clone() for k, t in _by_path(tr._state_tree()).items()})
        cold = Trainer(run, _tiny_pipeline(s, run, "cuda"), tr.ckpt,
                       device="cuda")
        cold.initialize()
        assert cold.restore_latest()
        seen["cold"] = (cold.step, cold.pipeline.state(),
                        _by_path(cold._state_tree()))
        return ok

    tr.restore_latest = restoring
    res = tr.train(4)
    assert res.restarts == 1 and res.checkpoints == [2, 4]
    assert all(np.isfinite(res.losses))
    step, cursor, state = seen["restored"]
    cstep, ccursor, cstate = seen["cold"]
    assert step == cstep == 2 and cursor == ccursor == {"cursor": 2 * 129}
    assert sorted(state) == sorted(cstate)
    for k, t in cstate.items():
        assert t.is_cuda and t.dtype == state[k].dtype
        assert torch.equal(state[k], t), k


def _by_path(tree, path=()):
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items()
                for p, t in _by_path(v, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: t for i, v in enumerate(tree)
                for p, t in _by_path(v, path + (i,)).items()}
    return {path: tree}
