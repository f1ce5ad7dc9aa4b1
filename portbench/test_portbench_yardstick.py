"""The frozen yardstick against hand counts: bounds, model FLOPs, kernel
names (CPU only)."""
from __future__ import annotations

import pytest

from portbench import flops
from portbench import harness as H


@pytest.mark.parametrize("Sq,Skv,off", [(4, 4, 0), (3, 7, 4), (5, 3, 0),
                                        (1, 9, 8), (6, 6, 2), (2, 5, -1)])
def test_causal_pairs_counts_the_visible_keys(Sq, Skv, off):
    want = sum(min(Skv, max(0, off + i + 1)) for i in range(Sq))
    assert flops.causal_pairs(Sq, Skv, off) == want


def test_attention_bound_by_hand():
    # 1 x 2 heads (1 kv head) x 4 x 4, D 8, causal: 10 pairs a head
    ms, by = flops.attention_bound(1, 2, 1, 4, 4, 8, True, 0, "bfloat16")
    flop = 4 * 8 * 10 * 2                      # 640
    nbytes = 2 * 8 * (2 * 2 * 4 + 2 * 1 * 4)   # 384
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert flop / 989e12 < nbytes / 3.35e12


def test_wkv_bound_by_hand():
    ms, by = flops.wkv_bound(4, 40, 2048, 64)
    flop = 4 * 40 * 2048 * (5 * 64 * 64 + 5 * 64)
    nbytes = 4 * (5 * 4 * 40 * 2048 * 64 + 40 * 64)
    assert by == "bytes"
    assert ms == pytest.approx(max(flop / 67e12, nbytes / 3.35e12) * 1e3)


def test_gmm_bound_counts_kept_rows_not_slots():
    # 55,000 kept rows of 128 x 641 slots, 2048 -> 768, bf16
    ms, by = flops.gmm_bound(55_000, 128, 2048, 768, "bfloat16")
    flop = 2 * 55_000 * 2048 * 768
    nbytes = 2 * (55_000 * (2048 + 768) + 128 * 2048 * 768)
    assert by == "bytes"                       # the weights: 403 MB
    assert ms == pytest.approx(max(flop / 989e12, nbytes / 3.35e12) * 1e3)
    full, _ = flops.gmm_bound(128 * 641, 128, 2048, 768, "bfloat16")
    assert ms < full


def test_model_flops_by_hand():
    q = H.load_json(H.HERE / "configs" / "qwen3-moe-30b-a3b.json")["model"]
    layer = (2 * 2048 * (4096 + 2 * 512) + 2 * 4096 * 2048   # projections
             + 4 * 4096 * 2049 / 2                            # QK^T, PV
             + 2 * 2048 * 128                                 # router
             + 2 * 3 * 2048 * 768 * 8)                        # 8 experts
    assert flops.model_flops_per_token(q, 2048) == pytest.approx(
        48 * layer + 2 * 2048 * 151936)
    assert flops.model_flops_per_token(q, 2048) == pytest.approx(
        6_889_013_248)
    r = H.load_json(H.HERE / "configs" / "rwkv6-3b.json")["model"]
    layer = (2 * 5 * 2560 ** 2 + 2 * 2 * 2560 * 160 + 2 * 2 * 2560 * 64
             + 40 * (5 * 64 * 64 + 5 * 64)
             + 2 * (2 * 2560 * 8960 + 2560 ** 2))
    assert flops.model_flops_per_token(r, 4096) == pytest.approx(
        32 * layer + 2 * 2560 * 65536)
    assert flops.model_flops_per_token(r, 4096) == pytest.approx(
        5_888_163_840)


def test_mamba_bound_by_hand():
    # the scan of the cut Jamba2-Mini's Mamba layer: 2 x 16384 tokens,
    # di 8192, N 16
    ms, by = flops.mamba_bound(2, 16384, 8192, 16)
    exps = 2 * 16384 * 8192 * 16                     # 4,294,967,296
    nbytes = 4 * (3 * 2 * 16384 * 8192 + 2 * 2 * 16384 * 16 + 8192 * 16)
    t_exp = exps / (16 * 132 * 1.98e9)               # 1.027 ms
    assert by == "operations"
    assert ms == pytest.approx(t_exp * 1e3)
    assert t_exp > 6 * exps / 67e12 and t_exp > nbytes / 3.35e12
    assert flops.mamba_bound(4, 2048, 16384, 16)[0] == pytest.approx(
        0.51354, abs=1e-5)                           # chip_smoke's case
    ms, by = flops.mamba_bound(1, 8, 8192, 1)        # one state: bytes
    assert by == "bytes" and ms == pytest.approx(
        4 * (3 * 8 * 8192 + 2 * 8 + 8192) / 3.35e12 * 1e3)


def test_hybrid_model_flops_by_hand():
    from portbench.test_portbench_configs import JAMBA2_MINI_CUT as j
    d, di, N, R, S = 4096, 8192, 16, 256, 16384
    attn = 2 * d * (4096 + 2 * 1024) + 2 * 4096 * d + 4 * 4096 * (S + 1) / 2
    mamba = (2 * d * 2 * di + 2 * di * (R + 2 * N) + 2 * R * di
             + 2 * di * d + 6 * di * N)
    moe = 2 * d * 16 + 2 * 3 * d * 14336 * 2
    mlp = 2 * 3 * d * 14336
    # 2 superblocks: positions 0-7, attention at 4, experts on odd ones
    want = 2 * (attn + 7 * mamba + 4 * moe + 4 * mlp) + 2 * d * 65536
    assert flops.model_flops_per_token(j, S) == pytest.approx(want)
    assert flops.model_flops_per_token(j, S) == pytest.approx(
        12_384_223_232)
    assert list(flops.hybrid_layers(j))[:8] == [
        ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"),
        ("mamba", "moe"), ("attn", "mlp"), ("mamba", "moe"),
        ("mamba", "mlp"), ("mamba", "moe")]
    dense = dict(j, moe={"num_experts": 0})          # no experts: MLPs
    assert flops.model_flops_per_token(dense, S) == pytest.approx(
        2 * (attn + 7 * mamba + 8 * mlp) + 2 * d * 65536)


@pytest.mark.parametrize("name,want", [
    ("(anonymous namespace)::gmm_wgmma_kernel(CUtensorMap_st, int)", "gmm"),
    ("void (anonymous namespace)::wkv6_chunk<64>(float const*)",
     "rwkv6_scan"),
    ("void flash_wgmma_kernel<128>(int)", "flash_attention"),
    ("void flash_fwd_kernel<true>(...)", "other"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", None),
])
def test_port_kernel_by_symbol(name, want):
    assert flops.port_kernel(name) == want
