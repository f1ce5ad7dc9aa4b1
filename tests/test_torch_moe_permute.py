"""The MoE dispatch and combine's plain versions (``kernels/moe_permute.py``)
against the formulations of ``models/moe.py``'s ``"xla"`` path, on the CPU.

Routes come from the layer's own ``_slots`` on random tokens and a router
skewed towards a few experts, at capacity factors 0.25 (heavy drops),
1.25 (the scoring cell's) and 8.0 (no drops).  The dispatch equals the
tokens repeated k times and ``index_add_``-ed into a zeroed buffer, outside
the parking slot, which holds zeros; the combine equals the gather, the
weight and the sum over k, within one ulp of the dtype (the sum's order
in f32 is the only freedom).  Both formulations are the layer's own
(``index_add_dispatch``, ``gather_combine``).  The CUDA kernels are held
to these plain versions on the card (``tests/test_torch_kernels_gpu.py``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch import tracing
from repro_torch.configs import get_tiny_config
from repro_torch.kernels import moe_permute as mp
from repro_torch.kernels import ops as kops
from repro_torch.models import moe as tmoe


@dataclasses.dataclass
class _Moe:
    num_experts: int = 16
    experts_per_token: int = 4
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True


def _routes(T, cf, dtype, d=24, seed=0):
    """(x [T,d], ids, pos [T,k], gate_w [T,k], E, C) of one random route."""
    m = _Moe(capacity_factor=cf)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(T, d, generator=gen)
    router = torch.randn(d, m.num_experts, generator=gen)
    router[:, :3] += 0.5                        # a few experts overflow
    C = tmoe._capacity(m, T)
    ids, pos, _, gate_w, _ = tmoe._slots(m, router, x, C)
    k = m.experts_per_token
    return (x.to(dtype), ids.view(T, k), pos.view(T, k), gate_w,
            m.num_experts, C)


def _index_add_dispatch(x, ids, pos, E, C):
    """``models/moe.py``'s ``"xla"`` dispatch on [T, k] routes."""
    return tmoe.index_add_dispatch(x, ids.reshape(-1), pos.reshape(-1), E, C)


def _gather_combine(ye, ids, pos, gate_w):
    """``models/moe.py``'s ``"xla"`` combine on [T, k] routes."""
    keep = (pos < ye.shape[1] - 1).reshape(-1)
    return tmoe.gather_combine(ye, ids.reshape(-1), pos.reshape(-1), keep,
                               gate_w)


def _ulps(got, want):
    """The widest gap in units of the dtype's last place at the larger of
    the two magnitudes (0 where both are 0)."""
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs())
    tiny = torch.finfo(got.dtype).tiny
    ulp = torch.finfo(got.dtype).eps * torch.exp2(
        torch.floor(torch.log2(mag.clamp(min=tiny))))
    return float(((g - w).abs() / ulp).max()) if got.numel() else 0.0


CASES = [(T, cf) for T in (1, 7, 64, 300) for cf in (0.25, 1.25, 8.0)]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("T,cf", CASES)
def test_plain_dispatch_is_index_add_outside_the_parking_slot(T, cf, dtype):
    x, ids, pos, _, E, C = _routes(T, cf, dtype, seed=T)
    got = mp.moe_dispatch_plain(x, ids, pos, E, C)
    want = _index_add_dispatch(x, ids, pos, E, C)
    assert got.shape == (E, C + 1, x.shape[1]) and got.dtype == dtype
    assert torch.equal(got[:, :C], want[:, :C])
    assert not got[:, C].any()                  # the parking slot: zeros
    kept = int((pos < C).sum())
    assert int(got[:, :C].abs().sum(-1).ne(0).sum()) == kept
    if cf == 8.0:
        assert kept == ids.numel()              # nothing dropped
    if cf == 0.25 and T >= 64:
        assert kept < ids.numel() // 2          # most dropped


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("T,cf", CASES)
def test_plain_combine_is_gather_weight_and_sum(T, cf, dtype):
    """On any buffer, the parking slot's rows too: a dropped assignment
    adds 0 on both."""
    _, ids, pos, gate_w, E, C = _routes(T, cf, dtype, seed=T + 1)
    gen = torch.Generator().manual_seed(T)
    ye = torch.randn(E, C + 1, 24, generator=gen).to(dtype)
    got = mp.moe_combine_plain(ye, ids, pos, gate_w)
    want = _gather_combine(ye, ids, pos, gate_w)
    assert got.shape == (T, 24) and got.dtype == dtype
    assert _ulps(got, want) <= 1.0
    dropped = (pos >= C).all(dim=1)             # tokens with nothing kept
    assert not got[dropped].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
def test_plain_dispatch_then_combine_is_the_xla_layer(cf, dtype):
    """The two plain versions around an elementwise expert, against the
    ``"xla"`` dispatch and combine around the same expert: the parking
    slot differs and is weighted 0."""
    x, ids, pos, gate_w, E, C = _routes(96, cf, dtype, seed=5)
    expert = lambda xe: torch.tanh(xe.float()).to(dtype)
    got = mp.moe_combine_plain(expert(mp.moe_dispatch_plain(x, ids, pos,
                                                            E, C)),
                               ids, pos, gate_w)
    want = _gather_combine(expert(_index_add_dispatch(x, ids, pos, E, C)),
                           ids, pos, gate_w)
    assert _ulps(got, want) <= 1.0


@pytest.mark.parametrize("name", ["moe_dispatch", "moe_combine"])
def test_ops_take_the_plain_version_on_the_cpu(name):
    x, ids, pos, gate_w, E, C = _routes(40, 1.25, torch.bfloat16, seed=9)
    launches = getattr(mp, name).launches
    if name == "moe_dispatch":
        got = kops.moe_dispatch(x, ids, pos, E, C)
        want = mp.moe_dispatch_plain(x, ids, pos, E, C)
    else:
        ye = torch.randn(E, C + 1, x.shape[1]).bfloat16()
        got = kops.moe_combine(ye, ids, pos, gate_w)
        want = mp.moe_combine_plain(ye, ids, pos, gate_w)
    assert torch.equal(got, want)
    assert getattr(mp, name).launches == launches   # counts CUDA only


def test_wrappers_refuse_another_device():
    x, ids, pos, gate_w, E, C = _routes(8, 1.25, torch.float32)
    with pytest.raises(ValueError, match="cpu or cuda"):
        mp.moe_dispatch(x.to("meta"), ids, pos, E, C)
    with pytest.raises(ValueError, match="cpu or cuda"):
        mp.moe_combine(torch.zeros(E, C + 1, 24, device="meta"), ids, pos,
                       gate_w)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_permute_kernel_counts_zero_on_the_cpu(impl):
    """The kernels' ``launches`` count CUDA launches: none on the CPU, where
    ``"pallas"`` takes the plain versions inside the same spans."""
    cfg = get_tiny_config("qwen3-moe-30b-a3b").replace(
        dtype="float32", param_dtype="float32", scan_impl=impl)
    gen = torch.Generator().manual_seed(3)
    p = tmoe.moe_init(cfg, gen, torch.device("cpu"))
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    launches = (mp.moe_dispatch.launches, mp.moe_combine.launches)
    was = tracing.enabled()
    tracing.clear()
    tracing.enable()
    try:
        with tracing.unit("u"):
            tmoe.moe_apply(cfg, p, x)
        t = tracing.totals()
    finally:
        (tracing.enable if was else tracing.disable)()
        tracing.clear()
    assert t["spans"]["moe.dispatch"]["calls"] == 1
    assert t["spans"]["moe.combine"]["calls"] == 1
    assert (mp.moe_dispatch.launches, mp.moe_combine.launches) == launches
