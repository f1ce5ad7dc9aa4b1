"""The sharded runs on the card: four ``gloo`` ranks sharing card 0 (CUDA
tensors; ``gloo`` stages its collectives through the host), at tiny width,
each held to the same run on one device on the card:

- (a) qwen3-4b ``fsdp`` train step on (data 2, model 2), f32 on the
  ``xla`` paths: the loss within 1e-5, the moments within 1e-4 of each
  leaf's scale;
- (b) qwen3-8b ``baseline`` prefill and 3 greedy decode ticks with flash
  (``attention_impl="pallas"``) on each rank's local heads, f32 (the
  kernel's ``f32`` route, one launch a layer a rank in the prefill):
  logits within 1e-4 of their scale, the same tokens;
- (c) qwen3-moe ``fsdp`` loss with flash and ``gmm`` on each rank's local
  experts (``scan_impl="pallas"``, f32: 3 ``mma_sync`` launches a layer a
  rank) within 1e-5 of the plain single-device loss;
- (d) seamless-m4t-medium (2 + 2 layers) ``fsdp`` train step with 2
  microbatches (the reference's global row blocks: the frontend moves by
  an all-to-all), f32, held as (a), and its ``baseline`` prefill and 3
  ticks with flash (6 ``f32`` launches a rank in the prefill: encoder,
  decoder self, cross), held as (b); (e) qwen2-vl-72b's ``baseline``
  prefill (patches, then text; M-RoPE positions [3, B, S]) and 3 ticks
  with flash, held as (b); (f) rwkv6-3b (2 heads of 32: the WKV6 kernel
  takes D 32 or 64) and jamba (one superblock with experts) ``fsdp``
  losses with the scan kernels on each rank's heads and ``inner``
  channels (2 WKV6 launches a rank; 7 selective-scan and 1 flash ``f32``
  launches a rank) within 1e-5, and jamba's decode under the ``shard_seq``
  rules (the K/V rows split over data, the ticks crossing the blocks'
  boundary) held as (b), its prefill through the same 7 + 1 launches.

Skips without a CUDA card.  On the card (no JAX needed):

    python -m pytest -m gpu tests/test_torch_sharded_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import _torch_dist as D
import _torch_sharded_ranks as R
from repro_torch.configs import get_tiny_config

MESH = (2, 2)
B, S, PROMPT, MAX_LEN, TICKS = 4, 16, 8, 16, 3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import _build
    for name in ("flash_attention", "gmm", "rwkv6_scan", "mamba_scan"):
        _build.load(name)        # built once, before the ranks load it


def _scaled(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _batch(cfg, b, s, seed, targets=True):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    out = {"tokens": toks[:, :-1].contiguous(),
           "positions": torch.arange(s).expand(b, s).contiguous()}
    if targets:
        out["targets"] = toks[:, 1:].contiguous()
    return out


def _params(cfg):
    from repro_torch.models import init_params
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _on(tree, device):
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda t: t.to(device), tree)


@pytest.mark.gpu
def test_sharded_train_step_on_the_card(tmp_path):
    _card()
    from repro_torch.config import RunConfig, ShapeConfig, ShardingConfig
    from repro_torch.models import loss_fn
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import make_opt_state, make_train_step
    cfg = get_tiny_config("qwen3-4b").replace(dtype="float32")
    params, batch = _params(cfg), _batch(cfg, B, S, 1)
    ranks = D.run_ranks(R.train_step_rank, 4, tmp_path, "cuda", cfg, MESH,
                        params, batch)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", S, B),
                    sharding=ShardingConfig(policy="fsdp"))
    p, b = _on(params, "cuda"), _on(batch, "cuda")
    with torch.no_grad():
        loss = float(loss_fn(cfg, p, b)[0])
    opt = make_opt_state(run, p)
    make_train_step(run)(p, opt, b)
    for r in ranks:
        assert abs(float(r["loss"]) - loss) <= 1e-5 * abs(loss)
        assert r["in_place"] and r["kept"]
        for mom in ("m", "v"):
            for got, want in zip(tree_leaves(r[mom]), tree_leaves(opt[mom])):
                assert _scaled(got, want.cpu()) <= 1e-4, mom


@pytest.mark.gpu
def test_sharded_decode_with_flash_on_the_card(tmp_path):
    _card()
    from repro_torch.models import decode_step, prefill
    cfg = get_tiny_config("qwen3-8b").replace(dtype="float32",
                                              attention_impl="pallas")
    params = _params(cfg)
    prompt = _batch(cfg, B, PROMPT, 2, targets=False)
    ranks = D.run_ranks(R.decode_rank, 4, tmp_path, "cuda", cfg, MESH,
                        params, prompt, MAX_LEN, TICKS)
    p, b = _on(params, "cuda"), _on(prompt, "cuda")
    want = []
    with torch.no_grad():
        lg, cache = prefill(cfg, p, b, MAX_LEN)
        for _ in range(TICKS):
            want.append(lg.cpu())
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            lg, cache = decode_step(cfg, p, tok, cache)
        want.append(lg.cpu())
    for r in ranks:
        assert r["prefill_launches"]["flash"]["f32"] == cfg.num_layers
        for got, w in zip(r["logits"], want):
            assert _scaled(got, w) <= 1e-4
        assert [t.flatten().tolist() for t in r["tokens"]] == \
            [w[:, -1].argmax(-1).tolist() for w in want[:-1]]


@pytest.mark.gpu
def test_sharded_moe_loss_with_gmm_on_the_card(tmp_path):
    _card()
    from repro_torch.models import loss_fn
    cfg = get_tiny_config("qwen3-moe-30b-a3b").replace(dtype="float32")
    params, batch = _params(cfg), _batch(cfg, B, S, 3)
    kern = cfg.replace(attention_impl="pallas", scan_impl="pallas")
    ranks = D.run_ranks(R.loss_rank, 4, tmp_path, "cuda", {"pallas": kern},
                        MESH, params, batch)
    with torch.no_grad():
        want = float(loss_fn(cfg, _on(params, "cuda"),
                             _on(batch, "cuda"))[0])
    for r in ranks:
        got = r["pallas"]
        assert abs(float(got["loss"]) - want) <= 1e-5 * abs(want)
        assert got["launches"]["gmm"]["mma_sync"] == 3 * cfg.num_layers
        assert got["launches"]["flash"]["f32"] == cfg.num_layers


@pytest.mark.gpu
def test_sharded_encdec_and_vlm_on_the_card(tmp_path):
    _card()
    from repro_torch.config import RunConfig, ShapeConfig, ShardingConfig
    from repro_torch.data import make_batch
    from repro_torch.models import decode_step, loss_fn, prefill
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import make_opt_state, make_train_step
    seam = get_tiny_config("seamless-m4t-medium").replace(dtype="float32")
    vlm = get_tiny_config("qwen2-vl-72b").replace(dtype="float32")
    cfgs = {"encdec": seam, "vlm": vlm}
    params = {k: _params(c) for k, c in cfgs.items()}
    batch = make_batch(seam, B, S, torch.Generator().manual_seed(1), "cpu")
    prompts = {k: {n: t for n, t in make_batch(
        c, B, S if k == "encdec" else PROMPT,
        torch.Generator().manual_seed(2), "cpu").items() if n != "targets"}
        for k, c in cfgs.items()}
    prompts["encdec"]["tokens"] = prompts["encdec"]["tokens"][:, :PROMPT]
    prompts["encdec"]["positions"] = prompts["encdec"]["positions"][
        :, :PROMPT]
    flash = {k: c.replace(attention_impl="pallas") for k, c in cfgs.items()}
    jobs = {"train": (R.train_step_rank, ("cuda", seam, MESH,
                                          params["encdec"], batch, 2))}
    for k, c in flash.items():
        jobs[k] = (R.decode_rank, ("cuda", c, MESH, params[k], prompts[k],
                                   MAX_LEN, TICKS))
    ranks = D.run_ranks(R.jobs_rank, 4, tmp_path, jobs)
    run = RunConfig(model=seam, shape=ShapeConfig("t", "train", S, B),
                    sharding=ShardingConfig(policy="fsdp"), microbatches=2)
    p, b = _on(params["encdec"], "cuda"), _on(batch, "cuda")
    with torch.no_grad():
        loss = float(loss_fn(seam, p, b)[0])
    opt = make_opt_state(run, p)
    _, _, metrics = make_train_step(run)(p, opt, b)
    want = {}
    for k, c in flash.items():
        steps = []
        with torch.no_grad():
            lg, cache = prefill(c, _on(params[k], "cuda"),
                                _on(prompts[k], "cuda"), MAX_LEN)
            for _ in range(TICKS):
                steps.append(lg.cpu())
                tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                lg, cache = decode_step(c, _on(params[k], "cuda"), tok,
                                        cache)
            steps.append(lg.cpu())
        want[k] = steps
    for r in ranks:
        t = r["train"]
        assert abs(float(t["loss"]) - loss) <= 1e-5 * abs(loss)
        for k in ("loss", "grad_norm", "ce", "z"):
            assert abs(float(t["metrics"][k]) - float(metrics[k])) <= \
                1e-5 * abs(float(metrics[k])), k
        for mom in ("m", "v"):
            for got, w in zip(tree_leaves(t[mom]), tree_leaves(opt[mom])):
                assert _scaled(got, w.cpu()) <= 1e-4, mom
        for k, c in flash.items():
            layers = c.encoder_layers + 2 * c.decoder_layers \
                if k == "encdec" else c.num_layers
            assert r[k]["prefill_launches"]["flash"]["f32"] == layers
            for got, w in zip(r[k]["logits"], want[k]):
                assert _scaled(got, w) <= 1e-4
            assert [t.flatten().tolist() for t in r[k]["tokens"]] == \
                [w[:, -1].argmax(-1).tolist() for w in want[k][:-1]]


@pytest.mark.gpu
def test_sharded_rwkv6_and_hybrid_scans_on_the_card(tmp_path):
    _card()
    import dataclasses
    from repro_torch.models import decode_step, loss_fn, prefill
    rwkv = get_tiny_config("rwkv6-3b")
    rwkv = rwkv.replace(rwkv=dataclasses.replace(rwkv.rwkv, head_dim=32),
                        num_heads=2, num_kv_heads=2, head_dim=32)
    cfgs = {"rwkv": rwkv, "hybrid": get_tiny_config("jamba-1.5-large-398b")}
    cfgs = {k: c.replace(dtype="float32", attention_impl="pallas",
                         scan_impl="pallas") for k, c in cfgs.items()}
    params = {k: _params(c) for k, c in cfgs.items()}
    batch = _batch(cfgs["rwkv"], B, S, 4)
    prompt = _batch(cfgs["hybrid"], 2, 6, 5, targets=False)
    jobs = {k: (R.loss_rank, ("cuda", {k: c}, MESH, params[k], batch))
            for k, c in cfgs.items()}
    jobs["seq"] = (R.decode_rank, ("cuda", cfgs["hybrid"], MESH,
                                   params["hybrid"], prompt, MAX_LEN, 4,
                                   "fsdp", True))
    ranks = D.run_ranks(R.jobs_rank, 4, tmp_path, jobs)
    want, steps = {}, []
    with torch.no_grad():
        for k, c in cfgs.items():
            want[k] = float(loss_fn(c, _on(params[k], "cuda"),
                                    _on(batch, "cuda"))[0])
        p = _on(params["hybrid"], "cuda")
        lg, cache = prefill(cfgs["hybrid"], p, _on(prompt, "cuda"), MAX_LEN)
        for _ in range(4):
            steps.append(lg.cpu())
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            lg, cache = decode_step(cfgs["hybrid"], p, tok, cache)
        steps.append(lg.cpu())
    for r in ranks:
        for k in cfgs:
            got = r[k][k]
            assert abs(float(got["loss"]) - want[k]) <= 1e-5 * abs(want[k])
        assert r["rwkv"]["rwkv"]["launches"]["wkv"] == rwkv.num_layers
        hy = r["hybrid"]["hybrid"]["launches"]
        assert hy["scan"] == 7 and hy["flash"]["f32"] == 1
        seq = r["seq"]
        assert seq["kept"] and seq["prefill_launches"]["scan"] == 7
        assert seq["prefill_launches"]["flash"]["f32"] == 1
        for got, w in zip(seq["logits"], steps):
            assert _scaled(got, w) <= 1e-4
