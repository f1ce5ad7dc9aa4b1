#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. card    - requires CUDA; prints the card's name and power limit;
  2. build   - compiles every kernel (flash_attention.cu, rwkv6_scan.cu,
               mamba_scan.cu, gmm.cu) from the sources in this checkout,
               one nvcc each, in parallel (sm_90a); prints build times and
               ptxas registers and spills;
  3. kernel  - holds each kernel against its plain PyTorch version at the
               main paths' shapes and times kernel, plain version, the
               library call where one exists (a yardstick only; the port
               never calls it) and the bound; flash and gmm check each
               launch's route, and on their wgmma routes time the mma.sync
               kernel beside it (``prior_ms``); flash's inputs are model-
               layout views, and SDPA is timed masked and, where it is the
               same function, ``is_causal``; flash also at
               seamless-m4t-medium's non-causal shapes (the encoder,
               Sq != Skv, ragged, one query row in bf16 and f32, where
               SDPA unmasked is the same function); WKV6's two launches
               (zeroing the flags, the kernel) are also timed apart; the
               selective scan's final state is checked beside y, each case
               names its states a thread and B = 1 is timed beside B = 4;
               then each kernel wrapper must raise on an input that
               requires grad under grad mode;
  4. serve   - full-width qwen3-8b (bf16, seeded random weights) behind
               ServeEngine: 8 requests, 4 slots; checks the flash kernel's
               launch count (all on the wgmma route), finite logits, and
               the prefill logits against the plain-attention path of the
               same model (in f32 activations, on the f32 route; the bf16
               distances are printed); then profiles one decode tick and
               one tick with a 2048-token prefill; then the launcher
               ``serve --tiny`` for qwen3-8b, dbrx-132b and jamba (head dim
               16: the flash kernel's mma.sync route);
  4b. checkpoint - full-width qwen3-4b at 8 of its 36 layers (bf16, seed
               0; the depth cut keeps the phase's time down) through
               the launcher's fabric path (``launch/serve.py``
               ``restore_over_fabric``): seeded params on the card, saved
               through ``CheckpointManager`` into the home store of a
               two-site XUFS fabric in a temp dir, synced, restored onto
               the card; every restored leaf equal bit for bit to its
               original; the first 4 prompts of the qwen3-8b traffic
               served from the restored and from the original params give
               the same greedy tokens, the restored run's prefill on flash
               (8 ``wgmma`` launches a request); then qwen3-4b at 2
               layers (f32 params, int8 moments) after one train step:
               saved, stepped again in place, restored, and the saved
               values back bit for bit, its save, sync and restore under
               cProfile (the top functions by host seconds); prints the
               checkpoint bytes, host seconds and GB/s of save, sync and
               restore, their modeled WAN seconds and the free disk before
               the phase (the fabric keeps ~3 copies: client cache, WAL
               shadow, home store);
 5. forward - full-width, full-depth rwkv6-3b (bf16, seed 0,
               scan_impl="pallas") over 4 x 2048 seeded tokens through
               forward and loss_fn: 32 WKV6 kernel launches each, finite
               logits and loss, the kernel path against the plain chunked
               path in f32 activations (bf16 distances printed), and
               prefill + decode against forward on a 777-token prompt;
  6. serve   - rwkv6-3b behind ServeEngine: 8 requests, 4 slots, 32 new
               tokens; every request completes with finite logits; prefill
               takes the state-returning chunked path, so the kernel runs
               0 times, as in the reference;
  7. forward - full-width jamba-1.5-large-398b without experts (moe=None;
               16 of its 72 layers, bf16, seed 0, scan_impl="pallas") over
               4 x 2048 seeded tokens through forward and loss_fn: 14
               selective-scan and 2 flash (wgmma) launches each, finite
               logits and loss, the bf16 distance to the plain scan path
               printed;
  8. serve   - the same model behind ServeEngine with the qwen3-8b traffic:
               14 scan launches (the kernel returns the final state) and 2
               flash launches a prefill, every admitted slot's cache equal
               bit for bit to its one-request prefill cache; a profiled
               tick with a 2048-token prefill;
  9. f32     - the same model at 8 layers in f32 (16 do not fit): the
               kernel path against the plain scan path within 1e-3 of the
               logits' scale, and prefill (through the kernel's final
               state) + decode against forward;
 10. forward - full-width, full-depth qwen3-moe-30b-a3b (48 layers, 128
               experts, top-8, bf16, seed 0, attention_impl and scan_impl
               "pallas") over 4 x 2048 seeded tokens through forward and
               loss_fn: 144 gmm and 48 flash launches each, finite logits
               and loss, the bf16 distance to the plain path (einsum and
               plain attention) printed; every gmm and flash launch on its
               wgmma route;
 11. serve   - the same model behind ServeEngine with the qwen3-8b
               traffic: 144 gmm launches (wgmma route) a prefill and a
               decode tick, 48 flash launches a prefill;
 12. f32     - the same model at 4 layers in f32: the kernel path (gmm +
               flash) against the plain path within 1e-4 of the logits'
               scale, every routing difference between the two printed by
               layer and token, and prefill + decode against forward;
 13. train   - full-width, full-depth qwen3-4b (36 layers, 4.4 B f32
               params, bf16 activations, seed 0) through make_train_step:
               4 steps of 2 x 2048 tokens in 2 microbatches, remat "full",
               int8 moments, attention_impl "xla" (the kernels have no
               backward); the loss finite and falling; ms a step (CUDA
               events over steps 2-4), tokens/s, the model-FLOPs share and
               the peak memory printed, and a profiled fifth step; then the
               eval step under attention_impl "pallas": 36 flash launches,
               all wgmma, its ce beside the plain path's;
 14. train   - the same model at 2 layers in f32 activations: one train
               step (fp32 moments, int8 gradient compression, 2
               microbatches) on the card and on the host's CPU, held
               within 1e-4 of each leaf's scale (the moments and the error
               feedback allowing one int8 code where the grads straddle a
               tie), and the eval step's ce on the f32 flash kernel
               against the plain path's at 1e-4;
 15. trainer - the Trainer loop (``train/loop.py``) over a two-site
               fabric in a temp dir (~36 GB free needed, removed at the
               end), qwen3-4b with the phase-13 setup, a Zipf corpus of 4
               shards at its vocab: (a) 12 of the 36 layers (a depth cut
               that keeps the smoke's time down), one warm-up step then 3
               timed steps through ``Trainer.train`` (host clock, synced;
               no save) beside 3 bare steps at that depth on the next
               batches, and the peak memory;
               (b) 2 layers, a straggle at step 1 and a crash at step 3,
               a save every 2 steps: restarts 1, dropped syncs 1,
               checkpoints [2, 4], and the batch read after the restore
               equal to the corpus at the step-2 cursor; every loop
               iteration's wall time and host seconds in next_batch, the
               step, pump, pump_callbacks, save and restore, the WAL ops
               pending before each pump, the checkpoint bytes, the modeled
               WAN seconds and the device memory a save adds; then the
               step-4 checkpoint drained 2 WAL ops a pump call, as the
               steps after a save drain it, each call timed; (c) a fresh
               Trainer restores cold: step 4, every leaf equal bit for bit,
               then the eval step on those params through the f32 flash
               kernel (2 launches) within 1e-4 of the plain path's ce; (d)
               ``python -m repro_torch.launch.train --tiny`` with a crash
               at step 6 in a subprocess: exit 0, restarts=1, the card's
               name printed, the last loss below the first;
 16. encdec  - full-width, full-depth seamless-m4t-medium (12 + 12
               layers, bf16, seed 0, attention_impl "pallas"): forward and
               loss_fn on 4 sequences of 1024 frames (frontend [4, 1024,
               1024]) and 1024 text tokens, 36 flash launches each (12
               encoder, 12 decoder self, 12 cross), all wgmma; prefill of
               64-token prompts after the frames (36 launches), then 32
               greedy decode ticks, 12 launches a tick, each with one
               query row (cross-attention against the cached frames); ms
               of each and a profiled tick; the f32 check at 2 + 2 layers
               (forward, prefill and 8 decode steps on the kernel path
               against the plain path within 1e-4 of the logits' scale,
               the greedy tokens equal); then 3 train steps at full depth
               on the plain path (f32 params, remat "full", int8 moments,
               2 x 1024 tokens), ms a step, peak memory and the losses;
 17. vlm     - full-width qwen2-vl-72b at 16 of its 80 layers (bf16, seed
               0, attention_impl "pallas"): forward and loss_fn on 2 x 2048
               positions (512 patches of 8192 features, then 1536 text
               tokens, M-RoPE positions [3, 2, 2048]), 16 flash launches
               each; prefill of one such sequence (index 2048), then 32
               decode ticks on [3, 1, 1] positions; the f32 check at 2
               layers as in phase 16;
 18. train --tiny - ``python -m repro_torch.launch.train --tiny`` for
               seamless-m4t-medium and qwen2-vl-72b on the card, each in
               its own process with a crash at step 6: exit 0, restarts=1;
 18b. quickstart - ``examples/quickstart_torch.py``'s ``main`` on the
               card (a two-site fabric, tiny qwen3-4b trained 20 steps
               through ``Trainer`` with a save every 10, 2 requests served
               on the plain attention path), then the same 2 requests
               served again from the trained weights with
               ``attention_impl="pallas"``: flash launches by route (head
               dim 16: ``mma_sync``), more than 0, and each prefill's
               logits within 1e-2 (relative RMS, bf16) of the plain run's;
               both runs' tokens printed (for a flipped token, each run's
               logit gap between its top two at that position); its loss
               line, WAN seconds, bytes shipped and wall seconds;
 19. ep      - dbrx-132b's MoE layer at full width (d 6144, 16 experts,
               top-4, d_ff 10,752, bf16, capacity factor 1.25) across 4
               ranks of a (data=1, model=4) mesh, ``parallel/ep_moe.py``
               ``ep_moe_apply``: 4 x 2048 tokens, 4 experts a rank, three
               all-to-alls and 3 gmm launches (wgmma) a rank a call; the
               ranks are spawned processes, one a card with nccl where
               there are 4 cards, else all on card 0 with gloo's
               collectives on CUDA tensors (it prints backend, world and
               cards); the weights and inputs are the parent's tensors,
               shared with the ranks; each rank's output against
               ``ep_moe_plain`` in f32 (relative RMS error within 1e-2),
               the kept assignments equal, CUDA-event ms of the layer, its
               all-to-alls and expert products, peak memory; an f32 case
               on a (data=2, model=2) mesh at width 256 and capacity
               factor 32 against ``ep_moe_plain`` and ``moe_apply`` (1e-5
               scaled); the gmm kernel at a rank's received rows, timed
               beside torch.bmm; a failed or hung rank fails the phase;
 20. sharded - every family on a (data 2, model 2) DeviceMesh
               (``parallel/``, DTensor), 4 ranks spawned as in phase 19
               (one card: all on card 0, gloo staging the collectives
               through the host; four cards: nccl, one a rank), in five
               rounds of rank processes ((a)-(c), (d), (e), (f), (g): the
               card holds one round's params at a time; each round's peak
               on the card printed), every sub-phase at full width and 2
               layers (2 + 2 for the enc-dec, one superblock of 8 for the
               hybrid), the params seeded in the parent and shared; first
               the four kernels at the local shapes the ranks give them,
               against their plain versions and timed; then, each
               held to the same run on one device on the card: (a)
               qwen3-4b ``fsdp`` train step, f32, 2 x 512 tokens, fp32 moments: the loss (1e-5)
               and every moment leaf after one step (1e-4 of its scale),
               the step's all-gathers and reduce-scatters (counts from
               ``CommDebugMode``, bytes from ``launch/op_analysis.py``),
               ms a step and peak GB a rank; (b) qwen3-8b ``baseline``
               prefill of 4 x 512-token prompts and 16 decode ticks with
               flash on each rank's 16 q / 4 kv heads, bf16 (2 ``wgmma``
               launches a rank; relative RMS 1e-2, fed the single-device
               tokens) and f32 (2 ``f32`` launches; 1e-4 scaled, its own
               greedy tokens equal), prefill ms and ms a tick; (c)
               qwen3-moe ``fsdp`` loss with flash and gmm on each rank's
               64 experts, bf16 (6 gmm and 2 flash ``wgmma`` launches a
               rank; 1e-2) and f32 (6 ``mma_sync``; 1e-5 of the plain
               loss, every layer's kept mask equal, any difference
               printed); (d) seamless-m4t-medium: an ``fsdp`` train step
               in f32 with 2 microbatches (the reference's global row
               blocks; 4 rows of 512 frames and 512 text tokens, targets
               masked unevenly) held to the one-device 2-microbatch step
               (loss, ce, z, aux 1e-5, grad norm 1e-5, the moments 1e-4
               of each leaf's scale), then ``baseline`` prefill of 4 x 1024
               frames with 64-token prompts and 16 greedy ticks, bf16 and
               f32, flash on each rank's 8 heads of 64: 6 launches a rank
               in the prefill (2 encoder, 2 decoder self, 2 cross) and 2
               a tick (cross, one query row), ``wgmma`` in bf16, ``f32``
               in f32, held as (b); (e) qwen2-vl-72b ``baseline`` (TP
               only: ``fsdp`` would gather ~1.8 GB of f32 weights a rank
               a layer a tick through the host) prefill of 4 sequences of
               128 patches of 8192 features and 384 text tokens, M-RoPE
               positions [3, 4, 512], and 16 greedy ticks, bf16 then f32,
               held as (b), flash on each rank's 32 q / 4 kv heads (2
               ``wgmma`` launches a rank in the bf16 prefill, 2 ``f32`` in
               the f32 one); (f) rwkv6-3b: an ``fsdp`` train step in f32
               with 2 microbatches (4 rows of 512 tokens, targets masked
               unevenly) held as (d), an ``fsdp`` bf16 loss through the
               WKV6 kernel on each rank's 20 of 40 heads (2 launches a
               rank; 1e-2), and ``baseline`` prefill of 4 x 512 and 16
               ticks held as (b) (the state-returning chunk path, no
               kernel launch); (g) jamba-1.5-large-398b without experts,
               one superblock, bf16, ``baseline``: the loss over 4 x 512
               tokens (7 selective-scan launches on each rank's 8192 of
               16384 inner channels and 1 flash ``wgmma`` launch a rank;
               1e-2; the all-to-all bytes of in_proj's column blocks),
               prefill of 4 x 512 (again 7 + 1) and 16 ticks held as (b),
               then decode on a sequence-sharded cache (the ``shard_seq``
               decode rules: batch whole, the K/V rows split over data):
               one 2040-token prompt, ``max_len`` 4096, 16 ticks fed the
               single-device tokens across row 2048, so both data ranks'
               blocks take writes: the logits (1e-2) and each rank's
               block of every cache entry against the single-device
               cache's slice (relative RMS 1e-2; the rows written equal);
               jamba's experts (4 x 9.66 B params a superblock) fit no
               card and are held on the CPU at tiny size, and so is its
               f32 parity (a superblock is 36 GB in f32); a failed or
               hung rank fails the phase;
(every serving run checks each admission's splice of every cache entry)
then prints a JSON line of kernel numbers and, last, the JSON result line.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores,
# f32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

ARCH = "qwen3-8b"
RWKV_ARCH = "rwkv6-3b"
RWKV_BATCH, RWKV_SEQ = 4, 2048
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_LAYERS = 16          # 2 superblocks: 33.8 GB of bf16 weights
JAMBA_F32_LAYERS = 8       # 1 superblock in f32: ~36 GB
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_BATCH = 4              # 4 x 2048 scoring tokens (61.1 GB of weights)
MOE_F32_LAYERS = 4         # 3.1 B params, 12.5 GB in f32
TRAIN_ARCH = "qwen3-4b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 2, 2048, 2
TRAIN_STEPS = 4
TRAIN_CHECK_LAYERS = 2     # card vs CPU: ~1 B params in f32
TRAINER_STEPS = 3          # timed Trainer steps, then as many bare ones
TRAINER_LAYERS = 12        # of qwen3-4b's 36, for those steps
TRAINER_SHARDS = 4         # corpus shards, as launch/train.py writes
CKPT_PROMPTS = 4           # the qwen3-8b traffic's first 4 prompts
CKPT_LAYERS = 8            # of qwen3-4b's 36: 3.2 GB of bf16 weights
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_BATCH, ENCDEC_SEQ = 4, 1024   # 1024 frames and 1024 text tokens each
ENCDEC_PROMPT = 64         # text tokens a prompt, after the 1024 frames
ENCDEC_TRAIN_STEPS = 3
VLM_ARCH = "qwen2-vl-72b"
VLM_LAYERS = 16            # of 80: 16.6 B params, 33 GB of bf16 weights
VLM_BATCH, VLM_SEQ = 2, 2048        # 512 patches + 1536 text tokens each
GMM_SWEEP = ([128, 128, 128, 128], [100, 0, 300, 112], [0, 0, 512, 0],
             [1, 2, 3, 506])   # tests/test_kernels.py::test_gmm_sweep
SFU_PER_CLOCK_PER_SM = 16  # exponentials (special-function units), sm_90
N_SMS = 132
PROMPT_LENS = (128, 256, 512, 777, 1024, 1500, 2048, 64)
MAX_NEW = 32
SLOTS = 4
MAX_LEN = 4096
SEED = 0
# the flash kernel against the plain version in f32 on the same inputs:
# limits on the relative RMS error (``rms_rel_err``)
RMS_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# (g): a sharded bf16 jamba run's error against the one-device f32 run, at
# most this times the one-device bf16 run's own (one superblock amplifies
# bf16 rounding to ~2.5e-2 between any two bf16 runs: PERF.md)
BF16_FLOOR = 1.25
EP_ARCH = "dbrx-132b"
EP_RANKS = 4               # a (data=1, model=4) mesh: 4 of 16 experts a rank
EP_BATCH = 4               # 4 x 2048 = 8192 tokens, dbrx's chunk_tokens
EP_SEQ = 2048
EP_F32_MESH = (2, 2)       # the f32 case's (data, model) mesh
EP_F32_WIDTH = (256, 512)  # its d_model and d_ff_expert
EP_F32_BATCH, EP_F32_SEQ = 4, 128
EP_F32_CF = 32.0           # capacity factor: no assignment dropped
EP_LIMIT = 300             # seconds the ranks may take, spawn to exit
SHARD_RANKS = 4            # phase 20: a (data 2, model 2) mesh
SHARD_MESH = (2, 2)
SHARD_LAYERS = 2           # every sub-phase at full width, 2 layers
SHARD_TRAIN_ARCH = "qwen3-4b"
SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ = 2, 512
SHARD_SERVE_ARCH = "qwen3-8b"
SHARD_PROMPTS, SHARD_PROMPT_LEN, SHARD_TICKS = 4, 512, 16
SHARD_MOE_ARCH = "qwen3-moe-30b-a3b"
SHARD_MOE_BATCH, SHARD_MOE_SEQ = 2, 512
SHARD_ENCDEC_ARCH = "seamless-m4t-medium"
SHARD_ENCDEC_BATCH, SHARD_ENCDEC_SEQ = 4, 512   # train: frames, text a row
SHARD_FRAMES, SHARD_ENCDEC_PROMPT = 1024, 64     # serving: frames, text
SHARD_VLM_ARCH = "qwen2-vl-72b"
SHARD_VLM_PROMPTS, SHARD_VLM_SEQ = 4, 512        # 128 patches + 384 text
SHARD_MICRO = 2            # (d)'s train step: the reference's microbatches
SHARD_RWKV_ARCH = "rwkv6-3b"
SHARD_RWKV_BATCH, SHARD_RWKV_SEQ = 4, 512       # (f): train, loss, serving
SHARD_JAMBA_LAYERS = 8     # (g): one superblock, 9.0 B params, 18 GB bf16
SHARD_JAMBA_BATCH, SHARD_JAMBA_SEQ = 4, 512     # (g): loss and serving
SHARD_SEQ_PROMPT, SHARD_SEQ_MAX_LEN = 2040, 4096  # (g): shard_seq decode
SHARD_LIMIT = 400          # seconds a round of phase 20's ranks may take
EP_PG_TIMEOUT = 120        # seconds a collective may wait for a peer


def card_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it ("1980 MHz")."""
    value, unit = card_line("clocks.max.sm").split()
    if unit != "MHz":
        raise ValueError(f"unexpected clock unit {unit!r}")
    return float(value) * 1e6


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(B, Hq, Hkv, Sq, Skv, D, causal, q_offset, dtype_name):
    """(bound ms, what bounds it): unmasked FLOPs vs bytes read + written."""
    if causal:
        pairs = sum(min(Skv, max(0, q_offset + i + 1)) for i in range(Sq))
    else:
        pairs = Sq * Skv
    flops = 4.0 * D * pairs * B * Hq          # QK^T and PV, 2 FLOP per MAC
    itemsize = 2 if dtype_name == "bfloat16" else 4
    nbytes = itemsize * D * (2 * B * Hq * Sq + 2 * B * Hkv * Skv)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rms_rel_err(torch, out, want32):
    """RMS of ``out - want32`` over the RMS of ``want32`` (in f32).

    Attention averages hundreds of standard normal values, so its outputs
    are small (~0.05 for a thousand keys) and an element-wise limit of
    2e-2 passes a kernel that shrinks or shifts every output by several
    percent (keys past the end left unmasked, a tail tile dropped).  This
    ratio is the output's relative error as a whole: bf16 rounding gives
    a few 1e-3, such faults several 1e-2."""
    ref = want32.float()
    return float(torch.linalg.vector_norm(out.float() - ref)
                 / torch.linalg.vector_norm(ref))


def kernel_cases(torch, fa):
    """Flash kernel vs plain version on the card; one dict per case.

    Inputs are [B,S,H,D] tensors handed to the wrapper as transposed
    views, as ``ops.flash_attention`` hands them over.  Each launch must
    take the route that ``fa.route`` names; where that is the wgmma route,
    ``prior_ms`` times the mma.sync kernel on the same inputs (the design
    it replaced on that route).  The masked SDPA call computes the same
    function for every case; ``is_causal`` SDPA only where q_offset = 0
    and Sq = Skv (it aligns the mask to the top left)."""
    import torch.nn.functional as F
    cases = []
    for s in (128, 1024, 2048, 777):
        cases.append(dict(B=1, Hq=32, Hkv=8, Sq=s, Skv=s, D=128, causal=True,
                          q_offset=0, dtype="bfloat16"))
    cases.append(dict(B=1, Hq=32, Hkv=8, Sq=128, Skv=384, D=128, causal=True,
                      q_offset=256, dtype="bfloat16"))
    cases.append(dict(B=1, Hq=32, Hkv=8, Sq=512, Skv=512, D=128,
                      causal=False, q_offset=0, dtype="bfloat16"))
    cases.append(dict(B=2, Hq=4, Hkv=2, Sq=256, Skv=256, D=64, causal=True,
                      q_offset=0, dtype="float32"))
    # jamba's attention layer in its forward: 64 query heads, 8 kv heads
    cases.append(dict(B=4, Hq=64, Hkv=8, Sq=2048, Skv=2048, D=128,
                      causal=True, q_offset=0, dtype="bfloat16"))
    # qwen3-moe's attention layer in its forward: 32 query heads, 4 kv heads
    cases.append(dict(B=4, Hq=32, Hkv=4, Sq=2048, Skv=2048, D=128,
                      causal=True, q_offset=0, dtype="bfloat16"))
    # the tiny configs' head dim, on the mma.sync route
    cases.append(dict(B=2, Hq=4, Hkv=2, Sq=300, Skv=300, D=16, causal=True,
                      q_offset=0, dtype="bfloat16"))
    # seamless-m4t-medium (16/16 heads, D = 64), none causal: the encoder,
    # cross-attention in prefill, ragged, and in a decode step (one query
    # row against the cached frames) in bf16 and f32
    for B, Sq, Skv, dtype in ((4, 1024, 1024, "bfloat16"),
                              (4, 64, 1024, "bfloat16"),
                              (1, 200, 777, "bfloat16"),
                              (4, 1, 1024, "bfloat16"),
                              (4, 1, 777, "float32")):
        cases.append(dict(B=B, Hq=16, Hkv=16, Sq=Sq, Skv=Skv, D=64,
                          causal=False, q_offset=0, dtype=dtype))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    results = []
    for c in cases:
        dt = getattr(torch, c["dtype"])
        tol = 2e-2 if c["dtype"] == "bfloat16" else 2e-5

        def rnd(S, H):
            return torch.randn(c["B"], S, H, c["D"], generator=gen,
                               device="cuda", dtype=torch.float32
                               ).to(dt).transpose(1, 2)

        q = rnd(c["Sq"], c["Hq"])
        k, v = rnd(c["Skv"], c["Hkv"]), rnd(c["Skv"], c["Hkv"])
        kw = dict(causal=c["causal"], q_offset=c["q_offset"])
        kernel = fa.route(dt, c["D"])
        by_route = fa.flash_attention.route_launches[kernel]
        out = fa.flash_attention(q, k, v, **kw)
        if fa.flash_attention.route_launches[kernel] != by_route + 1:
            raise AssertionError(f"{c} did not launch the {kernel} kernel")
        want = fa.flash_attention_plain(q, k, v, **kw)
        want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                          **kw)
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        max_err = float(diff.max())
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"non-finite kernel output: {c}")
        if bool((diff > tol + tol * want.float().abs()).any()):
            raise AssertionError(f"kernel disagrees with plain version: {c}, "
                                 f"max_err={max_err}, tol={tol}")
        rms_err = rms_rel_err(torch, out, want32)
        if rms_err > RMS_TOL[c["dtype"]]:
            raise AssertionError(f"kernel disagrees with plain version in "
                                 f"f32: {c}, rms_rel_err={rms_err}, "
                                 f"tol={RMS_TOL[c['dtype']]}")
        # yardsticks: one torch call for the same function (bool mask = keep)
        mask = None
        if c["causal"]:
            qpos = c["q_offset"] + torch.arange(c["Sq"], device="cuda")
            mask = qpos[:, None] >= torch.arange(c["Skv"], device="cuda")[None]

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        def library_causal():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        same_causal = c["causal"] and c["q_offset"] == 0 and \
            c["Sq"] == c["Skv"]
        err32 = lambda o: float((o.float() - want32).abs().max())
        kernel_ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw),
                            iters=20)
        prior_ms = (cuda_ms(torch, lambda: fa._launch(
            q, k, v, c["causal"], c["q_offset"], "mma_sync"), iters=20)
                    if kernel == "wgmma" else None)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v,
                                                                   **kw),
                           iters=3, warmup=1)
        library_ms = cuda_ms(torch, library, iters=20)
        bound_ms, bound_by = attention_bound(
            c["B"], c["Hq"], c["Hkv"], c["Sq"], c["Skv"], c["D"], c["causal"],
            c["q_offset"], c["dtype"])
        r = dict(c, route=kernel, max_err=max_err, tol=tol,
                 max_err_vs_f32=err32(out), rms_rel_err_vs_f32=rms_err,
                 rms_tol=RMS_TOL[c["dtype"]], kernel_ms=kernel_ms,
                 prior_ms=prior_ms, plain_ms=plain_ms, library_ms=library_ms,
                 library_max_err=float((library().float() - want.float())
                                       .abs().max()),
                 library_max_err_vs_f32=err32(library()),
                 library_causal_ms=(cuda_ms(torch, library_causal, iters=20)
                                    if same_causal else None),
                 library_causal_max_err_vs_f32=(err32(library_causal())
                                                if same_causal else None),
                 bound_ms=bound_ms, bound_by=bound_by)
        results.append(r)
        print("kernel case " + json.dumps(r), flush=True)
    print("flash, bf16 (ms): B Hq/Hkv Sq Skv, route, kernel, mma.sync, SDPA "
          "masked, SDPA is_causal, bound", flush=True)
    for r in results:
        if r["dtype"] == "bfloat16":
            print(f"  {r['B']} {r['Hq']}/{r['Hkv']} {r['Sq']:5d} "
                  f"{r['Skv']:5d} {r['route']:8s}"
                  f" {r['kernel_ms']:.4f} {r['prior_ms'] or 0:.4f} "
                  f"{r['library_ms']:.4f} {r['library_causal_ms'] or 0:.4f} "
                  f"{r['bound_ms']:.4f}", flush=True)
    return results


def grad_guard(torch, fa, rw, mb, gm):
    """Each kernel wrapper raises on a CUDA input that requires grad under
    grad mode (the kernels have no backward), and launches under
    ``torch.no_grad()``."""
    def t(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", dtype=dtype)

    calls = {
        "flash_attention": (fa.flash_attention, lambda: (
            t(1, 2, 64, 64, dtype=torch.bfloat16),
            t(1, 2, 64, 64, dtype=torch.bfloat16),
            t(1, 2, 64, 64, dtype=torch.bfloat16))),
        "rwkv6_scan": (rw.rwkv6_scan, lambda: (
            t(1, 2, 64, 64), t(1, 2, 64, 64), t(1, 2, 64, 64),
            torch.rand(1, 2, 64, 64, device="cuda"), t(2, 64))),
        "mamba_scan": (mb.mamba_scan, lambda: (
            -torch.rand(32, 16, device="cuda"), torch.rand(1, 64, 32,
                                                           device="cuda"),
            t(1, 64, 16), t(1, 64, 16), t(1, 64, 32))),
        "gmm": (gm.gmm, lambda: (
            t(64, 64, dtype=torch.bfloat16),
            t(2, 64, 64, dtype=torch.bfloat16),
            torch.tensor([32, 32], dtype=torch.int32, device="cuda"))),
    }
    for name, (fn, make) in calls.items():
        args = make()
        args[0].requires_grad_(True)
        try:
            fn(*args)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} launched on an input that "
                                 "requires grad")
        with torch.no_grad():
            fn(*args)
    torch.cuda.synchronize()
    print(f"grad guard: {len(calls)} wrappers raise under grad mode and run "
          "under no_grad", flush=True)


def reset_flash(fa):
    """Zero the flash wrapper's launch counts, in all and by route."""
    fa.flash_attention.launches = 0
    fa.flash_attention.route_launches = dict.fromkeys(fa.ROUTES, 0)


def flash_on_route(fa, want: int, what: str, route: str = "wgmma"):
    """Since the last reset, ``want`` flash launches, each on ``route``;
    returns the counts by route."""
    got = dict(fa.flash_attention.route_launches)
    if fa.flash_attention.launches != want or got[route] != want:
        raise AssertionError(f"{what}: {fa.flash_attention.launches} flash "
                             f"launches by route {got}, want {want}, all "
                             f"{route}")
    return got


def to_f32(tree):
    """A copy of a params tree (dicts, lists, tensors) in float32."""
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32(v) for v in tree]
    return tree.float()


# the port's kernels by their __global__ functions' names
PORT_KERNELS = {
    "flash_attention": ("flash_fwd_bf16", "flash_fwd_f32",
                        "flash_wgmma_kernel"),
    "rwkv6_scan": ("wkv6_chunk",),
    "mamba_scan": ("mamba_scan_kernel",),
    "gmm": ("gmm_bf16_kernel", "gmm_f32_kernel", "gmm_wgmma_kernel"),
}
# a demangled kernel name's own symbol, after "void " and its namespaces:
# "void (anonymous namespace)::mamba_scan_kernel<16>(float const*, ...)"
_SYMBOL = re.compile(r"(?:void )?(?:(?:\(anonymous namespace\)|\w+)::)*(\w+)")


def port_kernel(key: str):
    """The port kernel that a profiled kernel is, by its exact symbol, or
    None; "other" for any other kernel named like flash or gmm (a
    library's), which the port's counts must not take in."""
    sym = _SYMBOL.match(key).group(1)
    for name, syms in PORT_KERNELS.items():
        if sym in syms:
            return name
    return "other" if "flash" in key or "gmm" in key else None



def profile_call(torch, fn, label: str, top: int = 6):
    """One call of ``fn`` under torch.profiler: device busy share, the
    ``top`` kernels (ms and launches; names cut to 60 characters, those
    that then agree summed), and the device ms and launches of the port's
    own kernels
    (``port_kernels``, by the source's kernel name; ``other`` gathers
    any other kernel named like flash or gmm)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_name = {}        # kernels whose names agree in 60 characters, summed
    for e in kernels:
        ms, n = by_name.get(e.key[:60], (0.0, 0))
        by_name[e.key[:60]] = (ms + e.self_device_time_total / 1e3,
                               n + e.count)
    res = {"wall_ms": wall_ms,
           "device_busy_ms": busy_ms if kernels else "not measured",
           "device_busy_share": busy_ms / wall_ms if kernels else None,
           "kernel_launches": sum(e.count for e in kernels),
           "top_kernels_ms": dict(sorted(by_name.items(),
                                         key=lambda kv: -kv[1][0])[:top]),
           "port_kernels": {}}
    for e in kernels:
        name = port_kernel(e.key)
        if name is not None:
            ms, n = res["port_kernels"].get(name, (0.0, 0))
            res["port_kernels"][name] = (ms + e.self_device_time_total / 1e3,
                                         n + e.count)
    print(f"profile {label} " + json.dumps(res), flush=True)
    return res


def profile_ticks(torch, cfg, params, prompts, prefill_len: int = 2048):
    """Where one engine tick's time goes: a decode tick of 4 slots, and a
    tick that also prefills the ``prefill_len``-token prompt."""
    from repro_torch.serve import engine as engine_mod
    peng = engine_mod.ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                                  seed=SEED, device="cuda")
    for i in range(SLOTS):    # 3 tokens: admission, one tick, the profiled
        peng.add_request(engine_mod.Request(rid=i, prompt=prompts[i],
                                            max_new_tokens=3))
    peng.step()
    name = cfg.name
    prof = {"decode_tick": profile_call(torch, peng.step,
                                        f"{name} decode_tick")}
    peng.add_request(engine_mod.Request(
        rid=SLOTS, max_new_tokens=2,
        prompt=prompts[PROMPT_LENS.index(prefill_len)]))
    label = f"prefill_{prefill_len}_tick"
    prof[label] = profile_call(torch, peng.step, f"{name} {label}")
    return prof


def wkv_bound(B, H, S, D):
    """(bound ms, what bounds it, counts) of the WKV6 function on 4-byte
    floats: inputs r, k, v, w, u read once and y written once, against the
    f32 operations of its cheapest form, the token-by-token recurrence
    S_t = diag(w_t) S_{t-1} + k_t^T v_t (3 D^2: w*S, k*v, add) and
    y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t (2 D^2 + 5 D).  It needs no
    exponential.  ``chunked_sfu_ops`` counts the log2/exp2 operations of
    the kernel's chunked form, a cost of that design and not part of the
    bound: per chunk of 64 tokens (a ragged one padded to 64) and (b, h),
    log2 w (64 D), the tiles rq and kl (2 x 64 D), and the gains g_ij,
    2^{L_{b_i}}, 2^{L_{C-1} - L_{b_{j+1}}} and 2^{L_{C-1}} (15 D); the
    diagonal blocks take the decay as products of w, with none."""
    flops = B * H * S * (5 * D * D + 5 * D)
    nbytes = 4 * (5 * B * H * S * D + H * D)
    sfu = -(-S // 64) * (3 * 64 + 15) * D
    t_ops = flops / PEAK_FLOPS["float32"]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            dict(bytes=nbytes, flops=flops, chunked_sfu_ops=sfu * B * H))


def wkv_pass_ms(torch, rw, args, iters: int = 20):
    """Mean device ms of each launch of the WKV6 wrapper (zeroing the
    state-pass flags, then the kernel), from CUDA events that
    ``rw._launch`` records around each."""
    marks = []

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    rw._launch(*args)
    for _ in range(iters):
        rw._launch(*args, mark=mark)
    torch.cuda.synchronize()
    out = {}
    for (name, a), (_, b) in zip(marks, marks[1:]):
        if name is not None:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b) / iters
    return out


def wkv_cases(torch, rw):
    """WKV6 kernel vs plain version on the card; one dict per case.  The
    inputs are laid out [B,S,H,D] and go in as [B,H,S,D] views, as the
    model's ``ops.rwkv6_scan`` hands them over.  ``decay`` is None (random
    decays), a number (one decay everywhere) or "mixed" (each channel its
    own decay, log-spaced from 1e-6 to 1)."""
    cases = [dict(B=1, H=40, S=2048, D=64, decay=None),
             dict(B=4, H=40, S=2048, D=64, decay=None),
             dict(B=1, H=40, S=777, D=64, decay=None),
             dict(B=2, H=3, S=128, D=64, decay=None),
             dict(B=1, H=1, S=256, D=64, decay=1e-6),
             dict(B=4, H=40, S=2048, D=32, decay=None),
             dict(B=1, H=40, S=777, D=64, decay="mixed"),
             dict(B=2, H=40, S=64, D=64, decay=None)]   # one chunk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    results = []
    for c in cases:
        shape = (c["B"], c["S"], c["H"], c["D"])

        def rnd(*sh):
            return torch.randn(*sh, generator=gen, device="cuda")

        r, k, v = rnd(*shape), rnd(*shape), rnd(*shape)
        if c["decay"] is None:
            w = torch.exp(-torch.exp(rnd(*shape)))
        elif c["decay"] == "mixed":
            w = torch.logspace(-6, 0, c["D"], device="cuda").expand(
                *shape).contiguous()
        else:
            w = torch.full(shape, c["decay"], device="cuda")
        r, k, v, w = (t.transpose(1, 2) for t in (r, k, v, w))
        u = rnd(c["H"], c["D"])
        out = rw.rwkv6_scan(r, k, v, w, u)
        want = rw.rwkv6_scan_plain(r, k, v, w, u)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"non-finite kernel output: {c}")
        diff = (out - want).abs()
        max_err = float(diff.max())
        if c["decay"] is None:
            # scale-normalised, as tests/test_kernels.py's sweep
            tol = 2e-4
            err = max_err / (float(want.abs().max()) + 1.0)
        else:
            tol = 1e-3
            err = float((diff / (1.0 + want.abs())).max())
        if err > tol:
            raise AssertionError(f"kernel disagrees with plain version: {c}, "
                                 f"error {err} > {tol}")
        kernel_ms = cuda_ms(torch, lambda: rw.rwkv6_scan(r, k, v, w, u),
                            iters=20)
        pass_ms = wkv_pass_ms(torch, rw, (r, k, v, w, u))
        plain_ms = cuda_ms(torch, lambda: rw.rwkv6_scan_plain(r, k, v, w, u),
                           iters=3, warmup=1)
        bound_ms, bound_by, work = wkv_bound(c["B"], c["H"], c["S"], c["D"])
        res = dict(c, max_err=max_err, checked_err=err, tol=tol,
                   kernel_ms=kernel_ms, pass_ms=pass_ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   **work)
        results.append(res)
        print("kernel case rwkv6_scan " + json.dumps(res), flush=True)
    return results


def drive_engine(torch, cfg, params, prompts):
    """Serve ``prompts`` on ``ServeEngine`` (SLOTS slots, MAX_NEW new tokens
    each), timing each prefill and each tick and checking that every
    request completes and every logit is finite.  Returns the engine and
    its numbers."""
    from repro_torch.serve import engine as engine_mod
    prefill_ms, decode_logits_ok = [], []
    real_prefill, real_decode = engine_mod.prefill, engine_mod.decode_step

    def timed_prefill(cfg_, p, batch, max_len):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = real_prefill(cfg_, p, batch, max_len=max_len)
        torch.cuda.synchronize()
        prefill_ms.append((int(batch["tokens"].shape[1]),
                           (time.perf_counter() - t) * 1e3))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite prefill logits")
        return logits, cache

    def checked_decode(cfg_, p, tokens, cache):
        logits, cache = real_decode(cfg_, p, tokens, cache)
        decode_logits_ok.append(torch.isfinite(logits).all())
        return logits, cache

    engine_mod.prefill, engine_mod.decode_step = timed_prefill, checked_decode
    try:
        eng = engine_mod.ServeEngine(cfg, params, slots=SLOTS,
                                     max_len=MAX_LEN, seed=SEED,
                                     device="cuda")
        real_splice = eng._splice_cache

        def checked_splice(slot, cache1):
            # every entry of the slot, along its own batch axis, must be
            # the one-request prefill cache bit for bit
            real_splice(slot, cache1)
            for name, pool in eng.cache.items():
                got = pool.narrow(eng.batch_axes[name], slot, 1)
                if not torch.equal(got, cache1[name].to(pool.dtype)):
                    raise AssertionError(f"splice of {name!r} into slot "
                                         f"{slot} differs from its prefill")
            spliced.append(slot)

        spliced = []
        eng._splice_cache = checked_splice
        for i, pr in enumerate(prompts):
            eng.add_request(engine_mod.Request(rid=i, prompt=pr,
                                               max_new_tokens=MAX_NEW))
        torch.cuda.reset_peak_memory_stats()
        tick_ms = []
        t_serve = time.perf_counter()
        while eng.queue or any(s.active for s in eng.slot_states):
            n_pre = len(prefill_ms)
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            # the tick's decode: its time less its prefills'
            tick_ms.append(ms - sum(x[1] for x in prefill_ms[n_pre:]))
        serve_s = time.perf_counter() - t_serve
    finally:
        engine_mod.prefill, engine_mod.decode_step = real_prefill, real_decode
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for i in range(len(prompts)):
        req = eng.requests[i]
        if not req.done or len(req.output) != MAX_NEW:
            raise AssertionError(f"request {i} done={req.done} with "
                                 f"{len(req.output)} of {MAX_NEW} tokens")
    if not all(bool(ok) for ok in decode_logits_ok):
        raise AssertionError("non-finite decode logits")
    if len(spliced) != len(prompts):
        raise AssertionError(f"{len(spliced)} splices for {len(prompts)} "
                             "requests")
    # output tokens: the decode ticks' plus the first token of each prefill
    tokens = eng.tokens_generated + len(prompts)
    return eng, dict(requests=len(prompts), slots=SLOTS, max_len=MAX_LEN,
                     max_new_tokens=MAX_NEW,
                     prefill_ms={str(n): ms for n, ms in prefill_ms},
                     ticks=len(tick_ms),
                     decode_ms_per_tick_mean=sum(tick_ms) / len(tick_ms),
                     decode_ms_per_tick_median=sorted(tick_ms)[
                         len(tick_ms) // 2],
                     splices_checked=len(spliced),
                     tokens=tokens, serve_s=serve_s,
                     tokens_per_s=tokens / serve_s,
                     max_memory_allocated_gb=peak_gb)


def seeded_params(torch, cfg):
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers, {n_params(params) / 1e9:.3f} "
          f"B params ({cfg.param_dtype}, seed {SEED}) initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return params


def n_params(tree) -> int:
    """Elements in a params tree (dicts, lists, tensors)."""
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(n_params(v) for v in tree)
    return tree.numel()


def prompts_for(cfg):
    import numpy as np
    rng = np.random.RandomState(SEED)
    return [rng.randint(1, cfg.vocab_size - 1, size=n).tolist()
            for n in PROMPT_LENS]


def serve(torch, card: str):
    """Full-width qwen3-8b behind ServeEngine; returns the serve numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import prefill
    from repro_torch.serve import engine as engine_mod

    cfg = get_config(ARCH).replace(param_dtype="bfloat16",
                                   attention_impl="pallas")
    params = seeded_params(torch, cfg)
    prompts = prompts_for(cfg)
    reset_flash(fa)
    eng, res = drive_engine(torch, cfg, params, prompts)
    launches = fa.flash_attention.launches
    by_route = flash_on_route(fa, cfg.num_layers * len(prompts),
                              f"{cfg.name} serving ({cfg.num_layers} a "
                              f"prefill, {len(prompts)} prefills)")
    del eng

    # The same prompt through the plain chunked attention path.  In bf16 the
    # two paths' logits part by ~0.07 after 36 layers, and each is about as
    # far from the same model in f32 activations: bf16 rounding amplified by
    # depth, not the kernel.  So the check runs in f32 activations (the same
    # bf16-valued weights, cast), where the kernel path must agree within
    # 5e-2; the bf16 distances are reported beside it.
    i_ref = PROMPT_LENS.index(777)
    toks = torch.tensor(prompts[i_ref], device="cuda")[None]
    batch = {"tokens": toks,
             "positions": torch.arange(toks.shape[1], device="cuda")[None]}

    def last_logits(c, p):
        return prefill(c, p, batch, max_len=toks.shape[1])[0].float()

    xla = dict(attention_impl="xla")
    lo_k, lo_x = last_logits(cfg, params), last_logits(cfg.replace(**xla),
                                                       params)
    p32 = to_f32(params)
    c32 = cfg.replace(dtype="float32", param_dtype="float32")
    reset_flash(fa)
    lo_k32, lo_x32 = last_logits(c32, p32), last_logits(c32.replace(**xla),
                                                        p32)
    flash_on_route(fa, cfg.num_layers, "f32 prefill", route="f32")
    del p32
    parity_err = float((lo_k32 - lo_x32).abs().max())
    if bool(((lo_k32 - lo_x32).abs() > 5e-2 + 5e-2 * lo_x32.abs()).any()):
        raise AssertionError(f"f32 prefill logits: kernel path vs plain path "
                             f"max_err={parity_err} beyond 5e-2")
    bf16_err = {"kernel_vs_plain_path": float((lo_k - lo_x).abs().max()),
                "kernel_path_vs_f32": float((lo_k - lo_x32).abs().max()),
                "plain_path_vs_f32": float((lo_x - lo_x32).abs().max())}

    prof = profile_ticks(torch, cfg, params, prompts)

    res = dict(card=card, arch=cfg.name, **res, flash_launches=launches,
               flash_launches_by_route=by_route,
               prefill_parity_f32_max_err=parity_err,
               prefill_bf16_max_err=bf16_err, profile=prof)
    print("serve " + json.dumps(res), flush=True)
    return res


def by_path(tree, path=()):
    """{path: tensor} of a tree of dicts, lists and tensors."""
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items() for p, t in
                by_path(v, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: t for i, v in enumerate(tree) for p, t in
                by_path(v, path + (i,)).items()}
    return {path: tree}


def assert_trees_equal(torch, got, want, what: str) -> int:
    """Every leaf of ``got`` equal to ``want``'s bit for bit, on the same
    device and dtype; returns the leaf count."""
    got, want = by_path(got), by_path(want)
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: leaves differ: "
                             f"{sorted(set(got) ^ set(want))[:5]}")
    for k, w in want.items():
        g = got[k]
        if g.device != w.device or g.dtype != w.dtype or \
                not torch.equal(g, w):
            raise AssertionError(f"{what}: leaf {k} differs ({g.dtype} on "
                                 f"{g.device} vs {w.dtype} on {w.device})")
    return len(want)


def host_profile(fn, label: str, top: int = 8):
    """``fn()`` under cProfile: prints the ``top`` functions by own host
    seconds (with their call counts) and returns (``fn``'s result, that
    table).  Where the fabric's host time goes; the profiler adds a cost
    per Python call, so the phase's clean seconds come from unprofiled
    calls."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    out = prof.runcall(fn)
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    table = {f"{os.path.basename(f)}:{line}:{name}": (tt, nc)
             for (f, line, name), (_, nc, tt, _, _) in rows}
    print(f"host profile {label} " + json.dumps(table), flush=True)
    return out, table


def fabric_rates(info) -> dict:
    """GB/s of save, sync and restore from ``restore_over_fabric``'s
    host seconds."""
    return {f"{k}_gb_per_s": info["bytes"] / info[f"{k}_s"] / 1e9
            for k in ("save", "sync", "restore")}


def checkpoint(torch, card: str):
    """qwen3-4b (full width, CKPT_LAYERS deep, bf16) published and restored
    over the fabric by the launcher's path, then served from the restored
    params; then a 2-layer train state saved, stepped over and restored.
    Every fabric file lives in a temp dir, removed when the phase ends."""
    import shutil
    import tempfile
    from repro_torch.bridge import state_to_reference
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import Fabric, FabricSpec, SiteSpec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import restore_over_fabric
    from repro_torch.train import make_opt_state, make_train_step

    root = tempfile.mkdtemp(prefix="xufs_smoke_")
    disk = shutil.disk_usage(root)
    print(f"checkpoint: temp dir {root}, {disk.free / 1e9:.1f} GB free of "
          f"{disk.total / 1e9:.1f} GB", flush=True)
    try:
        cfg = get_config(TRAIN_ARCH).replace(param_dtype="bfloat16",
                                             attention_impl="pallas",
                                             num_layers=CKPT_LAYERS)
        params = seeded_params(torch, cfg)
        restored, info = restore_over_fabric(cfg, params,
                                             os.path.join(root, "serve"))
        shutil.rmtree(os.path.join(root, "serve"))
        n_leaves = assert_trees_equal(torch, restored, params,
                                      "restored qwen3-4b")
        prompts = prompts_for(cfg)[:CKPT_PROMPTS]
        with torch.inference_mode():
            eng0, _ = drive_engine(torch, cfg, params, prompts)
            want = [eng0.requests[i].output for i in range(len(prompts))]
            del eng0
            reset_flash(fa)
            eng1, served = drive_engine(torch, cfg, restored, prompts)
            by_route = flash_on_route(
                fa, cfg.num_layers * len(prompts),
                f"{cfg.name} served from restored params "
                f"({cfg.num_layers} a prefill, {len(prompts)} prefills)")
            got = [eng1.requests[i].output for i in range(len(prompts))]
            del eng1
        if got != want:
            raise AssertionError(f"greedy tokens from the restored params "
                                 f"{got} differ from the originals' {want}")
        del params, restored
        gc.collect()
        torch.cuda.empty_cache()

        # the train state: f32 params, int8 moments, after one step
        tcfg = get_config(TRAIN_ARCH).replace(
            num_layers=TRAIN_CHECK_LAYERS, param_dtype="float32",
            dtype="bfloat16")
        run = train_run(tcfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        state_dtype="int8", warmup_steps=1)
        tparams = seeded_params(torch, tcfg)
        opt = make_opt_state(run, tparams)
        batch = scoring_batch(torch, tcfg, TRAIN_BATCH, TRAIN_SEQ)
        step = make_train_step(run)
        tparams, opt, _ = step(tparams, opt, batch)
        state = {"params": tparams, "opt": opt}
        saved = state_to_reference(tcfg, state)
        snapshot = {k: v.clone() for k, v in by_path(saved).items()}
        fabric = Fabric(FabricSpec(sites=(
            SiteSpec("home", root=os.path.join(root, "train", "home")),
            SiteSpec("site", root=os.path.join(root, "train", "site")))))
        net = fabric.network
        s = fabric.login("trainer")
        mgr = CheckpointManager(s.client, f"home/ckpt/{tcfg.name}")
        c0, t0 = net.clock, time.perf_counter()
        _, prof_save = host_profile(lambda: mgr.save(1, saved),
                                    "train-state save")
        t1 = time.perf_counter()
        _, prof_sync = host_profile(s.client.sync, "train-state sync")
        t2, c1 = time.perf_counter(), net.clock
        step(tparams, opt, batch)          # in place, lr > 0 at count 1
        torch.cuda.synchronize()
        now = by_path(saved)
        moved = sum(not torch.equal(now[k], v) for k, v in snapshot.items())
        del now
        if not moved:
            raise AssertionError("the second train step changed no leaf of "
                                 "the saved tree: the check would be vacuous")
        template = state_to_reference(tcfg, state)
        t3 = time.perf_counter()
        (back, manifest), prof_restore = host_profile(
            lambda: mgr.restore(template), "train-state restore")
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        del template
        if manifest["step"] != 1:
            raise AssertionError(f"restored step {manifest['step']}, want 1")
        back = by_path(back)
        n_train = assert_trees_equal(torch, back, snapshot,
                                     "restored train state")
        if back[("opt", "count")].shape != ():
            raise AssertionError("count came back with shape "
                                 f"{tuple(back[('opt', 'count')].shape)}")
        tbytes = sum(t.numel() * t.element_size() for t in snapshot.values())
        train_info = dict(bytes=tbytes, save_s=t1 - t0, sync_s=t2 - t1,
                          restore_s=t4 - t3, save_wan_s=c1 - c0,
                          restore_wan_s=net.clock - c1, profiled=True,
                          host_profile=dict(save=prof_save, sync=prof_sync,
                                            restore=prof_restore))
        del tparams, opt, state, saved, snapshot, back
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(card=card, arch=cfg.name, layers=cfg.num_layers,
               disk_free_gb=disk.free / 1e9, disk_total_gb=disk.total / 1e9,
               serve=dict(info, **fabric_rates(info), leaves=n_leaves,
                          prompts=len(prompts), tokens_equal=True,
                          flash_launches=by_route["wgmma"],
                          flash_launches_by_route=by_route,
                          prefill_ms=served["prefill_ms"],
                          tokens_per_s=served["tokens_per_s"]),
               train_state=dict(train_info, **fabric_rates(train_info),
                                layers=TRAIN_CHECK_LAYERS, leaves=n_train,
                                leaves_moved_by_step=moved,
                                state_dtype=run.optim.state_dtype))
    print("checkpoint " + json.dumps(res), flush=True)
    return res


def scaled_err(got, want) -> float:
    """max |got - want| / (max |want| + 1)."""
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1.0)


def rwkv_forward(torch, card: str, cfg, params):
    """Full-width rwkv6-3b forward and loss through the WKV6 kernel."""
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.models import decode_step, forward, loss_fn, prefill

    B, S = RWKV_BATCH, RWKV_SEQ
    batch = scoring_batch(torch, cfg, B, S)
    forward(cfg, params, batch)                       # warm-up
    torch.cuda.synchronize()

    rw.rwkv6_scan.launches = 0
    t = time.perf_counter()
    logits, _ = forward(cfg, params, batch)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t) * 1e3
    launches = rw.rwkv6_scan.launches
    if launches != cfg.num_layers:
        raise AssertionError(f"WKV6 kernel launched {launches} times in one "
                             f"forward, want {cfg.num_layers}")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad forward logits {tuple(logits.shape)}")
    n0 = rw.rwkv6_scan.launches
    t = time.perf_counter()
    loss, metrics = loss_fn(cfg, params, batch)
    torch.cuda.synchronize()
    loss_ms = (time.perf_counter() - t) * 1e3
    if rw.rwkv6_scan.launches != n0 + cfg.num_layers:
        raise AssertionError("loss_fn did not run the kernel once per layer")
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"non-finite loss {float(loss)}")
    prof = profile_call(torch, lambda: forward(cfg, params, batch),
                        f"{cfg.name} forward")

    # The kernel path against the plain chunked path (scan_impl="xla") in
    # f32 activations (the bf16-valued weights, cast): the same math in
    # another summation order, through 32 layers, within 1e-3 of the
    # logits' scale.  The bf16 distances are printed beside it.
    lo_x = forward(cfg.replace(scan_impl="xla"), params, batch)[0]
    p32 = to_f32(params)
    c32 = cfg.replace(dtype="float32", param_dtype="float32")
    lo_k32 = forward(c32, p32, batch)[0]
    lo_x32 = forward(c32.replace(scan_impl="xla"), p32, batch)[0]
    parity = scaled_err(lo_k32, lo_x32)
    if parity > 1e-3:
        raise AssertionError(f"f32 logits: kernel path vs plain path scaled "
                             f"error {parity} beyond 1e-3")
    bf16_err = {"kernel_vs_plain_path": float((logits.float() - lo_x.float())
                                              .abs().max()),
                "kernel_path_vs_f32": float((logits.float() - lo_x32)
                                            .abs().max()),
                "plain_path_vs_f32": float((lo_x.float() - lo_x32)
                                           .abs().max()),
                "f32_max_abs_logit": float(lo_x32.abs().max())}
    del lo_x, lo_k32, lo_x32, logits

    # prefill(776 tokens) + decode(the 777th) against forward(777)[-1], in
    # f32: the state-returning chunked path (a ragged last chunk) and the
    # one-token recurrence against the kernel path
    toks = batch["tokens"][:1, :777]
    pos = batch["positions"][:1, :777]
    full = forward(c32, p32, {"tokens": toks, "positions": pos})[0][:, -1]
    _, cache = prefill(c32, p32, {"tokens": toks[:, :-1],
                                  "positions": pos[:, :-1]}, max_len=MAX_LEN)
    dec = decode_step(c32, p32, toks[:, -1:], cache)[0][:, 0]
    decode_err = scaled_err(dec, full)
    if decode_err > 1e-3:
        raise AssertionError(f"f32 prefill + decode vs forward: scaled error "
                             f"{decode_err} beyond 1e-3")
    del p32

    res = dict(card=card, arch=cfg.name, batch=B, seq=S,
               forward_ms=forward_ms, tokens_per_s=B * S / forward_ms * 1e3,
               loss_fn_ms=loss_ms, loss=float(loss), ce=float(metrics["ce"]),
               wkv_launches=launches, parity_f32_scaled_err=parity,
               bf16_max_err=bf16_err, decode_vs_forward_f32_scaled_err=
               decode_err, profile=prof)
    print("forward " + json.dumps(res), flush=True)
    return res


def rwkv_serve(torch, card: str, cfg, params):
    """rwkv6-3b behind ServeEngine: the kernel is not on this path."""
    from repro_torch.kernels import rwkv6_scan as rw
    prompts = prompts_for(cfg)
    rw.rwkv6_scan.launches = 0
    _, res = drive_engine(torch, cfg, params, prompts)
    if rw.rwkv6_scan.launches != 0:
        raise AssertionError(f"WKV6 kernel launched {rw.rwkv6_scan.launches}"
                             " times in serving; prefill should take the "
                             "state-returning chunked path")
    prof = profile_ticks(torch, cfg, params, prompts)
    res = dict(card=card, arch=cfg.name, **res, wkv_launches=0, profile=prof)
    print("serve " + json.dumps(res), flush=True)
    return res


def mamba_bound(B, S, di, N, clock_hz):
    """(bound ms, what bounds it, counts) of the selective scan: dt and x
    read and y written (and b, c, A read), against its B*S*di*N
    exponentials on the special-function units (16 a clock per SM at
    ``clock_hz``) and its ~6 f32 FLOPs per (b, s, d, n) at peak.  The
    exponentials are inherent: A is a learned [di, N] matrix."""
    nbytes = 4 * (3 * B * S * di + 2 * B * S * N + di * N)
    exps = B * S * di * N
    flops = 6 * exps
    times = {"bytes": nbytes / PEAK_BYTES,
             "exponentials": exps / (SFU_PER_CLOCK_PER_SM * N_SMS * clock_hz),
             "f32_flops": flops / PEAK_FLOPS["float32"]}
    by = max(times, key=times.get)
    return (times[by] * 1e3, "bytes" if by == "bytes" else "operations",
            dict(bytes=nbytes, exponentials=exps, flops=flops, bound_set_by=by,
                 **{f"{k}_ms": v * 1e3 for k, v in times.items()}))


def mamba_cases(torch, mb, clock_hz):
    """Selective-scan kernel vs plain version on the card; one dict per
    case.  Scale-normalised error within 1e-4, as tests/test_kernels.py,
    for y and for the final state hT (the checked call asks for it; the
    timed call does not, as in forward; ``state_ms`` times the call with
    it, as in prefill).  Where dt is fixed (underflow, weak decay) the
    kernel is also held within 1e-4 of the plain version in float64, the
    function without f32's rounding, and ``f64_err`` prints the kernel's
    and the f32 plain version's errors against it."""
    import torch.nn.functional as F
    cases = [dict(B=4, S=2048, di=16384, N=16, dt=None),   # jamba forward
             dict(B=1, S=2048, di=16384, N=16, dt=None),
             dict(B=1, S=777, di=16384, N=16, dt=None),    # ragged S
             dict(B=1, S=64, di=32, N=8, dt=None),         # the JAX sweep
             dict(B=2, S=128, di=64, N=16, dt=None),
             dict(B=1, S=256, di=128, N=16, dt=None),
             dict(B=1, S=2048, di=16384, N=16, dt=30.0),   # exp underflows
             dict(B=1, S=2048, di=16384, N=16, dt=1e-3),   # weak decay
             # weak decay over serving's longest prompt (MAX_LEN)
             dict(B=1, S=MAX_LEN, di=16384, N=16, dt=1e-3),
             dict(B=1, S=MAX_LEN, di=16384, N=16, dt=1e-2)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    results = []
    for c in cases:
        B, S, di, N = c["B"], c["S"], c["di"], c["N"]

        def rnd(*sh):
            return torch.randn(*sh, generator=gen, device="cuda")

        A = -torch.exp(rnd(di, N))
        dt = (F.softplus(rnd(B, S, di)) if c["dt"] is None
              else torch.full((B, S, di), c["dt"], device="cuda"))
        b, cc, x = rnd(B, S, N), rnd(B, S, N), rnd(B, S, di)
        args = (A, dt, b, cc, x)
        out, hT = mb.mamba_scan(*args, return_state=True)
        want, want_h = mb.mamba_scan_plain(*args, return_state=True)
        torch.cuda.synchronize()
        errs = {}
        for name, got, ref in (("y", out, want), ("hT", hT, want_h)):
            if tuple(got.shape) != tuple(ref.shape) or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError(f"bad kernel {name} {tuple(got.shape)}: "
                                     f"{c}")
            errs[name] = (float((got - ref).abs().max()),
                          scaled_err(got, ref))
            if errs[name][1] > 1e-4:
                raise AssertionError(f"kernel {name} disagrees with plain "
                                     f"version: {c}, scaled error "
                                     f"{errs[name][1]} > 1e-4")
        f64_err = None
        if c["dt"] is not None:
            exact = mb.mamba_scan_plain(*args, return_state=True,
                                        dtype=torch.float64)
            f64_err = {name: [scaled_err(got.double(), ref),
                              scaled_err(plain.double(), ref)]
                       for name, got, plain, ref in
                       (("y", out, want, exact[0]),
                        ("hT", hT, want_h, exact[1]))}
            del exact
            if max(e[0] for e in f64_err.values()) > 1e-4:
                raise AssertionError(f"kernel disagrees with the float64 "
                                     f"plain version: {c}, {f64_err}")
        kernel_ms = cuda_ms(torch, lambda: mb.mamba_scan(*args), iters=20)
        state_ms = cuda_ms(torch, lambda: mb.mamba_scan(
            *args, return_state=True), iters=20)
        plain_ms = cuda_ms(torch, lambda: mb.mamba_scan_plain(*args),
                           iters=2, warmup=1)
        bound_ms, bound_by, work = mamba_bound(B, S, di, N, clock_hz)
        res = dict(c, spt=mb.STATES_PER_THREAD, max_err=errs["y"][0],
                   checked_err=errs["y"][1], hT_max_err=errs["hT"][0],
                   hT_checked_err=errs["hT"][1], f64_err=f64_err, tol=1e-4,
                   kernel_ms=kernel_ms, state_ms=state_ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   **work)
        results.append(res)
        print("kernel case mamba_scan " + json.dumps(res), flush=True)
    return results


def scoring_batch(torch, cfg, B, S):
    """A seeded batch of ``batch_shapes(cfg, B, S)``: numpy tokens with
    next-token targets, positions 0..S-1 ([3, B, S] for a VLM) and, for
    the enc-dec and VLM families, standard normal frontend embeddings from
    a card generator."""
    import numpy as np
    from repro_torch.data import batch_shapes
    shapes = batch_shapes(cfg, B, S)
    n = shapes["tokens"][0][1]
    rng = np.random.RandomState(SEED)
    seq = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(B, n + 1)))
    seq = seq.to("cuda")
    pshape = shapes["positions"][0]
    out = {"tokens": seq[:, :-1], "targets": seq[:, 1:],
           "positions": torch.arange(pshape[-1], device="cuda"
                                     ).expand(pshape)}
    if "frontend" in shapes:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        fshape, fdtype = shapes["frontend"]
        out["frontend"] = torch.randn(fshape, generator=gen, device="cuda"
                                      ).to(fdtype)
    return out


def jamba_forward(torch, card: str, cfg, params):
    """Full-width jamba (no experts) forward and loss through the
    selective-scan and flash kernels, at JAMBA_LAYERS layers."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as mb
    from repro_torch.models import forward, loss_fn

    B, S = RWKV_BATCH, RWKV_SEQ
    nb = cfg.num_layers // cfg.hybrid_period
    n_mamba = cfg.num_layers - nb
    batch = scoring_batch(torch, cfg, B, S)
    forward(cfg, params, batch)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    mb.mamba_scan.launches = 0
    reset_flash(fa)
    t = time.perf_counter()
    logits, _ = forward(cfg, params, batch)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t) * 1e3
    launches = (mb.mamba_scan.launches, fa.flash_attention.launches)
    if launches != (n_mamba, nb):
        raise AssertionError(f"one forward launched (scan, flash) = "
                             f"{launches}, want {(n_mamba, nb)}")
    by_route = flash_on_route(fa, nb, f"{cfg.name} forward")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad forward logits {tuple(logits.shape)}")
    t = time.perf_counter()
    loss, metrics = loss_fn(cfg, params, batch)
    torch.cuda.synchronize()
    loss_ms = (time.perf_counter() - t) * 1e3
    if (mb.mamba_scan.launches, fa.flash_attention.launches) != \
            (2 * n_mamba, 2 * nb):
        raise AssertionError("loss_fn did not run each kernel once per layer")
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"non-finite loss {float(loss)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_call(torch, lambda: forward(cfg, params, batch),
                        f"{cfg.name} forward")
    # the plain scan path in bf16, for the distance only (the check is in
    # f32, at JAMBA_F32_LAYERS layers)
    lo_x = forward(cfg.replace(scan_impl="xla"), params, batch)[0]
    bf16_err = float((logits.float() - lo_x.float()).abs().max())
    res = dict(card=card, arch=cfg.name, layers=cfg.num_layers,
               params=n_params(params), batch=B, seq=S, forward_ms=forward_ms,
               tokens_per_s=B * S / forward_ms * 1e3, loss_fn_ms=loss_ms,
               loss=float(loss), ce=float(metrics["ce"]),
               scan_launches=launches[0], flash_launches=launches[1],
               flash_launches_by_route=by_route,
               max_memory_allocated_gb=peak_gb,
               bf16_kernel_vs_plain_path_max_err=bf16_err,
               max_abs_logit=float(logits.float().abs().max()), profile=prof)
    print("forward " + json.dumps(res), flush=True)
    return res


def jamba_serve(torch, card: str, cfg, params):
    """Jamba behind ServeEngine: each prefill runs the scan kernel once a
    Mamba layer (it returns the final state) and the flash kernel once an
    attention layer; decode runs neither."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as mb
    prompts = prompts_for(cfg)
    nb = cfg.num_layers // cfg.hybrid_period
    want = ((cfg.num_layers - nb) * len(prompts), nb * len(prompts))
    mb.mamba_scan.launches = 0
    reset_flash(fa)
    _, res = drive_engine(torch, cfg, params, prompts)
    launches = (mb.mamba_scan.launches, fa.flash_attention.launches)
    if launches != want:
        raise AssertionError(f"serving launched (scan, flash) = {launches}, "
                             f"want {want}")
    flash_on_route(fa, nb * len(prompts), f"{cfg.name} serving")
    prof = profile_ticks(torch, cfg, params, prompts)
    res = dict(card=card, arch=cfg.name, layers=cfg.num_layers, **res,
               scan_launches=launches[0], flash_launches=launches[1],
               profile=prof)
    print("serve " + json.dumps(res), flush=True)
    return res


def jamba_f32(torch, card: str, cfg):
    """At JAMBA_F32_LAYERS layers in f32: the kernel path against the plain
    scan path (within 1e-3 of the logits' scale), and prefill(S-1) +
    decode(1) against forward(S) on a 777-token prompt, the prefill's
    states from the kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as mb
    from repro_torch.models import decode_step, forward, prefill
    c32 = cfg.replace(num_layers=JAMBA_F32_LAYERS, dtype="float32",
                      param_dtype="float32")
    p32 = seeded_params(torch, c32)
    batch = scoring_batch(torch, c32, RWKV_BATCH, RWKV_SEQ)
    n0 = mb.mamba_scan.launches
    reset_flash(fa)
    lo_k = forward(c32, p32, batch)[0]
    if mb.mamba_scan.launches != n0 + JAMBA_F32_LAYERS - 1:
        raise AssertionError("the f32 forward did not run the f32 kernel")
    flash_on_route(fa, JAMBA_F32_LAYERS // c32.hybrid_period, "f32 forward",
                   route="f32")
    lo_x = forward(c32.replace(scan_impl="xla"), p32, batch)[0]
    parity = scaled_err(lo_k, lo_x)
    if parity > 1e-3:
        raise AssertionError(f"f32 logits: kernel path vs plain path scaled "
                             f"error {parity} beyond 1e-3")
    scale = float(lo_x.abs().max())
    del lo_k, lo_x
    toks = batch["tokens"][:1, :777]
    pos = batch["positions"][:1, :777]
    full = forward(c32, p32, {"tokens": toks, "positions": pos})[0][:, -1]
    n0 = mb.mamba_scan.launches
    _, cache = prefill(c32, p32, {"tokens": toks[:, :-1],
                                  "positions": pos[:, :-1]}, max_len=MAX_LEN)
    if mb.mamba_scan.launches != n0 + JAMBA_F32_LAYERS - 1:
        raise AssertionError("the f32 prefill did not run the f32 kernel")
    dec = decode_step(c32, p32, toks[:, -1:], cache)[0][:, 0]
    decode_err = scaled_err(dec, full)
    if decode_err > 1e-3:
        raise AssertionError(f"f32 prefill + decode vs forward: scaled error "
                             f"{decode_err} beyond 1e-3")
    res = dict(card=card, arch=c32.name, layers=JAMBA_F32_LAYERS,
               params=n_params(p32), parity_f32_scaled_err=parity,
               f32_max_abs_logit=scale,
               decode_vs_forward_f32_scaled_err=decode_err)
    print("f32 " + json.dumps(res), flush=True)
    return res


def gmm_bound(sizes, M, K, N, dtype_name):
    """(bound ms, what bounds it, counts) of one grouped product: 2 K N
    FLOPs a row of a group, against lhs rows of the groups, rhs of the
    non-empty groups and all M output rows, each moved once."""
    rows = sum(sizes)
    nonempty = sum(1 for s in sizes if s > 0)
    itemsize = 2 if dtype_name == "bfloat16" else 4
    flops = 2.0 * rows * K * N
    nbytes = itemsize * (rows * K + nonempty * K * N + M * N)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            dict(flops=flops, bytes=nbytes, ops_ms=t_ops * 1e3,
                 bytes_ms=t_bytes * 1e3))


def gmm_cases(torch, gm):
    """gmm kernel vs plain version on the card, bf16 and f32; one dict per
    case.  The check is against the plain version's f32 product of the
    same inputs: scaled error (max |diff| / max |want|) within 1e-5 in
    f32, and within 4e-3 in bf16, where the kernel rounds the f32 sum once
    (2^-8 = 0.0039 of a value at most).  ``max_err`` is against the plain
    version in the same dtype (a bf16 rounding may land one ulp apart).
    Each launch must take the route that ``gm.route`` names; where that is
    the wgmma route, ``prior_ms`` times the mma.sync kernel on the same
    inputs (the design it replaced on that route)."""
    import numpy as np
    E = 128
    cases = []
    for name, R in (("forward", 641), ("prefill", 161), ("decode", 9)):
        for K, N, what in ((2048, 768, "gate/up"), (768, 2048, "down")):
            cases.append(dict(case=f"{name} {what}", sizes=[R] * E, K=K,
                              N=N, equal=True))
    for sizes in GMM_SWEEP:
        cases.append(dict(case="sweep", sizes=list(sizes), K=64, N=128,
                          equal=False))
    rng = np.random.RandomState(SEED)
    w = rng.gamma(0.5, size=E)
    w[rng.choice(E, 16, replace=False)] = 0.0
    ragged = rng.multinomial(65536, w / w.sum()).tolist()
    cases.append(dict(case="ragged", sizes=ragged, K=2048, N=768,
                      equal=False))
    cases.append(dict(case="partial tiles", sizes=[300, 0, 77, 1000],
                      K=1000, N=1000, equal=False))
    cases.append(dict(case="unaligned", sizes=[5, 0, 70, 1, 300], K=100,
                      N=90, equal=False))
    # the wgmma route's edges: half tiles and group ends at every offset
    # of a 64-row unit, K past BK and N past BN, and more groups than one
    # scan chunk of 384
    cases.append(dict(case="half tiles",
                      sizes=[0, 1, 63, 64, 65, 127, 128, 129, 641], K=256,
                      N=384, equal=False))
    cases.append(dict(case="K 200, N 136", sizes=[5, 0, 70, 1, 300], K=200,
                      N=136, equal=False))
    cases.append(dict(case="300 groups",
                      sizes=[(g * 7) % 23 for g in range(300)], K=64, N=128,
                      equal=False))
    cases.append(dict(case="1000 groups",
                      sizes=[(g * 5) % 11 for g in range(1000)], K=72, N=64,
                      equal=False))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    results = []
    for c in cases:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            sizes, K, N = c["sizes"], c["K"], c["N"]
            G = len(sizes)
            M = sum(sizes) + (0 if c["equal"] else 7)   # 7 rows past
            lhs = torch.randn(M, K, generator=gen, device="cuda").to(dt)
            rhs = (torch.randn(G, K, N, generator=gen, device="cuda")
                   * K ** -0.5).to(dt)
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            kernel = gm.route(dt, K, N, G)
            if c["equal"]:
                x = lhs.view(G, sizes[0], K)

                def run():
                    return gm.gmm_equal(x, rhs).view(M, N)

                def prior():
                    return gm._launch(lhs, rhs, None, sizes[0], "mma_sync")

                def library():
                    return torch.bmm(x, rhs)
            else:
                def run():
                    return gm.gmm(lhs, rhs, gs)

                def prior():
                    return gm._launch(lhs, rhs, gs, 0, "mma_sync")
                library = None
            by_route = gm.gmm.route_launches[kernel]
            out = run()
            if gm.gmm.route_launches[kernel] != by_route + 1:
                raise AssertionError(f"{c['case']} {dtype} did not launch "
                                     f"the {kernel} kernel")
            want = gm.gmm_plain(lhs.float(), rhs.float(), gs)
            plain = gm.gmm_plain(lhs, rhs, gs)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"non-finite kernel output: {c}")
            tol = 4e-3 if dtype == "bfloat16" else 1e-5
            err = float((out.float() - want).abs().max()) / float(
                want.abs().max())
            tail = float(out[sum(sizes):].float().abs().max()) \
                if M > sum(sizes) else 0.0
            if err > tol or tail != 0.0:
                raise AssertionError(f"gmm disagrees with plain version: "
                                     f"{c['case']} {dtype}, scaled error "
                                     f"{err} > {tol} or tail {tail}")
            max_err = float((out.float() - plain.float()).abs().max())
            kernel_ms = cuda_ms(torch, run, iters=20)
            prior_ms = (cuda_ms(torch, prior, iters=20)
                        if kernel == "wgmma" else None)
            plain_ms = cuda_ms(torch, lambda: gm.gmm_plain(lhs, rhs, gs),
                               iters=3, warmup=1)
            library_ms = (cuda_ms(torch, library, iters=20)
                          if library is not None else None)
            bound_ms, bound_by, work = gmm_bound(sizes, M, K, N, dtype)
            res = dict(case=c["case"], dtype=dtype, route=kernel, G=G, M=M,
                       K=K, N=N, rows=sum(sizes), empty_groups=sizes.count(0),
                       sizes=sizes if G <= 9 else f"{G} groups",
                       max_err=max_err, checked_err=err, tol=tol,
                       kernel_ms=kernel_ms, prior_ms=prior_ms,
                       plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by, **work)
            results.append(res)
            print("kernel case gmm " + json.dumps(res), flush=True)
            del lhs, rhs, out, want, plain
    print("gmm at the MoE shapes, bf16 (ms): case, wgmma, mma.sync, "
          "torch.bmm, bound", flush=True)
    for r in results:
        if r["dtype"] == "bfloat16" and r["library_ms"] is not None:
            print(f"  {r['case']:16s} {r['kernel_ms']:.4f} "
                  f"{r['prior_ms']:.4f} {r['library_ms']:.4f} "
                  f"{r['bound_ms']:.4f}", flush=True)
    return results


def moe_forward(torch, card: str, cfg, params):
    """Full-width qwen3-moe forward and loss through the gmm and flash
    kernels (3 gmm and 1 flash launch a layer)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gm
    from repro_torch.models import forward, loss_fn

    B, S, L = MOE_BATCH, RWKV_SEQ, cfg.num_layers
    batch = scoring_batch(torch, cfg, B, S)
    forward(cfg, params, batch)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    gm.gmm.launches = 0
    gm.gmm.route_launches = dict.fromkeys(gm.ROUTES, 0)
    reset_flash(fa)
    t = time.perf_counter()
    logits, aux = forward(cfg, params, batch)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t) * 1e3
    launches = (gm.gmm.launches, fa.flash_attention.launches)
    by_route = dict(gm.gmm.route_launches)
    if launches != (3 * L, L) or by_route["wgmma"] != 3 * L:
        raise AssertionError(f"one forward launched (gmm, flash) = "
                             f"{launches}, want {(3 * L, L)}, gmm by route "
                             f"{gm.gmm.route_launches}, want all wgmma")
    flash_by_route = flash_on_route(fa, L, f"{cfg.name} forward")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()) or \
            not float(aux) > 0.0:
        raise AssertionError(f"bad forward: logits {tuple(logits.shape)}, "
                             f"aux {float(aux)}")
    t = time.perf_counter()
    loss, metrics = loss_fn(cfg, params, batch)
    torch.cuda.synchronize()
    loss_ms = (time.perf_counter() - t) * 1e3
    if (gm.gmm.launches, fa.flash_attention.launches) != (6 * L, 2 * L) \
            or gm.gmm.route_launches["wgmma"] != 6 * L \
            or fa.flash_attention.route_launches["wgmma"] != 2 * L:
        raise AssertionError("loss_fn did not run each kernel per layer, "
                             "gmm on the wgmma route")
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"non-finite loss {float(loss)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_call(torch, lambda: forward(cfg, params, batch),
                        f"{cfg.name} forward")
    # the plain path (einsum experts, plain attention) in bf16, for the
    # distance only: the check is in f32, at MOE_F32_LAYERS layers
    lo_x = forward(cfg.replace(scan_impl="xla", attention_impl="xla"),
                   params, batch)[0]
    bf16_err = float((logits.float() - lo_x.float()).abs().max())
    res = dict(card=card, arch=cfg.name, layers=L, params=n_params(params),
               batch=B, seq=S, forward_ms=forward_ms,
               tokens_per_s=B * S / forward_ms * 1e3, loss_fn_ms=loss_ms,
               loss=float(loss), ce=float(metrics["ce"]),
               aux=float(metrics["aux"]), gmm_launches=launches[0],
               gmm_launches_by_route=by_route,
               flash_launches=launches[1],
               flash_launches_by_route=flash_by_route,
               max_memory_allocated_gb=peak_gb,
               bf16_kernel_vs_plain_path_max_err=bf16_err,
               max_abs_logit=float(logits.float().abs().max()), profile=prof)
    print("forward " + json.dumps(res), flush=True)
    return res


def moe_serve(torch, card: str, cfg, params):
    """qwen3-moe behind ServeEngine: 3 gmm launches a layer in every
    prefill and every decode tick, the flash kernel in each prefill."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gm
    prompts = prompts_for(cfg)
    L = cfg.num_layers
    gm.gmm.launches = 0
    gm.gmm.route_launches = dict.fromkeys(gm.ROUTES, 0)
    reset_flash(fa)
    _, res = drive_engine(torch, cfg, params, prompts)
    launches = (gm.gmm.launches, fa.flash_attention.launches)
    want = (3 * L * (len(prompts) + res["ticks"]), L * len(prompts))
    if launches != want or gm.gmm.route_launches["wgmma"] != want[0]:
        raise AssertionError(f"serving launched (gmm, flash) = {launches}, "
                             f"want {want}; gmm by route "
                             f"{gm.gmm.route_launches}, want all wgmma")
    flash_on_route(fa, want[1], f"{cfg.name} serving")
    by_route = dict(gm.gmm.route_launches)
    prof = profile_ticks(torch, cfg, params, prompts)
    res = dict(card=card, arch=cfg.name, layers=L, **res,
               gmm_launches=launches[0], gmm_launches_by_route=by_route,
               flash_launches=launches[1], profile=prof)
    print("serve " + json.dumps(res), flush=True)
    return res


def _kept(ids, E: int, C: int):
    """Which of the [T, k] assignments ``ids`` fit their expert's capacity
    C, by the reference's token-major running count."""
    import torch
    flat = ids.reshape(-1)
    oh = torch.nn.functional.one_hot(flat, E).to(torch.int32)
    pos = (torch.cumsum(oh, dim=0) - 1).gather(1, flat[:, None])[:, 0]
    return (pos < C).reshape(ids.shape)


def moe_f32(torch, card: str, cfg):
    """At MOE_F32_LAYERS layers in f32: the kernel path (gmm + flash)
    against the plain path (einsum + plain attention) within 1e-4 of the
    logits' scale, and prefill(S-1) + decode(1) against forward(S).

    The two paths' hidden states differ by rounding, so a token whose k-th
    and (k+1)-th router probabilities nearly tie can take another expert
    on one path, and through capacity move another token's drop.  Each
    such routing difference is printed (layer, token, the probability gap
    on the kernel path); the first in a sequence must be a near-tie (gap
    < 1e-4), and the sequences it touches are held out of the 1e-4 check
    (their error is printed).  At least one sequence must remain."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gm
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.models import moe as moe_mod
    c32 = cfg.replace(num_layers=MOE_F32_LAYERS, dtype="float32",
                      param_dtype="float32")
    p32 = seeded_params(torch, c32)
    B, S = MOE_BATCH, RWKV_SEQ
    batch = scoring_batch(torch, c32, B, S)
    m = c32.moe
    routes = []
    real = moe_mod._moe_tokens

    def recording(cfg_, p, xf):
        probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
        top, ids = torch.topk(probs, m.experts_per_token + 1, dim=-1)
        routes.append((ids[:, :-1].sort(dim=-1).values,
                       top[:, -2] - top[:, -1]))
        return real(cfg_, p, xf)

    moe_mod._moe_tokens = recording
    try:
        n0 = gm.gmm.launches
        f0 = gm.gmm.route_launches["mma_sync"]
        reset_flash(fa)
        lo_k = forward(c32, p32, batch)[0]
        if gm.gmm.launches != n0 + 3 * MOE_F32_LAYERS or \
                gm.gmm.route_launches["mma_sync"] != f0 + 3 * MOE_F32_LAYERS:
            raise AssertionError("the f32 forward did not run the f32 gmm")
        flash_on_route(fa, MOE_F32_LAYERS, "f32 forward", route="f32")
        lo_x = forward(c32.replace(scan_impl="xla", attention_impl="xla"),
                       p32, batch)[0]
    finally:
        moe_mod._moe_tokens = real
    C = moe_mod._capacity(m, B * S)
    flips, held_out, dropped = [], set(), []
    for layer in range(MOE_F32_LAYERS):
        (ids_k, gap), (ids_x, _) = routes[layer], routes[MOE_F32_LAYERS + layer]
        differ = (ids_k != ids_x).any(-1)
        kept_k = _kept(ids_k, m.num_experts, C)
        moved = (kept_k != _kept(ids_x, m.num_experts, C)).any(-1)
        dropped.append(1.0 - float(kept_k.float().mean()))
        before = set(held_out)     # sequences already apart downstream
        for tok in torch.nonzero(differ | moved)[:, 0].tolist():
            f = dict(layer=layer, token=tok, seq=tok // S, pos=tok % S,
                     experts_differ=bool(differ[tok]), gap=float(gap[tok]),
                     downstream=tok // S in before)
            flips.append(f)
            held_out.add(tok // S)
            if len(flips) <= 20:
                print("routing difference " + json.dumps(f), flush=True)
            if f["experts_differ"] and not f["downstream"] and \
                    f["gap"] >= 1e-4:
                raise AssertionError(f"routing differs where the router "
                                     f"does not nearly tie: {f}")
    kept = [b for b in range(B) if b not in held_out]
    if not kept:
        raise AssertionError("routing differs in every sequence")
    parity = scaled_err(lo_k[kept], lo_x[kept])
    if parity > 1e-4:
        raise AssertionError(f"f32 logits: kernel path vs plain path scaled "
                             f"error {parity} beyond 1e-4")
    held_err = {b: scaled_err(lo_k[b], lo_x[b]) for b in sorted(held_out)}
    scale = float(lo_x.abs().max())
    del lo_k, lo_x
    # prefill(776) + decode(the 777th) against forward(777)[-1]: capacity
    # depends on how many tokens are routed together, so the forward may
    # drop the last token where the one-token decode does not (in the
    # reference too).  With random weights the routing past layer 0
    # crowds a few experts, so only capacity_factor = E / k (C >= T: no
    # expert can overflow) leaves room for every token.
    roomy = c32.replace(moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.experts_per_token))
    toks = batch["tokens"][:1, :777]
    pos = batch["positions"][:1, :777]
    full = forward(roomy, p32, {"tokens": toks, "positions": pos})[0][:, -1]
    _, cache = prefill(roomy, p32, {"tokens": toks[:, :-1],
                                    "positions": pos[:, :-1]},
                       max_len=MAX_LEN)
    dec = decode_step(roomy, p32, toks[:, -1:], cache)[0][:, 0]
    decode_err = scaled_err(dec, full)
    if decode_err > 1e-4:
        raise AssertionError(f"f32 prefill + decode vs forward: scaled error "
                             f"{decode_err} beyond 1e-4")
    res = dict(card=card, arch=c32.name, layers=MOE_F32_LAYERS,
               params=n_params(p32), capacity=C,
               dropped_share_by_layer=dropped, routing_differences=len(flips),
               sequences_held_out=sorted(held_out),
               held_out_scaled_err=held_err, parity_f32_scaled_err=parity,
               f32_max_abs_logit=scale,
               decode_vs_forward_f32_scaled_err=decode_err)
    print("f32 " + json.dumps(res), flush=True)
    return res


def train_run(cfg, *, batch: int, seq: int, **optim_kw):
    """A RunConfig for ``cfg`` (a train shape of ``batch`` x ``seq``)."""
    from repro_torch.config import TRAIN, OptimConfig, RunConfig, ShapeConfig
    return RunConfig(model=cfg, shape=ShapeConfig("smoke", TRAIN, seq, batch),
                     optim=OptimConfig(**optim_kw),
                     microbatches=TRAIN_MICRO, seed=SEED)


def train(torch, card: str):
    """Full-width, full-depth qwen3-4b: TRAIN_STEPS train steps on one seeded
    batch (f32 params, bf16 activations, remat "full", int8 moments, the
    plain attention path), then the eval step through the flash kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim import adamw_update, clip_by_global_norm
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import make_eval_step, make_opt_state, \
        make_train_step

    cfg = get_config(TRAIN_ARCH).replace(param_dtype="float32",
                                         dtype="bfloat16", remat="full",
                                         layers_per_step=1)
    B, S, L = TRAIN_BATCH, TRAIN_SEQ, cfg.num_layers
    run = train_run(cfg, batch=B, seq=S, state_dtype="int8", warmup_steps=1)
    params = seeded_params(torch, cfg)
    n = n_params(params)
    opt = make_opt_state(run, params)
    batch = scoring_batch(torch, cfg, B, S)
    step = make_train_step(run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, metrics = step(params, opt, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        print(f"train step: loss {losses[-1]:.6f}, grad_norm "
              f"{float(metrics['grad_norm']):.4f}, lr "
              f"{float(metrics['lr']):.3e}, {step_ms[-1]:.1f} ms", flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train losses {losses}: not finite, or step "
                             f"{TRAIN_STEPS}'s not below step 1's")
    ms = sum(step_ms[1:]) / len(step_ms[1:])
    tokens = B * S
    flops = 6 * n * tokens + B * 12 * L * cfg.num_heads * cfg.head_dim \
        * S * S / 2
    prof = profile_call(torch, lambda: step(params, opt, batch),
                        f"{cfg.name} train_step", top=10)

    # the eval step under no_grad: the flash kernel once a layer, against
    # the same eval step on the plain attention path
    eval_k = make_eval_step(train_run(cfg.replace(attention_impl="pallas"),
                                      batch=B, seq=S))
    eval_x = make_eval_step(run)
    reset_flash(fa)
    ev = eval_k(params, batch)
    torch.cuda.synchronize()
    flash_on_route(fa, L, f"{cfg.name} eval step")
    ev_x = eval_x(params, batch)
    eval_ms = cuda_ms(torch, lambda: eval_k(params, batch), iters=3,
                      warmup=1)
    eval_plain_ms = cuda_ms(torch, lambda: eval_x(params, batch), iters=3,
                            warmup=1)
    # the optimizer alone: clip, then AdamW with int8 moments, on zero
    # grads (the same work as on the step's grads)
    grads = tree_map(torch.zeros_like, params)
    lr = torch.tensor(3e-4, device="cuda")
    optimizer_ms = cuda_ms(torch, lambda: adamw_update(
        clip_by_global_norm(grads, run.optim.grad_clip)[0], opt, params, lr,
        run.optim), iters=3, warmup=1)
    del grads
    res = dict(card=card, arch=cfg.name, layers=L, params=n, batch=B, seq=S,
               microbatches=TRAIN_MICRO, remat=cfg.remat,
               state_dtype=run.optim.state_dtype, losses=losses,
               step_ms=step_ms, ms_per_step=ms,
               tokens_per_s=tokens / ms * 1e3,
               model_flops_per_step=flops,
               model_flops_share=flops / (ms * 1e-3) / PEAK_FLOPS["bfloat16"],
               max_memory_allocated_gb=peak_gb,
               eval_ce=float(ev["ce"]), eval_ce_plain_path=float(ev_x["ce"]),
               eval_ce_kernel_vs_plain=abs(float(ev["ce"]) -
                                           float(ev_x["ce"])),
               eval_flash_launches=L, eval_ms=eval_ms,
               eval_plain_ms=eval_plain_ms, optimizer_ms=optimizer_ms,
               profile=prof)
    print("train " + json.dumps(res), flush=True)
    return res


def _leaf_err(got, want, slack=None) -> float:
    """max |got - want| over max |want| (``slack``, per element, is taken
    off |got - want| first)."""
    d = (got - want).abs()
    if slack is not None:
        d = (d - slack).clamp(min=0)
    return float(d.max()) / max(float(want.abs().max()), 1e-30)


def _code_step(x, block: int):
    """Per element of ``x``: the step of its int8 code in blocks of
    ``block`` along the last dim."""
    from repro_torch.optim import q8_encode
    s = q8_encode(x, block)[1]
    return s.repeat_interleave(block, dim=-1)[..., :x.shape[-1]]


def train_card_vs_cpu(torch, card: str):
    """qwen3-4b at TRAIN_CHECK_LAYERS layers, full width, f32 activations:
    one train step (fp32 moments, int8 gradient compression, 2
    microbatches) on the card and, explicitly, on the host's CPU; then the
    eval step under "pallas" (the f32 flash kernel) against "xla"."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.optim.compress import BLOCK
    from repro_torch.train import make_eval_step, make_opt_state, \
        make_train_step

    cfg = get_config(TRAIN_ARCH).replace(num_layers=TRAIN_CHECK_LAYERS,
                                         dtype="float32",
                                         param_dtype="float32")
    B, S = 2, 128
    run = train_run(cfg, batch=B, seq=S, grad_compress="int8")
    params = seeded_params(torch, cfg)
    batch = scoring_batch(torch, cfg, B, S)
    on_cpu = (tree_map(lambda t: t.to("cpu"), params),
              {k: v.to("cpu") for k, v in batch.items()})
    out, secs = {}, {}
    for device, (p, b) in (("cuda", (params, batch)), ("cpu", on_cpu)):
        t = time.perf_counter()
        state = make_opt_state(run, p)
        p, state, metrics = make_train_step(run)(p, state, b)
        if device == "cuda":
            torch.cuda.synchronize()
        secs[device] = time.perf_counter() - t
        out[device] = (metrics, p, state)
    (cm, cp, cs), (hm, hp, hs) = out["cuda"], out["cpu"]
    metric_err = {k: abs(float(cm[k]) - float(hm[k])) /
                  max(abs(float(hm[k])), 1e-30) for k in hm}
    param_err = max(_leaf_err(a.cpu(), b) for a, b in
                    zip(tree_leaves(cp), tree_leaves(hp)))
    # The moments and the error feedback carry every grad.  Where the two
    # devices' grads straddle a rounding tie of the int8 compression, a
    # code lands one step (s) away: there m may differ by (1 - b1) s, v by
    # (1 - b2)(2 |g| s + s^2) and the error by s.  Such elements are
    # counted, and must stay few.
    b1, b2 = run.optim.b1, run.optim.b2
    state_err, flips, n_el = {"m": 0.0, "v": 0.0, "ef_error": 0.0}, 0, 0
    for m_c, v_c, e_c, m_h, v_h, e_h in zip(
            *(tree_leaves(s[k]) for s in (cs, hs)
              for k in ("m", "v", "ef_error"))):
        g = m_h / (1 - b1)
        s = _code_step(g, BLOCK) * 1.001
        for name, got, want, slack in (
                ("m", m_c, m_h, (1 - b1) * s),
                ("v", v_c, v_h, (1 - b2) * (2 * g.abs() * s + s * s)),
                ("ef_error", e_c, e_h, s)):
            got = got.cpu()
            state_err[name] = max(state_err[name],
                                  _leaf_err(got, want, slack))
            if name == "m":
                flips += int(((got - want).abs() >
                              1e-4 * want.abs().max()).sum())
                n_el += want.numel()
    del out, on_cpu, cs, hs, cp, hp
    gc.collect()
    reset_flash(fa)
    ev_k = make_eval_step(train_run(cfg.replace(attention_impl="pallas"),
                                    batch=B, seq=S))(params, batch)
    torch.cuda.synchronize()
    flash_on_route(fa, cfg.num_layers, "f32 eval step", route="f32")
    ev_x = make_eval_step(run)(params, batch)
    eval_err = abs(float(ev_k["ce"]) - float(ev_x["ce"])) / \
        abs(float(ev_x["ce"]))
    res = dict(card=card, arch=cfg.name, layers=cfg.num_layers,
               params=n_params(params), batch=B, seq=S,
               microbatches=TRAIN_MICRO, grad_compress="int8",
               card_s=secs["cuda"], cpu_s=secs["cpu"],
               metrics_card={k: float(v) for k, v in cm.items()},
               metrics_rel_err=metric_err, param_max_scaled_err=param_err,
               state_max_scaled_err_beyond_one_code=state_err,
               grad_code_flips=flips, elements=n_el,
               eval_ce_kernel_vs_plain_rel_err=eval_err)
    print("train card vs cpu " + json.dumps(res), flush=True)
    bad = [k for k, e in metric_err.items() if e > 1e-4]
    if bad or param_err > 1e-4 or max(state_err.values()) > 1e-4 or \
            flips > 1e-3 * n_el or eval_err > 1e-4:
        raise AssertionError(f"card vs CPU train step: metrics {bad}, "
                             f"params {param_err}, state {state_err}, "
                             f"{flips} of {n_el} grad codes apart, eval "
                             f"{eval_err}; limit 1e-4 (codes: 1e-3 of them)")
    return res


def corpus_tokens(cursor: int, n: int, shard_tokens: int, n_shards: int,
                  vocab: int):
    """The ``n`` corpus tokens from global position ``cursor`` (wrapping
    over the shards), straight from ``synth_tokens``."""
    import numpy as np
    from repro_torch.data.pipeline import synth_tokens
    flat = np.concatenate([synth_tokens(0, i, shard_tokens, vocab)
                           for i in range(n_shards)])
    return flat[(cursor + np.arange(n)) % len(flat)]


def trainer(torch, card: str):
    """The Trainer loop on the card: (a) full-width qwen3-4b at
    TRAINER_LAYERS layers for 3 timed steps beside 3 bare ones; (b) 2
    layers with a straggle, a crash and checkpoints through the fabric,
    each part of a step timed; (c) a cold restore, bit for bit, then the
    eval step through the f32 flash kernel; (d) the training launcher in a
    subprocess.  Every fabric file lives in a temp dir, removed when the
    phase ends."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import Fabric, FabricSpec, MountSpec, SiteSpec
    from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import FaultEvent, FaultMonitor, Trainer, \
        make_eval_step

    B, S = TRAIN_BATCH, TRAIN_SEQ
    shard_tokens = max(B * S * 4, 8192)     # as launch/train.py sizes them
    root = tempfile.mkdtemp(prefix="xufs_trainer_")
    disk = shutil.disk_usage(root)
    print(f"trainer: temp dir {root}, {disk.free / 1e9:.1f} GB free of "
          f"{disk.total / 1e9:.1f} GB", flush=True)
    t_phase = time.perf_counter()

    def stack(name, cfg, monitor, ckpt_every):
        fabric = Fabric(FabricSpec(sites=(
            SiteSpec("home", root=os.path.join(root, name, "home")),
            SiteSpec("site", root=os.path.join(root, name, "site")))))
        s = fabric.login("trainer",
                         mounts=[MountSpec("home/", ("home/scratch/",))])
        SyntheticCorpus(s.client, "home/data", seed=0, vocab=cfg.vocab_size,
                        shard_tokens=shard_tokens).materialize(TRAINER_SHARDS)
        pipe = DataPipeline(s.client, "home/data", cfg, batch=B, seq=S,
                            n_shards=TRAINER_SHARDS, device="cuda")
        run = train_run(cfg, batch=B, seq=S, state_dtype="int8",
                        warmup_steps=1)
        tr = Trainer(run, pipe, CheckpointManager(s.client, "home/ckpt"),
                     monitor=monitor, ckpt_every=ckpt_every, device="cuda")
        return tr, s, fabric.network

    try:
        # (a) full width, TRAINER_LAYERS deep: the loop's own cost beside
        # the bare step
        cfg = get_config(TRAIN_ARCH).replace(num_layers=TRAINER_LAYERS,
                                             param_dtype="float32",
                                             dtype="bfloat16", remat="full",
                                             layers_per_step=1)
        tr, s, net = stack("full", cfg, None, ckpt_every=1000)
        tr.initialize()
        warm = tr.train(1)      # the first step pays first-use costs
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = tr.train(TRAINER_STEPS)
        torch.cuda.synchronize()
        full_ms = (time.perf_counter() - t0) / TRAINER_STEPS * 1e3
        t0 = time.perf_counter()
        for _ in range(TRAINER_STEPS):      # bare: the step on a fresh batch
            tr.params, tr.opt_state, _ = tr.step_fn(
                tr.params, tr.opt_state, tr.pipeline.next_batch())
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) / TRAINER_STEPS * 1e3
        full_losses = warm.losses + res.losses
        full_peak = torch.cuda.max_memory_allocated() / 1e9
        if not all(math.isfinite(x) for x in full_losses) or \
                res.checkpoints or warm.checkpoints:
            raise AssertionError(f"{cfg.num_layers}-layer trainer: losses "
                                 f"{full_losses}, checkpoints "
                                 f"{warm.checkpoints + res.checkpoints}")
        full = dict(layers=cfg.num_layers, params=n_params(tr.params),
                    losses=full_losses, ms_per_step=full_ms,
                    bare_step_ms=bare_ms, loop_overhead_ms=full_ms - bare_ms,
                    max_memory_allocated_gb=full_peak,
                    wan_clock_s=net.clock)
        print(f"trainer at {cfg.num_layers} layers: {full_ms:.1f} ms a step "
              f"through the Trainer, {bare_ms:.1f} bare; peak "
              f"{full_peak:.1f} GB", flush=True)
        del tr, s, net, warm, res
        gc.collect()
        torch.cuda.empty_cache()

        # (b) 2 layers: a straggle at step 1, a crash at step 3, a save
        # every 2 steps, each part of every loop iteration timed
        cfg2 = cfg.replace(num_layers=TRAIN_CHECK_LAYERS)
        mon = FaultMonitor(n_workers=4, schedule=[
            FaultEvent(step=1, worker=1, kind="straggle", duration=1),
            FaultEvent(step=3, worker=2, kind="crash")])
        tr, s, net = stack("faults", cfg2, mon, ckpt_every=2)
        tr.initialize()
        state_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(tr._state_tree()))
        need = 2 * 3 * state_bytes    # 2 saves, ~3 copies each on disk
        free = shutil.disk_usage(root).free
        if free < need:
            raise AssertionError(f"trainer: {free / 1e9:.1f} GB free in "
                                 f"{root}, the 2 saves need "
                                 f"~{need / 1e9:.1f} GB")
        iters, cur = [], {}
        saved_cursor, after_restore = [], {}

        def timed(name, fn, sync=False):
            def wrapper(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                if sync:
                    torch.cuda.synchronize()
                cur[name] = cur.get(name, 0.0) + time.perf_counter() - t
                return out
            return wrapper

        begin, next_batch = mon.begin_step, tr.pipeline.next_batch
        pump, save, restore = s.client.pump, tr.save_checkpoint, \
            tr.restore_latest

        def begin_step(step):
            if cur:
                cur["wall_s"] = time.perf_counter() - cur.pop("t0")
                iters.append(dict(cur))
            cur.clear()
            cur.update(step=step, t0=time.perf_counter())
            return begin(step)

        def pumping(*a, **kw):
            cur["wal_pending"] = len(s.client.oplog.pending())
            return pump(*a, **kw)

        def batching():
            if "cursor" in after_restore and "batch" not in after_restore:
                after_restore["batch"] = tr.pipeline.state()["cursor"]
                out = next_batch()
                after_restore["tokens"] = out["tokens"].cpu().numpy()
                return out
            return next_batch()

        def saving():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            save()
            cur["save_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            cur["save_extra_gb"] = (torch.cuda.max_memory_allocated() -
                                    base) / 1e9
            saved_cursor.append((tr.step, tr.pipeline.state()["cursor"]))

        def restoring():
            ok = restore()
            # its client.sync() drains the WAL through the wrapped pump
            cur["restore_sync_s"] = cur.pop("pump_s", 0.0)
            cur.pop("wal_pending", None)
            after_restore["cursor"] = tr.pipeline.state()["cursor"]
            after_restore["step"] = tr.step
            return ok

        mon.begin_step = begin_step
        tr.pipeline.next_batch = timed("next_batch_s", batching)
        tr.step_fn = timed("step_s", tr.step_fn, sync=True)
        s.client.pump = timed("pump_s", pumping)
        s.client.pump_callbacks = timed("pump_callbacks_s",
                                        s.client.pump_callbacks)
        tr.save_checkpoint = timed("save_s", saving)
        tr.restore_latest = timed("restore_s", restoring)
        t0 = time.perf_counter()
        res = tr.train(4)
        torch.cuda.synchronize()
        cur["wall_s"] = time.perf_counter() - cur.pop("t0")
        iters.append(dict(cur))
        train_s = time.perf_counter() - t0
        fault_losses = res.losses
        if res.restarts != 1 or mon.dropped_syncs != 1 or tr.step != 4 or \
                res.checkpoints != [2, 4] or \
                not all(math.isfinite(x) for x in fault_losses):
            raise AssertionError(
                f"trainer with faults: restarts {res.restarts}, dropped "
                f"syncs {mon.dropped_syncs}, step {tr.step}, checkpoints "
                f"{res.checkpoints}, losses {fault_losses}; want 1, 1, 4, "
                "[2, 4], finite")
        at2 = dict(saved_cursor)[2]
        if after_restore.get("cursor") != at2 or \
                after_restore.get("batch") != at2:
            raise AssertionError(f"the cursor after the restore "
                                 f"{after_restore.get('cursor')}, its next "
                                 f"batch read at {after_restore.get('batch')}"
                                 f"; saved at step 2: {at2}")
        want = corpus_tokens(at2, B * S + 1, shard_tokens, TRAINER_SHARDS,
                             cfg2.vocab_size)[:-1].reshape(B, S)
        if not (after_restore["tokens"] == want).all():
            raise AssertionError("the batch read after the restore is not "
                                 "the corpus at the step-2 cursor")
        # the step-4 checkpoint drained as the steps after a save drain it,
        # pump_ops_per_step ops a call: each call's host seconds and bytes
        train_wan_s, train_bytes = net.clock, net.bytes_sent
        drain_ms, drain_bytes, drain_wan, heaviest = [], [], [], None
        while s.client.oplog.pending():
            names = [r.path.split("/", 3)[-1]
                     for r in s.client.oplog.pending()[:tr.pump_ops_per_step]]
            b0, c0, t = net.bytes_sent, net.clock, time.perf_counter()
            if not pump(max_ops=tr.pump_ops_per_step):
                raise AssertionError(f"the pump completed no op of {names}")
            drain_ms.append((time.perf_counter() - t) * 1e3)
            drain_bytes.append(net.bytes_sent - b0)
            drain_wan.append(net.clock - c0)
            if drain_ms[-1] == max(drain_ms):
                heaviest = names
        steps_timed = [it for it in iters if "step_s" in it]
        busy = [it for it in steps_timed if it["wal_pending"]]
        idle = [it for it in steps_timed if not it["wal_pending"]]

        def mean_ms(rows):
            # a step's wall time without its save (the pump is part of it)
            return sum((r["wall_s"] - r.get("save_s", 0.0)) for r in rows) \
                / max(len(rows), 1) * 1e3

        faults = dict(layers=cfg2.num_layers, params=n_params(tr.params),
                      state_bytes=state_bytes, losses=fault_losses,
                      restarts=res.restarts,
                      dropped_syncs=mon.dropped_syncs,
                      checkpoints=res.checkpoints,
                      saved_cursors=saved_cursor,
                      cursor_after_restore=after_restore["cursor"],
                      train_s=train_s, train_wan_s=train_wan_s,
                      train_bytes_sent=train_bytes, wan_clock_s=net.clock,
                      bytes_sent=net.bytes_sent, iterations=iters,
                      step_ms_pump_busy=mean_ms(busy),
                      step_ms_pump_idle=mean_ms(idle[1:]),
                      first_step_ms=mean_ms(idle[:1]),
                      steps_pump_busy=len(busy),
                      steps_pump_idle=len(idle) - 1,
                      drain_calls=len(drain_ms), drain_ms=drain_ms,
                      drain_bytes=drain_bytes, drain_wan_s=drain_wan,
                      drain_s=sum(drain_ms) / 1e3,
                      drain_max_ms=max(drain_ms),
                      drain_heaviest_ops=heaviest,
                      save_peak_gb=max(it.get("save_peak_gb", 0.0)
                                       for it in iters),
                      save_extra_gb=max(it.get("save_extra_gb", 0.0)
                                        for it in iters))
        print("trainer iterations " + json.dumps(iters), flush=True)

        # (c) a fresh trainer restores cold: step 4, every leaf bit for bit;
        # then the eval step on the restored params through flash (f32)
        cold = Trainer(tr.run, DataPipeline(
            s.client, "home/data", cfg2, batch=B, seq=S,
            n_shards=TRAINER_SHARDS, device="cuda"), tr.ckpt, device="cuda")
        cold.initialize()
        t0 = time.perf_counter()
        if not cold.restore_latest():
            raise AssertionError("cold restore found no checkpoint")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        if cold.step != 4 or cold.pipeline.state() != tr.pipeline.state():
            raise AssertionError(f"cold restore at step {cold.step}, cursor "
                                 f"{cold.pipeline.state()}; want 4, "
                                 f"{tr.pipeline.state()}")
        n_leaves = assert_trees_equal(torch, cold._state_tree(),
                                      tr._state_tree(), "cold restore")
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        batch = cold.pipeline.next_batch()
        ev32 = cfg2.replace(dtype="float32")
        reset_flash(fa)
        ev_k = make_eval_step(train_run(ev32.replace(attention_impl="pallas"),
                                        batch=B, seq=S))(cold.params, batch)
        torch.cuda.synchronize()
        by_route = flash_on_route(fa, cfg2.num_layers,
                                  "eval step on the restored params",
                                  route="f32")
        ev_x = make_eval_step(train_run(ev32, batch=B, seq=S))(cold.params,
                                                               batch)
        eval_err = abs(float(ev_k["ce"]) - float(ev_x["ce"])) / \
            abs(float(ev_x["ce"]))
        if eval_err > 1e-4:
            raise AssertionError(f"eval ce on flash {float(ev_k['ce'])} vs "
                                 f"plain {float(ev_x['ce'])}: {eval_err} > "
                                 "1e-4")
        restored = dict(step=cold.step, leaves=n_leaves, restore_s=cold_s,
                        eval_ce=float(ev_k["ce"]),
                        eval_ce_plain_path=float(ev_x["ce"]),
                        eval_ce_rel_err=eval_err,
                        flash_launches=fa.flash_attention.launches,
                        flash_launches_by_route=by_route)
        del cold, batch, ev_k, ev_x, s, net
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the launcher, in its own process on the card
        launcher = train_launcher(torch, TRAIN_ARCH,
                                  os.path.join(root, "launcher"))
        if not launcher["last_loss"] < launcher["first_loss"]:
            raise AssertionError(f"launcher loss did not fall: {launcher}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(card=card, arch=TRAIN_ARCH, batch=B, seq=S,
               microbatches=TRAIN_MICRO, state_dtype="int8",
               shard_tokens=shard_tokens, shards=TRAINER_SHARDS,
               disk_free_gb=disk.free / 1e9, disk_total_gb=disk.total / 1e9,
               timed=full, faults=faults, cold_restore=restored,
               launcher=launcher, seconds=time.perf_counter() - t_phase)
    print("trainer " + json.dumps(res), flush=True)
    return res


def prompt_of(batch, n_text):
    """The batch's frames (or patches) with its first ``n_text`` tokens."""
    out = {"frontend": batch["frontend"],
           "tokens": batch["tokens"][:, :n_text]}
    pos = batch["positions"]
    n_pos = pos.shape[-1] - batch["tokens"].shape[1] + n_text
    out["positions"] = pos[..., :n_pos]
    return out


class FlashRows:
    """Records the query rows of every model call to ``ops.flash_attention``
    while it is entered (the launch counts stay the wrapper's)."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.real, self.rows = ops, ops.flash_attention, []

    def __enter__(self):
        def recording(q, k, v, **kw):
            self.rows.append(int(q.shape[1]))
            return self.real(q, k, v, **kw)
        self.ops.flash_attention = recording
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.real


def decode_ticks(torch, cfg, params, logits, cache, n, feed=None):
    """``n`` decode steps after a prefill's ``logits``: greedy, or fed the
    tokens ``feed`` [B, n + 1] (a greedy run's).  Returns (tokens [B, n +
    1], the logits of each step, host ms of each synchronised step, the
    cache)."""
    from repro_torch.models import decode_step
    toks = [logits[:, -1].argmax(-1, keepdim=True)]
    if feed is not None:
        toks = [feed[:, :1]]
    steps, tick_ms = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = decode_step(cfg, params, toks[-1], cache)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t) * 1e3)
        steps.append(logits[:, 0].float())
        toks.append(logits[:, -1].argmax(-1, keepdim=True)
                    if feed is None else feed[:, i + 1:i + 2])
    return torch.cat(toks, dim=1), steps, tick_ms, cache


def scoring_phase(torch, cfg, params, batch, want_flash: int):
    """forward and loss_fn on ``batch``, after a warm-up of each: host ms
    of each (synchronised), the flash launches by route (each
    ``want_flash``, all wgmma), finite logits, peak memory, a profile."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import forward, loss_fn
    loss_fn(cfg, params, batch)                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash(fa)
    t = time.perf_counter()
    logits, _ = forward(cfg, params, batch)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t) * 1e3
    by_route = flash_on_route(fa, want_flash, f"{cfg.name} forward")
    B = batch["tokens"].shape[0]
    S = batch["positions"].shape[-1]
    if tuple(logits.shape) != (B, S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad forward logits {tuple(logits.shape)}")
    del logits
    t = time.perf_counter()
    loss, metrics = loss_fn(cfg, params, batch)
    torch.cuda.synchronize()
    loss_ms = (time.perf_counter() - t) * 1e3
    flash_on_route(fa, 2 * want_flash, f"{cfg.name} forward and loss")
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"non-finite loss {float(loss)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_call(torch, lambda: forward(cfg, params, batch),
                        f"{cfg.name} forward")
    return dict(forward_ms=forward_ms, loss_fn_ms=loss_ms, loss=float(loss),
                ce=float(metrics["ce"]), scored_tokens=int(metrics["tokens"]),
                flash_launches=want_flash, flash_launches_by_route=by_route,
                max_memory_allocated_gb=peak_gb, profile=prof)


def prefill_decode_phase(torch, cfg, params, prompt, max_len: int,
                         want_prefill: int, want_tick: int):
    """A timed prefill of ``prompt`` (``want_prefill`` flash launches,
    wgmma) and MAX_NEW greedy decode ticks (``want_tick`` flash launches a
    tick, each with one query row); ms of each, finite logits, and a
    profiled tick after them."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import decode_step, prefill
    prefill(cfg, params, prompt, max_len=max_len)    # warm-up
    torch.cuda.synchronize()
    reset_flash(fa)
    t = time.perf_counter()
    logits, cache = prefill(cfg, params, prompt, max_len=max_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    flash_on_route(fa, want_prefill, f"{cfg.name} prefill")
    index = int(cache["index"][0])
    with FlashRows() as rows:
        toks, steps, tick_ms, cache = decode_ticks(torch, cfg, params,
                                                   logits, cache, MAX_NEW)
    if fa.flash_attention.launches != want_prefill + want_tick * MAX_NEW or \
            any(r != 1 for r in rows.rows):
        raise AssertionError(f"{MAX_NEW} decode ticks: "
                             f"{fa.flash_attention.launches - want_prefill} "
                             f"flash launches, query rows "
                             f"{sorted(set(rows.rows))}; want "
                             f"{want_tick} a tick, each one row")
    if not all(bool(torch.isfinite(s).all()) for s in steps):
        raise AssertionError("non-finite decode logits")
    ticks = sorted(tick_ms[1:])
    prof = profile_call(torch, lambda: decode_step(cfg, params, toks[:, -1:],
                                                   cache),
                        f"{cfg.name} decode_tick")
    return dict(prefill_ms=prefill_ms, index=index,
                flash_launches_prefill=want_prefill,
                flash_launches_per_tick=want_tick,
                decode_ms_per_tick_mean=sum(tick_ms[1:]) / len(ticks),
                decode_ms_per_tick_median=ticks[len(ticks) // 2],
                first_tick_ms=tick_ms[0], tokens=toks[0, :8].tolist(),
                profile=prof)


def f32_paths_phase(torch, cfg, batch, prompt, max_len: int, what: str):
    """``cfg`` (cut to a few layers) in f32 on the kernel path against the
    plain attention path: forward logits, prefill logits and 8 decode
    steps fed the kernel path's greedy tokens, each within 1e-4 of the
    logits' scale; the greedy tokens equal."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import forward, prefill
    c32 = cfg.replace(dtype="float32", param_dtype="float32")
    p32 = seeded_params(torch, c32)
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in batch.items()}
    prompt = {k: v.float() if v.is_floating_point() else v
              for k, v in prompt.items()}
    plain = c32.replace(attention_impl="xla")
    reset_flash(fa)
    lo_k, lo_x = forward(c32, p32, batch)[0], forward(plain, p32, batch)[0]
    fwd_launches = dict(fa.flash_attention.route_launches)
    errs = {"forward": scaled_err(lo_k, lo_x)}
    del lo_k, lo_x
    pk, ck = prefill(c32, p32, prompt, max_len=max_len)
    px, cx = prefill(plain, p32, prompt, max_len=max_len)
    errs["prefill"] = scaled_err(pk[:, -1].float(), px[:, -1].float())
    toks, steps_k, _, _ = decode_ticks(torch, c32, p32, pk, ck, 8)
    _, steps_x, _, _ = decode_ticks(torch, plain, p32, px, cx, 8, feed=toks)
    errs["decode"] = max(scaled_err(a, b) for a, b in zip(steps_k, steps_x))
    same = all(torch.equal(s.argmax(-1), toks[:, i + 1])
               for i, s in enumerate(steps_x)) and \
        torch.equal(px[:, -1].argmax(-1), toks[:, 0])
    if max(errs.values()) > 1e-4 or not same:
        raise AssertionError(f"{what} f32: kernel vs plain path scaled "
                             f"errors {errs} (limit 1e-4), greedy tokens "
                             f"equal: {same}")
    if fwd_launches["f32"] == 0:
        raise AssertionError(f"{what} f32 forward ran no f32 flash kernel")
    res = dict(layers=c32.num_layers, params=n_params(p32),
               scaled_err=errs, greedy_tokens_equal=same,
               flash_launches_by_route=dict(fa.flash_attention.route_launches),
               tokens=toks[0].tolist())
    del p32
    return res


def encdec(torch, card: str):
    """Full-width, full-depth seamless-m4t-medium (12 + 12 layers, bf16,
    seed 0, attention_impl "pallas"): forward and loss with 1024 frames
    and 1024 text tokens a sequence (36 flash launches: 12 encoder, 12
    decoder self, 12 cross), prefill of 64-token prompts (36) then 32
    decode ticks (12 a tick, one query row each), the f32 check at 2 + 2
    layers, and 3 train steps at full depth on the plain path."""
    from repro_torch.configs import get_config
    from repro_torch.train import make_opt_state, make_train_step
    cfg = get_config(ENCDEC_ARCH).replace(param_dtype="bfloat16",
                                          attention_impl="pallas")
    L = cfg.encoder_layers + 2 * cfg.decoder_layers
    params = seeded_params(torch, cfg)
    n = n_params(params)
    batch = scoring_batch(torch, cfg, ENCDEC_BATCH, ENCDEC_SEQ)
    prompt = prompt_of(batch, ENCDEC_PROMPT)
    with torch.inference_mode():
        score = scoring_phase(torch, cfg, params, batch, L)
        serve = prefill_decode_phase(
            torch, cfg, params, prompt, ENCDEC_PROMPT + MAX_NEW + 1, L,
            cfg.decoder_layers)
        if serve["index"] != ENCDEC_PROMPT:
            raise AssertionError(f"prefill index {serve['index']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with torch.inference_mode():
        small = cfg.replace(encoder_layers=2, decoder_layers=2, num_layers=4)
        f32 = f32_paths_phase(torch, small, batch, prompt,
                              ENCDEC_PROMPT + MAX_NEW + 1, cfg.name)
    gc.collect()
    torch.cuda.empty_cache()

    # training at full depth on the plain path (the kernels have no
    # backward): f32 params, bf16 activations, remat "full", int8 moments
    tcfg = cfg.replace(param_dtype="float32", dtype="bfloat16",
                       attention_impl="xla", remat="full")
    run = train_run(tcfg, batch=TRAIN_BATCH, seq=ENCDEC_SEQ,
                    state_dtype="int8", warmup_steps=1)
    tparams = seeded_params(torch, tcfg)
    opt = make_opt_state(run, tparams)
    tbatch = scoring_batch(torch, tcfg, TRAIN_BATCH, ENCDEC_SEQ)
    step = make_train_step(run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(ENCDEC_TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tparams, opt, metrics = step(tparams, opt, tbatch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{cfg.name} train losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_call(torch, lambda: step(tparams, opt, tbatch),
                        f"{cfg.name} train_step", top=10)
    train = dict(batch=TRAIN_BATCH, seq=ENCDEC_SEQ, microbatches=TRAIN_MICRO,
                 remat=tcfg.remat, state_dtype="int8", losses=losses,
                 step_ms=step_ms,
                 ms_per_step=sum(step_ms[1:]) / len(step_ms[1:]),
                 max_memory_allocated_gb=peak_gb, profile=prof)
    del tparams, opt
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(card=card, arch=cfg.name, layers=[cfg.encoder_layers,
                                                 cfg.decoder_layers],
               params=n, batch=ENCDEC_BATCH, frames=ENCDEC_SEQ,
               text=ENCDEC_SEQ, prompt=ENCDEC_PROMPT,
               tokens_per_s=ENCDEC_BATCH * ENCDEC_SEQ
               / score["forward_ms"] * 1e3, **score, serve=serve, f32=f32,
               train=train)
    print("encdec " + json.dumps(res), flush=True)
    return res


def vlm(torch, card: str):
    """Full-width qwen2-vl-72b at VLM_LAYERS of its 80 layers (bf16, seed 0,
    attention_impl "pallas"): forward and loss on 2 x 2048 positions (512
    patches of 8192 features, then 1536 text tokens; M-RoPE positions
    [3, 2, 2048]; a flash launch a layer), prefill of one such sequence
    (index 2048) then 32 decode ticks ([3, 1, 1] positions; decode
    attention is plain, as in the reference), and the f32 check at 2
    layers."""
    from repro_torch.configs import get_config
    cfg = get_config(VLM_ARCH).replace(num_layers=VLM_LAYERS,
                                       param_dtype="bfloat16",
                                       attention_impl="pallas")
    params = seeded_params(torch, cfg)
    n = n_params(params)
    batch = scoring_batch(torch, cfg, VLM_BATCH, VLM_SEQ)
    one = {k: v[:, :1] if k == "positions" else v[:1]
           for k, v in batch.items()}
    with torch.inference_mode():
        score = scoring_phase(torch, cfg, params, batch, cfg.num_layers)
        serve = prefill_decode_phase(torch, cfg, params, one,
                                     VLM_SEQ + MAX_NEW + 1, cfg.num_layers, 0)
    if serve["index"] != VLM_SEQ:
        raise AssertionError(f"prefill index {serve['index']}, want "
                             f"{VLM_SEQ} (patches + text)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with torch.inference_mode():
        f32 = f32_paths_phase(torch, cfg.replace(num_layers=2), batch, one,
                              VLM_SEQ + MAX_NEW + 1, cfg.name)
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(card=card, arch=cfg.name, layers=cfg.num_layers, params=n,
               batch=VLM_BATCH, seq=VLM_SEQ,
               patches=batch["frontend"].shape[1],
               text=batch["tokens"].shape[1],
               tokens_per_s=VLM_BATCH * VLM_SEQ / score["forward_ms"] * 1e3,
               **score, serve=serve, f32=f32)
    print("vlm " + json.dumps(res), flush=True)
    return res


def train_launcher(torch, arch: str, workdir: str) -> dict:
    """``python -m repro_torch.launch.train --tiny --arch arch`` on the
    card in its own process, 12 steps with a crash at step 6 and a save
    every 4: exit 0, restarts=1, the card's name printed, finite losses.
    Returns its seconds, restarts and first and last losses."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--tiny",
         "--arch", arch, "--steps", "12", "--ckpt-every", "4",
         "--inject-crash-at", "6", "--workdir", workdir],
        env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    print(out.stdout, end="", flush=True)
    m = re.search(r"restarts=(\d+) loss ([-\d.na]+) -> ([-\d.na]+)",
                  out.stdout)
    name = torch.cuda.get_device_name(0)
    if out.returncode or not m or m.group(1) != "1" or \
            f"device={name}" not in out.stdout or \
            not all(math.isfinite(float(x)) for x in m.group(2, 3)):
        raise AssertionError(f"launcher {arch}: exit {out.returncode}, "
                             f"output {out.stdout!r}, errors "
                             f"{out.stderr[-2000:]!r}")
    return dict(seconds=seconds, restarts=int(m.group(1)),
                first_loss=float(m.group(2)), last_loss=float(m.group(3)))


def tiny_train_launchers(torch):
    """The training launcher for the enc-dec and VLM archs, tiny, on the
    card (``train_launcher``), each in a temp dir it removes."""
    import tempfile
    res = {}
    for arch in (ENCDEC_ARCH, VLM_ARCH):
        with tempfile.TemporaryDirectory(prefix="xufs_train_") as root:
            res[arch] = train_launcher(torch, arch, root)
    print("train --tiny " + json.dumps(res), flush=True)
    return res


QUICKSTART_PROMPTS = ([1, 2, 3], [9, 8, 7, 6])


def _load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _top2_gap(torch, cfg, params, tokens) -> float:
    """The gap between the two largest last-position logits of a prefill
    of ``tokens`` on ``cfg``'s path."""
    from repro_torch.models import prefill
    batch = {"tokens": torch.tensor([tokens], dtype=torch.long,
                                    device="cuda"),
             "positions": torch.arange(len(tokens), dtype=torch.int32,
                                       device="cuda")[None]}
    logits, _ = prefill(cfg, params, batch, max_len=len(tokens))
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def quickstart(torch, card: str) -> dict:
    """Phase 18b (module docstring): the quickstart's own run, then its
    requests again on the flash kernel, the prefill logits of both runs
    recorded by wrapping the engine's ``prefill``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import engine as engine_mod
    qs = _load_example("quickstart_torch")
    real_prefill = engine_mod.prefill
    seen = []

    def recorded(cfg_, p, batch, max_len):
        logits, cache = real_prefill(cfg_, p, batch, max_len=max_len)
        seen.append(logits.float())
        return logits, cache

    engine_mod.prefill = recorded
    try:
        t0 = time.perf_counter()
        out = qs.main(["--device", "cuda"])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        plain, seen = seen, []
        cfg = out.cfg.replace(attention_impl="pallas")
        reset_flash(fa)
        t1 = time.perf_counter()
        eng = engine_mod.ServeEngine(cfg, out.trainer.params, slots=2,
                                     max_len=64, device="cuda")
        for rid, prompt in enumerate(QUICKSTART_PROMPTS):
            eng.add_request(engine_mod.Request(rid=rid, prompt=prompt,
                                               max_new_tokens=8))
        eng.run_until_done()
        torch.cuda.synchronize()
        flash_s = time.perf_counter() - t1
        launches = dict(fa.flash_attention.route_launches)
        n_flash = fa.flash_attention.launches
    finally:
        engine_mod.prefill = real_prefill
    if out.engine.cfg.attention_impl != "xla":
        raise AssertionError("the quickstart served on "
                             f"{out.engine.cfg.attention_impl!r}")
    if n_flash == 0 or launches["mma_sync"] != n_flash:
        raise AssertionError(f"quickstart on pallas: {n_flash} flash "
                             f"launches by route {launches}, want > 0, "
                             "all mma_sync")
    if len(plain) != len(QUICKSTART_PROMPTS) or len(seen) != len(plain):
        raise AssertionError(f"{len(plain)} and {len(seen)} prefills for "
                             f"{len(QUICKSTART_PROMPTS)} requests")
    errs = []
    for got, want in zip(seen, plain):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("non-finite prefill logits on pallas")
        errs.append(rms_rel_err(torch, got, want))
    if max(errs) > RMS_TOL["bfloat16"]:
        raise AssertionError(f"quickstart prefill logits on flash: "
                             f"relative RMS {errs} > {RMS_TOL['bfloat16']}")
    tokens = {"xla": [out.engine.requests[r].output
                      for r in range(len(QUICKSTART_PROMPTS))],
              "pallas": [eng.requests[r].output
                         for r in range(len(QUICKSTART_PROMPTS))]}
    flips = []
    for r, prompt in enumerate(QUICKSTART_PROMPTS):
        a, b = tokens["xla"][r], tokens["pallas"][r]
        if len(b) != len(a) or not eng.requests[r].done:
            raise AssertionError(f"request {r} on pallas: {b}")
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            ctx = list(prompt) + a[:j]
            with torch.no_grad():
                flips.append(dict(
                    request=r, position=j, xla=a[j], pallas=b[j],
                    xla_gap=_top2_gap(torch, out.cfg, out.trainer.params,
                                      ctx),
                    pallas_gap=_top2_gap(torch, cfg, out.trainer.params,
                                         ctx)))
    res = out.result
    summary = dict(
        card=card, loss_first=res.losses[0], loss_last=res.losses[-1],
        checkpoints=res.checkpoints, restarts=res.restarts,
        wan_s=out.network.clock, bytes_shipped=out.network.bytes_sent,
        main_s=main_s, flash_serve_s=flash_s, flash_launches=n_flash,
        flash_launches_by_route=launches, prefill_rms_rel_err=errs,
        tokens=tokens, flips=flips)
    if not all(math.isfinite(x) for x in res.losses) or \
            res.losses[-1] >= res.losses[0]:
        raise AssertionError(f"quickstart losses {res.losses}")
    print("quickstart " + json.dumps(summary), flush=True)
    return summary


def tiny_serve(torch):
    """``python -m repro_torch.launch.serve --tiny`` on the card, for the
    dense default and the two families that fit one card only tiny: the
    tiny configs' head dim 16 takes the flash kernel's mma.sync route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as serve_mod
    res = {}
    for arch in (ARCH, "dbrx-132b", JAMBA_ARCH):
        reset_flash(fa)
        argv = sys.argv
        sys.argv = ["serve", "--tiny", "--arch", arch]
        try:
            serve_mod.main()
        finally:
            sys.argv = argv
        n = fa.flash_attention.launches
        if n == 0:
            raise AssertionError(f"tiny {arch} served without the flash "
                                 "kernel")
        res[arch] = flash_on_route(fa, n, f"tiny {arch} serving",
                                   route="mma_sync")
    print("tiny serve " + json.dumps(res), flush=True)
    return res


def ep_rank(rank: int, job: dict, results) -> None:
    """One of phase 19's ranks, in its own process: joins the group, then
    ``ep_rank_work``; its result (or its traceback) goes to ``results``."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    try:
        dev = torch.device("cuda", rank if job["backend"] == "nccl" else 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            job["backend"], store=dist.FileStore(job["store"], EP_RANKS),
            rank=rank, world_size=EP_RANKS,
            timeout=datetime.timedelta(seconds=EP_PG_TIMEOUT))
        try:
            res = ep_rank_work(torch, rank, dev, job)
        finally:
            dist.destroy_process_group()
            job.clear()       # the parent's shared tensors: as sharded_rank
            gc.collect()
        results.put((rank, res))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise SystemExit(1)


def ep_rank_work(torch, rank: int, dev, job: dict) -> dict:
    """dbrx-132b's MoE layer on the (data=1, model=4) mesh, a warm-up call
    then a timed one (CUDA events around the layer, each all-to-all and
    the expert products), then the f32 case on a (data=2, model=2) mesh;
    each output is written into the parent's tensor."""
    import torch.distributed as dist
    from repro_torch.kernels import gmm as gm
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import ep_moe as ep

    # gloo's all-to-all on CUDA tensors, at a small size first
    mesh = make_test_mesh(1, EP_RANKS, device_type="cuda")
    probe = torch.arange(EP_RANKS, device=dev, dtype=torch.float32) \
        + 10 * rank
    got = ep._all_to_all(probe, mesh.get_group("model"))
    want = torch.arange(EP_RANKS, device=dev, dtype=torch.float32) * 10 \
        + rank
    if not got.is_cuda or not torch.equal(got, want):
        raise AssertionError(f"all_to_all_single on {job['backend']}: "
                             f"{got.tolist()} != {want.tolist()}")

    cfg = job["cfg"]
    x = job["x"].to(dev)
    lp = {k: v.to(dev) for k, v in
          ep.local_params(job["params"], mesh).items()}
    for name, t in [("x", x)] + list(lp.items()):
        if not t.is_cuda:
            raise AssertionError(f"rank {rank}: {name} on {t.device}")
    marks = {"a2a": [], "experts": []}
    routing = {}
    real_a2a, real_ffn, real_pack = ep._all_to_all, ep._expert_ffn, \
        ep._local_pack

    def timed(key, fn):
        def wrapper(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            marks[key].append((s, e))
            return out
        return wrapper

    def recording(cfg_, logits, xf, n, cap):
        top, ids = torch.topk(torch.softmax(logits.float(), -1),
                              cfg_.moe.experts_per_token + 1, dim=-1)
        pack = real_pack(cfg_, logits, xf, n, cap)
        routing.update(ids=ids[:, :-1].sort(-1).values.cpu().numpy(),
                       gap=(top[:, -2] - top[:, -1]).cpu().numpy(),
                       keep=pack.keep.cpu().numpy(), cap=cap)
        return pack

    sizes = []
    real_gmm_sorted = ep.kops.gmm_sorted

    def gmm_sizes(lhs, rhs, group_sizes):
        sizes.append(group_sizes.tolist())
        return real_gmm_sorted(lhs, rhs, group_sizes)

    ep._all_to_all = timed("a2a", real_a2a)
    ep._expert_ffn = timed("experts", real_ffn)
    ep._local_pack = recording
    ep.kops.gmm_sorted = gmm_sizes
    try:
        with torch.no_grad():
            ep.ep_moe_apply(cfg, lp, x, mesh)            # warm-up
            torch.cuda.synchronize()
            for v in marks.values():
                v.clear()
            sizes.clear()
            torch.cuda.reset_peak_memory_stats(dev)
            gm.gmm.launches = 0
            gm.gmm.route_launches = dict.fromkeys(gm.ROUTES, 0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            y = ep.ep_moe_apply(cfg, lp, x, mesh)
            end.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            launches = gm.gmm.launches
            by_route = dict(gm.gmm.route_launches)
            if not y.is_cuda:
                raise AssertionError(f"rank {rank}: output on {y.device}")
            job["out"][rank].copy_(y)
            torch.cuda.synchronize()
            res = dict(
                rank=rank, device=str(dev), layer_ms=start.elapsed_time(end),
                host_ms=host_ms,
                a2a_ms=[s.elapsed_time(e) for s, e in marks["a2a"]],
                experts_ms=[s.elapsed_time(e) for s, e in marks["experts"]],
                gmm_launches=launches, gmm_route_launches=by_route,
                group_sizes=sizes[0], filled_slots=int(sum(sizes[0])),
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                routing=dict(routing) if rank == 0 else None)
            del y, lp, x
            torch.cuda.empty_cache()

            # the f32 case: drop-free on a (data=2, model=2) mesh
            mesh22 = make_test_mesh(*EP_F32_MESH, device_type="cuda")
            b = mesh22.get_local_rank("data")
            x32 = job["x32"].to(dev)
            b_loc = x32.shape[0] // EP_F32_MESH[0]
            p32 = {k: v.to(dev) for k, v in
                   ep.local_params(job["p32"], mesh22).items()}
            gm.gmm.launches = 0
            gm.gmm.route_launches = dict.fromkeys(gm.ROUTES, 0)
            y32 = ep.ep_moe_apply(job["cfg32"], p32,
                                  x32[b * b_loc:(b + 1) * b_loc], mesh22,
                                  capacity_factor=EP_F32_CF)
            torch.cuda.synchronize()
            job["out32"][rank].copy_(y32)
            torch.cuda.synchronize()
            res.update(f32_coord=mesh22.get_coordinate(),
                       f32_gmm_route_launches=dict(gm.gmm.route_launches))
    finally:
        ep._all_to_all, ep._expert_ffn, ep._local_pack = \
            real_a2a, real_ffn, real_pack
        ep.kops.gmm_sorted = real_gmm_sorted
    return res


def run_ep_ranks(torch, job: dict) -> list:
    """Spawn the EP_RANKS ranks on ``job``; each rank's result, or raise
    if a rank fails or is still running after EP_LIMIT seconds (then it is
    killed)."""
    import queue
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=ep_rank, args=(r, job, results))
             for r in range(EP_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + EP_LIMIT
    got = {}
    while len(got) < EP_RANKS and time.monotonic() < deadline:
        try:
            rank, res = results.get(timeout=5.0)
        except queue.Empty:
            if any(p.exitcode not in (None, 0) for p in procs):
                break         # a rank died before it could report
            continue
        got[rank] = res
        if "error" in res:
            break
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(10)
    errors = {r: res["error"] for r, res in got.items() if "error" in res}
    if hung or errors or len(got) < EP_RANKS or \
            any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"EP ranks: hung {hung}, exit codes "
            f"{[p.exitcode for p in procs]}, results from {sorted(got)}\n"
            + "\n".join(f"--- rank {r} ---\n{e}" for r, e in errors.items()))
    return [got[r] for r in range(EP_RANKS)]


def ep_gmm_case(torch, gm, sizes, K: int, N: int, what: str) -> dict:
    """The gmm kernel at one EP rank's products: its received rows sorted
    by local expert (``sizes``, the empty slots past the groups) against
    the plain version in f32 (4e-3 scaled, as ``gmm_cases``); kernel,
    plain and ``torch.bmm`` times (bmm over equal groups of M / G rows,
    the same FLOPs' dense layout) and the bound of these rows."""
    G = len(sizes)
    M = EP_RANKS * ep_capacity()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    lhs = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    rhs = (torch.randn(G, K, N, generator=gen, device="cuda")
           * K ** -0.5).to(torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    route = gm.route(lhs.dtype, K, N, G)
    n0 = gm.gmm.route_launches[route]
    out = gm.gmm(lhs, rhs, gs)
    if gm.gmm.route_launches[route] != n0 + 1 or route != "wgmma":
        raise AssertionError(f"EP gmm {what} took {route}")
    want = gm.gmm_plain(lhs.float(), rhs.float(), gs)
    err = float((out.float() - want).abs().max()) / float(want.abs().max())
    if err > 4e-3 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"EP gmm {what}: scaled error {err}")
    del want
    kernel_ms = cuda_ms(torch, lambda: gm.gmm(lhs, rhs, gs), iters=10)
    plain_ms = cuda_ms(torch, lambda: gm.gmm_plain(lhs, rhs, gs), iters=3,
                       warmup=1)
    x = lhs.view(G, M // G, K)
    library_ms = cuda_ms(torch, lambda: torch.bmm(x, rhs), iters=10)
    bound_ms, bound_by, work = gmm_bound(sizes, M, K, N, "bfloat16")
    res = dict(case=f"ep {what}", route=route, G=G, M=M, K=K, N=N,
               rows=sum(sizes), sizes=sizes, checked_err=err,
               kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, **work)
    print("kernel case gmm " + json.dumps(res), flush=True)
    return res


def ep_capacity() -> int:
    """Slots a dbrx rank sends each destination (``ep_moe.capacity``)."""
    from repro_torch.configs import get_config
    from repro_torch.parallel.ep_moe import capacity
    return capacity(get_config(EP_ARCH), EP_BATCH * EP_SEQ, EP_RANKS)


def ep_moe_phase(torch, card: str) -> dict:
    """Phase 19: dbrx-132b's MoE layer at full width across EP_RANKS ranks
    (``parallel/ep_moe.py`` ``ep_moe_apply``, the experts through gmm), and
    the f32 case; see the module docstring."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import gmm as gm
    from repro_torch.models.moe import moe_apply, moe_init
    from repro_torch.parallel import ep_moe as ep

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= EP_RANKS else "gloo"
    print(f"ep: backend {backend} world {EP_RANKS} cards {cards}",
          flush=True)
    _build.load("gmm")     # built here, before the ranks load it
    cfg = get_config(EP_ARCH).replace(param_dtype="bfloat16",
                                      scan_impl="pallas")
    m = cfg.moe
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = moe_init(cfg, gen, torch.device("cuda"))
    x = torch.randn(EP_BATCH, EP_SEQ, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)
    c32 = cfg.replace(d_model=EP_F32_WIDTH[0], dtype="float32",
                      param_dtype="float32", moe=dataclasses.replace(
                          m, d_ff_expert=EP_F32_WIDTH[1]))
    p32 = moe_init(c32, gen, torch.device("cuda"))
    x32 = torch.randn(EP_F32_BATCH, EP_F32_SEQ, c32.d_model, generator=gen,
                      device="cuda")
    out = torch.empty((EP_RANKS,) + tuple(x.shape), dtype=x.dtype,
                      device="cuda")
    b32 = EP_F32_BATCH // EP_F32_MESH[0]
    out32 = torch.empty((EP_RANKS, b32, EP_F32_SEQ, c32.d_model),
                        device="cuda")
    expert_gb = sum(params[k].numel() * 2 for k in ep.EXPERT_LEAVES) / 1e9
    print(f"ep: {EP_ARCH} MoE layer, d {cfg.d_model}, {m.num_experts} "
          f"experts top-{m.experts_per_token}, d_ff {m.d_ff_expert}, "
          f"{expert_gb:.2f} GB of bf16 experts, "
          f"{expert_gb / EP_RANKS:.2f} GB a rank; {EP_BATCH} x {EP_SEQ} "
          f"tokens, capacity {ep_capacity()} a destination", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ep_store_") as tmp:
        job = dict(backend=backend, store=os.path.join(tmp, "store"),
                   cfg=cfg, params=params, x=x, out=out, cfg32=c32, p32=p32,
                   x32=x32, out32=out32)
        ranks = run_ep_ranks(torch, job)
    ranks_s = time.perf_counter() - t0
    torch.cuda.ipc_collect()     # the ranks' handles on the shared tensors
    for r in ranks:
        if r["gmm_launches"] != 3 or r["gmm_route_launches"]["wgmma"] != 3:
            raise AssertionError(f"rank {r['rank']}: gmm launches "
                                 f"{r['gmm_route_launches']}, want 3 wgmma")
        if r["f32_gmm_route_launches"]["mma_sync"] != 3:
            raise AssertionError(f"rank {r['rank']} f32: gmm launches "
                                 f"{r['f32_gmm_route_launches']}")
        print("ep rank " + json.dumps({k: v for k, v in r.items()
                                       if k != "routing"}), flush=True)

    # the yardstick: every rank's function in one process, in f32
    routes = []
    real_pack = ep._local_pack

    def recording(cfg_, logits, xf, n, cap):
        pack = real_pack(cfg_, logits, xf, n, cap)
        routes.append(dict(ids=torch.topk(logits.float(), m.experts_per_token,
                                          dim=-1)[1].sort(-1).values.cpu()
                           .numpy(), keep=pack.keep.cpu().numpy()))
        return pack

    ep._local_pack = recording
    try:
        with torch.no_grad():
            plain = ep.ep_moe_plain(
                cfg.replace(dtype="float32", scan_impl="xla"),
                {k: v.float() for k, v in params.items()}, x.float(),
                n_tp=EP_RANKS)[0]
    finally:
        ep._local_pack = real_pack
    mine = ranks[0]["routing"]
    differ = (mine["ids"] != routes[0]["ids"]).any(-1)
    for tok in differ.nonzero()[0][:20].tolist():
        print("routing difference " + json.dumps(dict(
            token=tok, gap=float(mine["gap"][tok]))), flush=True)
    kept_equal = bool((mine["keep"] == routes[0]["keep"]).all())
    dropped = 1.0 - float(mine["keep"].mean())
    errs = [rms_rel_err(torch, out[r], plain[r]) for r in range(EP_RANKS)]
    same = all(torch.equal(out[r], out[0]) for r in range(EP_RANKS))
    del plain
    if not kept_equal or max(errs) > RMS_TOL["bfloat16"] or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"EP dbrx vs plain f32: kept mask equal "
                             f"{kept_equal}, relative RMS errors {errs}")

    # the f32 case against the plain function and the port's moe_apply
    c32x = c32.replace(scan_impl="xla")
    with torch.no_grad():
        plain32 = ep.ep_moe_plain(c32x, p32, x32, n_tp=EP_F32_MESH[1],
                                  n_batch=EP_F32_MESH[0],
                                  capacity_factor=EP_F32_CF)
        want32 = moe_apply(c32x.replace(moe=dataclasses.replace(
            c32.moe, capacity_factor=EP_F32_CF)), p32, x32)[0]
    f32_errs = {}
    for r in ranks:
        b, j = r["f32_coord"]
        got = out32[r["rank"]]
        for name, want in (("plain", plain32[b, j]),
                           ("moe_apply", want32[b * b32:(b + 1) * b32])):
            e = float((got - want).abs().max() / want.abs().max())
            f32_errs[f"{r['rank']} {name}"] = e
            if e > 1e-5:
                raise AssertionError(f"EP f32 rank {r['rank']} vs {name}: "
                                     f"scaled error {e}")
    del out32, plain32, want32, p32, x32

    # the gmm kernel at a rank's received rows
    sizes = ranks[0]["group_sizes"]
    cases = [ep_gmm_case(torch, gm, sizes, cfg.d_model, m.d_ff_expert,
                         "gate/up"),
             ep_gmm_case(torch, gm, sizes, m.d_ff_expert, cfg.d_model,
                         "down")]
    res = dict(card=card, backend=backend, world=EP_RANKS, cards=cards,
               arch=EP_ARCH, tokens=EP_BATCH * EP_SEQ,
               capacity=ep_capacity(), dropped_share=dropped,
               kept_mask_equal=kept_equal,
               routing_differences=int(differ.sum()),
               rms_rel_err_vs_plain_f32=errs, ranks_bitwise_equal=same,
               f32_scaled_err=f32_errs, ranks_seconds=ranks_s,
               layer_ms=[r["layer_ms"] for r in ranks],
               host_ms=[r["host_ms"] for r in ranks],
               a2a_ms=[r["a2a_ms"] for r in ranks],
               experts_ms=[r["experts_ms"] for r in ranks],
               gmm_launches=[r["gmm_launches"] for r in ranks],
               filled_slots=[r["filled_slots"] for r in ranks],
               peak_gb=[r["peak_gb"] for r in ranks],
               gmm_cases=[{k: c[k] for k in (
                   "case", "rows", "K", "N", "kernel_ms", "plain_ms",
                   "library_ms", "bound_ms", "bound_by")} for c in cases])
    print("ep " + json.dumps(res), flush=True)
    return res


def shard_flash_case(torch, fa, what, B, Hq, Hkv, Sq, Skv, D, causal):
    """Flash at one rank's block, bf16 on the ``wgmma`` route: held to the
    plain version in f32 (relative RMS, ``RMS_TOL``) and timed beside the
    plain version, SDPA (the same function: ``is_causal`` where causal,
    Sq = Skv) and the bound of this work."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    q = torch.randn(B, Sq, Hq, D, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, Skv, Hkv, D, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, Skv, Hkv, D, generator=gen, device="cuda").bfloat16()
    route = fa.route(q.dtype, D)
    n0 = fa.flash_attention.route_launches[route]
    out = kops.flash_attention(q, k, v, causal=causal)
    if route != "wgmma" or fa.flash_attention.route_launches[route] != n0 + 1:
        raise AssertionError(f"flash {what} took {route}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    want32 = fa.flash_attention_plain(qt.float(), kt.float(), vt.float(),
                                      causal=causal).transpose(1, 2)
    ferr = rms_rel_err(torch, out, want32)
    if ferr > RMS_TOL["bfloat16"] or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"flash {what}: rms {ferr}")
    bound, by = attention_bound(B, Hq, Hkv, Sq, Skv, D, causal, 0,
                                "bfloat16")
    c = dict(case=f"flash {what}", B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv,
             D=D, causal=causal, route=route, rms_rel_err_vs_f32=ferr,
             max_abs_err=float((out.float() - want32).abs().max()),
             ms=cuda_ms(torch, lambda: kops.flash_attention(
                 q, k, v, causal=causal), iters=20),
             plain_ms=cuda_ms(torch, lambda: fa.flash_attention_plain(
                 qt, kt, vt, causal=causal), iters=3, warmup=1),
             library_ms=cuda_ms(
                 torch, lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, is_causal=causal, enable_gqa=True),
                 iters=20),
             bound_ms=bound, bound_by=by)
    print("kernel case " + json.dumps(c), flush=True)
    return c


def shard_wkv_case(torch, rw, B, H, S, D) -> dict:
    """WKV6 at one rank's block (f32, [B,S,H,D] tensors handed over as
    [B,H,S,D] views, as ``ops.rwkv6_scan`` hands them): held to the plain
    version (scale-normalised max error 2e-4, as ``wkv_cases``), timed
    beside it and the bound of this work; no single PyTorch call computes
    WKV6."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    shape = (B, S, H, D)
    r, k, v = (torch.randn(*shape, generator=gen, device="cuda")
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(*shape, generator=gen,
                                         device="cuda")))
    r, k, v, w = (t.transpose(1, 2) for t in (r, k, v, w))
    u = torch.randn(H, D, generator=gen, device="cuda")
    n0 = rw.rwkv6_scan.launches
    out = rw.rwkv6_scan(r, k, v, w, u)
    want = rw.rwkv6_scan_plain(r, k, v, w, u)
    err = float((out - want).abs().max()) / (float(want.abs().max()) + 1.0)
    if rw.rwkv6_scan.launches != n0 + 1 or err > 2e-4 or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"rwkv6_scan at a rank's block {shape}: {err}")
    bound, by, work = wkv_bound(B, H, S, D)
    c = dict(case="rwkv6_scan rank block", B=B, H=H, S=S, D=D,
             max_abs_err=float((out - want).abs().max()), checked_err=err,
             ms=cuda_ms(torch, lambda: rw.rwkv6_scan(r, k, v, w, u),
                        iters=20),
             plain_ms=cuda_ms(torch, lambda: rw.rwkv6_scan_plain(
                 r, k, v, w, u), iters=3, warmup=1),
             library_ms=None, bound_ms=bound, bound_by=by, **work)
    print("kernel case " + json.dumps(c), flush=True)
    return c


def shard_scan_case(torch, mb, B, S, di, N, clock_hz) -> dict:
    """The selective scan at one rank's block of channels (f32; dt from a
    softplus, as the model's): y and the final state held to the plain
    version (scaled error 1e-4, as ``mamba_cases``), timed beside it (the
    call with the state, as a prefill makes it) and the bound of this
    work; no single PyTorch call computes the scan."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def rnd(*sh):
        return torch.randn(*sh, generator=gen, device="cuda")

    args = (-torch.exp(rnd(di, N)), F.softplus(rnd(B, S, di)), rnd(B, S, N),
            rnd(B, S, N), rnd(B, S, di))
    n0 = mb.mamba_scan.launches
    out, hT = mb.mamba_scan(*args, return_state=True)
    want, want_h = mb.mamba_scan_plain(*args, return_state=True)
    errs = [scaled_err(out, want), scaled_err(hT, want_h)]
    if mb.mamba_scan.launches != n0 + 1 or max(errs) > 1e-4 or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"mamba_scan at a rank's block {(B, S, di, N)}:"
                             f" {errs}")
    bound, by, work = mamba_bound(B, S, di, N, clock_hz)
    c = dict(case="mamba_scan rank block", B=B, S=S, di=di, N=N,
             max_abs_err=float((out - want).abs().max()), checked_err=errs[0],
             hT_checked_err=errs[1],
             ms=cuda_ms(torch, lambda: mb.mamba_scan(*args), iters=20),
             state_ms=cuda_ms(torch, lambda: mb.mamba_scan(
                 *args, return_state=True), iters=20),
             plain_ms=cuda_ms(torch, lambda: mb.mamba_scan_plain(*args),
                              iters=2, warmup=1),
             library_ms=None, bound_ms=bound, bound_by=by, **work)
    print("kernel case " + json.dumps(c), flush=True)
    return c


def shard_kernel_cases(torch, fa, gm, rw, mb) -> dict:
    """Flash and gmm at the local shapes phase 20's ranks give them: flash
    on one rank's prefill block of qwen3-8b (2 prompts of 512 tokens, 16 q
    and 4 kv heads, D 128, causal), of seamless-m4t-medium (2 rows, 8 of
    its 16 heads of 64: the encoder over 1024 frames, non-causal; the
    decoder's self-attention over a 64-token prompt, causal; its
    cross-attention, 64 queries against the 1024 frames) and of
    qwen2-vl-72b (2 sequences of 512 positions, 32 q and 4 kv heads of
    128, causal), all bf16 on the ``wgmma`` route; gmm on one rank's 64 of
    qwen3-moe's 128 experts, each with the C + 1 = 81 slots of a 2 x
    512-token chunk (K 2048 -> N 768 and back, bf16).  Each against its
    plain version in f32 (relative RMS, ``RMS_TOL``), timed beside the
    plain version, one PyTorch call (SDPA; ``torch.bmm`` over the equal
    groups) and the bound of this work.  Then WKV6 at one rank's block of
    (f)'s bf16 loss (2 rows of 512 tokens, 20 of rwkv6-3b's 40 heads of
    64) and the selective scan at one of (g)'s (2 rows of 512 tokens,
    8192 of jamba's 16384 inner channels, N 16)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models.moe import _capacity
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    data, model = SHARD_MESH
    rows, F_, P = SHARD_ENCDEC_BATCH // data, SHARD_FRAMES, \
        SHARD_ENCDEC_PROMPT
    flash = [shard_flash_case(torch, fa, what, *shape) for what, shape in (
        ("rank prefill", (SHARD_PROMPTS // data, 32 // model, 8 // model,
                          SHARD_PROMPT_LEN, SHARD_PROMPT_LEN, 128, True)),
        ("rank encoder", (rows, 16 // model, 16 // model, F_, F_, 64,
                          False)),
        ("rank decoder self", (rows, 16 // model, 16 // model, P, P, 64,
                               True)),
        ("rank cross", (rows, 16 // model, 16 // model, P, F_, 64, False)),
        ("rank vlm prefill", (SHARD_VLM_PROMPTS // data, 64 // model,
                              8 // model, SHARD_VLM_SEQ, SHARD_VLM_SEQ, 128,
                              True)))]
    m = get_config(SHARD_MOE_ARCH).moe
    G = m.num_experts // SHARD_MESH[1]
    rows = _capacity(m, SHARD_MOE_BATCH * SHARD_MOE_SEQ) + 1
    cases = []
    for K, N, what in ((2048, m.d_ff_expert, "gate/up"),
                       (m.d_ff_expert, 2048, "down")):
        x = torch.randn(G, rows, K, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(G, K, N, generator=gen, device="cuda")
             * K ** -0.5).bfloat16()
        r0 = gm.route(x.dtype, K, N, G)
        n0 = gm.gmm.route_launches[r0]
        y = kops.gmm_equal(x, w)
        if r0 != "wgmma" or gm.gmm.route_launches[r0] != n0 + 1:
            raise AssertionError(f"gmm {what} at the rank's experts took {r0}")
        want = torch.bmm(x.float(), w.float())
        gerr = rms_rel_err(torch, y, want)
        if gerr > RMS_TOL["bfloat16"] or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"gmm {what} at the rank's experts: {gerr}")
        sizes = [rows] * G
        bound, by, _ = gmm_bound(sizes, G * rows, K, N, "bfloat16")
        flat, gs = x.reshape(G * rows, K), torch.full(
            (G,), rows, dtype=torch.int32, device="cuda")
        c = dict(case=f"gmm rank experts {what}", G=G, rows=rows, K=K, N=N,
                 route=r0, rms_rel_err_vs_f32=gerr,
                 max_abs_err=float((y.float() - want).abs().max()),
                 ms=cuda_ms(torch, lambda: kops.gmm_equal(x, w), iters=20),
                 plain_ms=cuda_ms(torch, lambda: gm.gmm_plain(flat, w, gs),
                                  iters=3, warmup=1),
                 library_ms=cuda_ms(torch, lambda: torch.bmm(x, w), iters=20),
                 bound_ms=bound, bound_by=by)
        print("kernel case gmm " + json.dumps(c), flush=True)
        cases.append(c)
    data, model = SHARD_MESH
    wkv = shard_wkv_case(torch, rw, SHARD_RWKV_BATCH // data, 40 // model,
                         SHARD_RWKV_SEQ, 64)
    di = 2 * get_config(JAMBA_ARCH).d_model
    scan = shard_scan_case(torch, mb, SHARD_JAMBA_BATCH // data,
                           SHARD_JAMBA_SEQ, di // model, 16,
                           max_sm_clock_hz())
    return {"flash": flash, "gmm": cases, "rwkv6_scan": [wkv],
            "mamba_scan": [scan]}


def _recording_routes(moe_mod, store: list):
    """Wrap ``moe._route`` so each call's kept mask and top-k gap (the
    probability between the k-th and the k+1-th expert) land in
    ``store``; returns the real function, to put back."""
    import torch
    real = moe_mod._route

    def recording(cfg_, router, xf, C):
        out = real(cfg_, router, xf, C)
        probs = torch.softmax(xf.float() @ router, dim=-1)
        top = torch.topk(probs, cfg_.moe.experts_per_token + 1, dim=-1)[0]
        store.append(dict(keep=out[3].cpu(), gap=(top[:, -2] - top[:, -1])
                          .cpu()))
        return out

    moe_mod._route = recording
    return real


def shard_references(torch) -> dict:
    """Phase 20's single-device runs on the card, on the seeded params the
    ranks get: (a) qwen3-4b's loss and one train step's moments; (b)
    qwen3-8b's prefill and SHARD_TICKS greedy decode steps, bf16 and f32;
    (c) qwen3-moe's plain loss in f32 (and bf16) with each layer's kept
    mask."""
    from repro_torch.config import RunConfig, ShapeConfig, ShardingConfig
    from repro_torch.configs import get_config
    from repro_torch.models import loss_fn, prefill
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import make_opt_state, make_train_step
    ref = {}
    # (a)
    cfg = get_config(SHARD_TRAIN_ARCH).replace(
        num_layers=SHARD_LAYERS, dtype="float32", param_dtype="float32",
        attention_impl="xla")
    params = seeded_params(torch, cfg)
    batch = scoring_batch(torch, cfg, SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "smoke", "train", SHARD_TRAIN_SEQ, SHARD_TRAIN_BATCH),
        sharding=ShardingConfig(policy="fsdp"), seed=SEED)
    with torch.no_grad():
        ref["a_loss"] = float(loss_fn(cfg, params, batch)[0])
    ref["a_params"] = {k: v for k, v in params.items()}
    ref["a_batch"] = batch
    pcopy = [t.clone() for t in tree_leaves(params)]
    opt = make_opt_state(run, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    make_train_step(run)(params, opt, batch)
    torch.cuda.synchronize()
    ref["a_step_ms"] = (time.perf_counter() - t0) * 1e3
    for t, c in zip(tree_leaves(params), pcopy):
        t.copy_(c)                      # lr_at(0) is 0; keep them exact
    del pcopy
    ref["a_m"], ref["a_v"] = tree_leaves(opt["m"]), tree_leaves(opt["v"])
    ref["a_run"], ref["a_cfg"] = run, cfg
    # (b) and (c): f32 params, and their bf16 cast for the bf16 runs (the
    # ranks cast their blocks the same way), so the card holds one copy
    from repro_torch.optim.adamw import tree_map
    bf16 = lambda tree: tree_map(lambda t: t.to(torch.bfloat16), tree)
    cfg32 = get_config(SHARD_SERVE_ARCH).replace(
        num_layers=SHARD_LAYERS, dtype="float32", param_dtype="float32",
        attention_impl="pallas")
    p32 = seeded_params(torch, cfg32)
    b = scoring_batch(torch, cfg32, SHARD_PROMPTS, SHARD_PROMPT_LEN)
    prompt = {"tokens": b["tokens"], "positions": b["positions"]}
    for dt in ("bfloat16", "float32"):
        cfg = cfg32.replace(dtype=dt, param_dtype=dt)
        params = bf16(p32) if dt == "bfloat16" else p32
        with torch.inference_mode():
            lg, cache = prefill(cfg, params, prompt,
                                SHARD_PROMPT_LEN + SHARD_TICKS + 1)
            toks, steps, _, _ = decode_ticks(torch, cfg, params, lg, cache,
                                             SHARD_TICKS)
        ref[f"b_{dt}"] = dict(cfg=cfg, prompt=prompt,
                              max_len=SHARD_PROMPT_LEN + SHARD_TICKS + 1,
                              prefill=lg[:, -1].float().clone(),
                              steps=torch.stack(steps), tokens=toks)
        del cache, params
    ref["b_params"] = p32
    cfg32 = get_config(SHARD_MOE_ARCH).replace(
        num_layers=SHARD_LAYERS, dtype="float32", param_dtype="float32")
    p32 = seeded_params(torch, cfg32)
    batch = scoring_batch(torch, cfg32, SHARD_MOE_BATCH, SHARD_MOE_SEQ)
    for dt in ("bfloat16", "float32"):
        cfg = cfg32.replace(dtype=dt, param_dtype=dt)
        params = bf16(p32) if dt == "bfloat16" else p32
        routes = []
        real = _recording_routes(moe_mod, routes)
        try:
            with torch.no_grad():
                loss = float(loss_fn(cfg, params, batch)[0])
        finally:
            moe_mod._route = real
        ref[f"c_{dt}"] = dict(cfg=cfg, batch=batch, loss=loss,
                              keep=[r["keep"] for r in routes],
                              gap=[r["gap"] for r in routes])
        del params
    ref["c_params"] = p32
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return ref


def serve_references(torch, cfg, params, prompt, max_len: int) -> dict:
    """Prefill of ``prompt`` and SHARD_TICKS greedy decode steps on one
    device, bf16 then f32 (``cfg`` and ``params`` in f32; the bf16 run
    takes a cast of them, dropped after it), for ``_sharded_serve``."""
    from repro_torch.models import prefill
    from repro_torch.optim.adamw import tree_map
    ref = {}
    for dt in ("bfloat16", "float32"):
        c = cfg.replace(dtype=dt, param_dtype=dt, attention_impl="pallas")
        p = params if dt == "float32" else tree_map(
            lambda t: t.to(torch.bfloat16), params)
        pr = dict(prompt)
        if "frontend" in pr:
            pr["frontend"] = pr["frontend"].to(getattr(torch, dt))
        with torch.inference_mode():
            lg, cache = prefill(c, p, pr, max_len)
            toks, steps, _, _ = decode_ticks(torch, c, p, lg, cache,
                                             SHARD_TICKS)
        ref[dt] = dict(cfg=c, prompt=pr, max_len=max_len,
                       prefill=lg[:, -1].float().clone(),
                       steps=torch.stack(steps), tokens=toks)
        del cache, p
        gc.collect()
        torch.cuda.empty_cache()
    return ref


def encdec_references(torch) -> dict:
    """Phase 20's (d) on one device on the card, on the seeded params the
    ranks get: seamless-m4t-medium at 2 + 2 layers, its loss and a
    2-microbatch train step (f32, plain attention), then its prefill and
    SHARD_TICKS greedy decode steps on flash, bf16 and f32."""
    from repro_torch.config import RunConfig, ShapeConfig, ShardingConfig
    from repro_torch.configs import get_config
    from repro_torch.models import loss_fn
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import make_opt_state, make_train_step
    L = SHARD_LAYERS
    ref = {}
    cfg = get_config(SHARD_ENCDEC_ARCH).replace(
        encoder_layers=L, decoder_layers=L, num_layers=2 * L,
        dtype="float32", param_dtype="float32", attention_impl="xla")
    params = seeded_params(torch, cfg)
    batch = _masked_targets(scoring_batch(torch, cfg, SHARD_ENCDEC_BATCH,
                                          SHARD_ENCDEC_SEQ), SHARD_ENCDEC_SEQ)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "smoke", "train", SHARD_ENCDEC_SEQ, SHARD_ENCDEC_BATCH),
        sharding=ShardingConfig(policy="fsdp"), seed=SEED,
        microbatches=SHARD_MICRO)
    with torch.no_grad():
        ref["d_loss"] = float(loss_fn(cfg, params, batch)[0])
    opt = make_opt_state(run, params)
    _, _, metrics = make_train_step(run)(params, opt, batch)
    ref["d_metrics"] = {k: float(v) for k, v in metrics.items()}
    ref["d_m"], ref["d_v"] = tree_leaves(opt["m"]), tree_leaves(opt["v"])
    ref["d_run"], ref["d_cfg"], ref["d_batch"] = run, cfg, batch
    ref["d_params"] = params          # lr_at(0) is 0: the step moved none
    del opt
    serve = scoring_batch(torch, cfg, SHARD_ENCDEC_BATCH, SHARD_FRAMES)
    for dt, r in serve_references(
            torch, cfg, params, prompt_of(serve, SHARD_ENCDEC_PROMPT),
            SHARD_ENCDEC_PROMPT + SHARD_TICKS + 1).items():
        ref[f"d_{dt}"] = r
    torch.cuda.synchronize()
    return ref


def vlm_references(torch) -> dict:
    """Phase 20's (e) on one device on the card, on the seeded params the
    ranks get: qwen2-vl-72b at 2 layers, prefill and SHARD_TICKS greedy
    decode steps on flash, bf16 and f32."""
    from repro_torch.configs import get_config
    cfg = get_config(SHARD_VLM_ARCH).replace(
        num_layers=SHARD_LAYERS, dtype="float32", param_dtype="float32")
    params = seeded_params(torch, cfg)
    b = scoring_batch(torch, cfg, SHARD_VLM_PROMPTS, SHARD_VLM_SEQ)
    prompt = {k: b[k] for k in ("tokens", "positions", "frontend")}
    ref = {f"e_{dt}": r for dt, r in serve_references(
        torch, cfg, params, prompt, SHARD_VLM_SEQ + SHARD_TICKS + 1).items()}
    ref["e_params"] = params
    torch.cuda.synchronize()
    return ref


def _masked_targets(batch, seq: int):
    """``batch`` with rows masked unevenly (row 0 after its first token,
    row 1's first half), so the microbatch split shows in every metric."""
    targets = batch["targets"].clone()
    targets[0, 1:] = -1
    targets[1, :seq // 2] = -1
    return dict(batch, targets=targets)


def rwkv_references(torch) -> dict:
    """Phase 20's (f) on one device on the card, on the seeded params the
    ranks get: rwkv6-3b at 2 layers, its f32 loss and 2-microbatch train
    step (the chunk path), its bf16 loss through the WKV6 kernel (2
    launches), then its prefill and SHARD_TICKS greedy decode steps, bf16
    and f32."""
    from repro_torch.config import RunConfig, ShapeConfig, ShardingConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.models import loss_fn
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import make_opt_state, make_train_step
    B, S = SHARD_RWKV_BATCH, SHARD_RWKV_SEQ
    ref = {}
    cfg = get_config(SHARD_RWKV_ARCH).replace(
        num_layers=SHARD_LAYERS, dtype="float32", param_dtype="float32",
        scan_impl="xla")
    params = seeded_params(torch, cfg)
    batch = _masked_targets(scoring_batch(torch, cfg, B, S), S)
    run = RunConfig(model=cfg, shape=ShapeConfig("smoke", "train", S, B),
                    sharding=ShardingConfig(policy="fsdp"), seed=SEED,
                    microbatches=SHARD_MICRO)
    with torch.no_grad():
        ref["f_loss"] = float(loss_fn(cfg, params, batch)[0])
    opt = make_opt_state(run, params)
    _, _, metrics = make_train_step(run)(params, opt, batch)
    ref["f_metrics"] = {k: float(v) for k, v in metrics.items()}
    ref["f_m"], ref["f_v"] = tree_leaves(opt["m"]), tree_leaves(opt["v"])
    ref["f_run"], ref["f_cfg"], ref["f_batch"] = run, cfg, batch
    ref["f_params"] = params          # lr_at(0) is 0: the step moved none
    del opt
    cfg16 = cfg.replace(dtype="bfloat16", param_dtype="bfloat16",
                        scan_impl="pallas")
    p16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    n0 = rw.rwkv6_scan.launches
    with torch.no_grad():
        ref["f_loss16"] = float(loss_fn(cfg16, p16, batch)[0])
    if rw.rwkv6_scan.launches - n0 != SHARD_LAYERS:
        raise AssertionError("(f)'s one-device bf16 loss took "
                             f"{rw.rwkv6_scan.launches - n0} WKV6 launches")
    ref["f_cfg16"] = cfg16
    del p16
    prompt = {k: batch[k] for k in ("tokens", "positions")}
    for dt, r in serve_references(torch, cfg, params, prompt,
                                  S + SHARD_TICKS + 1).items():
        ref[f"f_{dt}"] = r
    torch.cuda.synchronize()
    return ref


def _serve_run(torch, cfg, params, prompt, max_len: int, feed=None):
    """Prefill of ``prompt`` and SHARD_TICKS decode steps (greedy, or fed
    ``feed``) on one device: the last prefill logits, each step's, the
    tokens and the cache after the steps."""
    from repro_torch.models import prefill
    with torch.inference_mode():
        lg, cache = prefill(cfg, params, prompt, max_len)
        first = lg[:, -1].float().clone()
        toks, steps, _, cache = decode_ticks(torch, cfg, params, lg, cache,
                                             SHARD_TICKS, feed=feed)
    return dict(prefill=first, steps=torch.stack(steps), tokens=toks,
                cache=cache)


def jamba_references(torch) -> dict:
    """Phase 20's (g) on one device on the card, on the seeded bf16 params
    the ranks get: jamba without experts at one superblock, its loss
    through the scan and flash kernels (7 + 1 launches), its prefill and
    SHARD_TICKS greedy decode steps, then a SHARD_SEQ_PROMPT-token
    prompt's prefill at ``max_len`` SHARD_SEQ_MAX_LEN and SHARD_TICKS
    greedy steps, with the cache after them.  Both serving runs are also
    made in f32 on the same weights (a transient f32 copy, 36 GB, dropped
    before the ranks start), fed the bf16 run's tokens: the function the
    bf16 runs approximate, with the one-device bf16 run's relative RMS
    error against it (``single_f32_errs``; the cache entries' too), the
    floor a sharded bf16 run is held to."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_scan as mb
    from repro_torch.models import loss_fn
    from repro_torch.optim.adamw import tree_map
    ref = {}
    cfg = get_config(JAMBA_ARCH).replace(
        moe=None, num_layers=SHARD_JAMBA_LAYERS, dtype="bfloat16",
        param_dtype="bfloat16", attention_impl="pallas", scan_impl="pallas")
    params = seeded_params(torch, cfg)
    batch = scoring_batch(torch, cfg, SHARD_JAMBA_BATCH, SHARD_JAMBA_SEQ)
    n0 = mb.mamba_scan.launches
    with torch.no_grad():
        ref["g_loss"] = float(loss_fn(cfg, params, batch)[0])
    if mb.mamba_scan.launches - n0 != SHARD_JAMBA_LAYERS - 1:
        raise AssertionError("(g)'s one-device loss took "
                             f"{mb.mamba_scan.launches - n0} scan launches")
    ref["g_cfg"], ref["g_batch"], ref["g_params"] = cfg, batch, params
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    seq = scoring_batch(torch, cfg, 1, SHARD_SEQ_PROMPT)
    for key, b, max_len in (
            ("g_bfloat16", batch, SHARD_JAMBA_SEQ + SHARD_TICKS + 1),
            ("g_seq", seq, SHARD_SEQ_MAX_LEN)):
        prompt = {k: b[k] for k in ("tokens", "positions")}
        r16 = _serve_run(torch, cfg, params, prompt, max_len)
        r32 = _serve_run(torch, cfg32, p32, prompt, max_len, r16["tokens"])
        ref[key] = dict(
            cfg=cfg, prompt=prompt, max_len=max_len, prefill=r16["prefill"],
            steps=r16["steps"], tokens=r16["tokens"],
            f32_prefill=r32["prefill"], f32_steps=r32["steps"],
            single_f32_errs=[rms_rel_err(torch, r16["prefill"],
                                         r32["prefill"])] + [
                rms_rel_err(torch, a, b)
                for a, b in zip(r16["steps"], r32["steps"])])
        if key == "g_seq":
            ref[key]["cache"], ref[key]["f32_cache"] = r16["cache"], \
                r32["cache"]
        del r16, r32
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return ref


def sharded_rank(rank: int, job: dict, results) -> None:
    """One of phase 20's ranks, in its own process: joins the group, then
    ``sharded_rank_work``; its result (or its traceback) goes to
    ``results``."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    try:
        dev = torch.device("cuda", rank if job["backend"] == "nccl" else 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            job["backend"], store=dist.FileStore(job["store"], SHARD_RANKS),
            rank=rank, world_size=SHARD_RANKS,
            timeout=datetime.timedelta(seconds=EP_PG_TIMEOUT))
        if job["backend"] == "gloo":
            from repro_torch.parallel.collectives import gloo_cuda_all_gather
            gloo_cuda_all_gather()
        try:
            res = sharded_rank_work(torch, rank, dev, job)
        finally:
            dist.destroy_process_group()
            # drop this rank's handles on the parent's shared tensors now:
            # a handle still open when the process exits keeps the parent's
            # block in use past its ipc_collect, into the next round
            job.clear()
            gc.collect()
        results.put((rank, res))
    except BaseException:
        results.put((rank, {"error": traceback.format_exc()}))
        raise SystemExit(1)


def _block_err(d, full) -> float:
    """max |d's block - the same block of ``full``| over max |full|: a
    rank's share of a leaf's scaled error, its block against the
    single-device tensor's slice (views of the shared tensor, no gather)."""
    from torch.distributed.tensor import distribute_tensor
    ref = distribute_tensor(full, d.device_mesh, d.placements,
                            src_data_rank=None).to_local()
    scale = max(float(full.max()), -float(full.min()), 1e-30)
    return float((d.to_local().float() - ref.float()).abs().max()) / scale


def _scaled(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _sync_ms(torch, fn):
    """(fn(), host ms of it, the card synchronised before and after)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _reset_launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gm
    from repro_torch.kernels import mamba_scan as mb
    from repro_torch.kernels import rwkv6_scan as rw
    fa.flash_attention.route_launches = dict.fromkeys(fa.ROUTES, 0)
    gm.gmm.route_launches = dict.fromkeys(gm.ROUTES, 0)
    rw.rwkv6_scan.launches = mb.mamba_scan.launches = 0


def _launches() -> dict:
    """This rank's kernel launches (by route where a kernel has routes)
    since ``_reset_launches``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gm
    from repro_torch.kernels import mamba_scan as mb
    from repro_torch.kernels import rwkv6_scan as rw
    return dict(flash=dict(fa.flash_attention.route_launches),
                gmm=dict(gm.gmm.route_launches),
                wkv=rw.rwkv6_scan.launches, scan=mb.mamba_scan.launches)


def _distribute_as(tree, shardings, dtype):
    """``distribute_tree`` of ``tree`` with each rank's block cast to
    ``dtype`` a leaf at a time, so a rank never holds its whole f32 block
    beside the cast."""
    from repro_torch.optim.adamw import tree_map
    from repro_torch.parallel.context import to_dtensor
    from repro_torch.parallel.sharding import sanitize_shardings
    return tree_map(lambda t, sh: to_dtensor(t, sh.mesh, sh.placements)
                    .to(dtype), tree, sanitize_shardings(shardings, tree))


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def _sharded_serve(torch, mesh, ref: dict, params, policy: str) -> dict:
    """``baseline``/``fsdp`` prefill of ``ref``'s prompt and SHARD_TICKS
    decode ticks on this rank, in ``ref``'s config (its dtype): bf16 is fed
    the single-device run's tokens, so a rounding flip cannot fork the
    sequences, f32 feeds its own.  The errors against the single-device
    logits (f32: max over the scale; bf16: relative RMS), ms of the
    prefill and of each tick, the prefill's and the ticks' kernel
    launches, and whether the greedy tokens are the single-device run's."""
    from repro_torch.config import ShardingConfig
    from repro_torch.models import decode_step, param_axes, prefill
    from repro_torch.parallel.context import distribute, sharding_ctx
    from repro_torch.parallel.sharding import (
        batch_shardings, distribute_tree, make_ctx, tree_shardings,
    )
    cfg = ref["cfg"]
    dt = getattr(torch, cfg.dtype)
    ctx = make_ctx(mesh, ShardingConfig(policy=policy), decode=True)
    pd = _distribute_as(params, tree_shardings(ctx, param_axes(cfg)), dt)
    bd = distribute_tree(ref["prompt"], batch_shardings(ctx, ref["prompt"]))
    feed, f32 = ref["tokens"], cfg.dtype == "float32"

    def err(got, want):
        if f32:
            return _scaled(got, want)
        return float(torch.linalg.vector_norm(got - want)
                     / torch.linalg.vector_norm(want))

    with sharding_ctx(ctx), torch.no_grad():
        _reset_launches()
        (lg, cache), pre_ms = _sync_ms(torch, lambda: prefill(
            cfg, pd, bd, ref["max_len"]))
        pre_launch = _launches()
        first = lg.full_tensor()[:, -1].float()
        toks = [first.argmax(-1, keepdim=True)]
        errs, tick_ms, f32_errs = [], [], []
        _reset_launches()
        for i in range(SHARD_TICKS):
            tok = toks[-1] if f32 else feed[:, i:i + 1]
            (lg, cache), ms = _sync_ms(torch, lambda: decode_step(
                cfg, pd, distribute(tok.to(torch.int32), "batch", None),
                cache))
            tick_ms.append(ms)
            full = lg.full_tensor()[:, 0].float()
            errs.append(err(full, ref["steps"][i]))
            if "f32_steps" in ref:
                f32_errs.append(rms_rel_err(torch, full, ref["f32_steps"][i]))
            toks.append(full.argmax(-1, keepdim=True))
        tick_launch = _launches()
    out = dict(prefill_ms=pre_ms, decode_ms=tick_ms, launches=pre_launch,
               tick_launches=tick_launch,
               prefill_err=err(first, ref["prefill"]), step_errs=errs,
               tokens_equal=bool(torch.equal(torch.cat(toks, 1).cpu(),
                                             ref["tokens"].cpu())))
    if "f32_steps" in ref:
        out["f32_errs"] = [rms_rel_err(torch, first, ref["f32_prefill"])] + \
            f32_errs
    del pd, bd, cache
    torch.cuda.empty_cache()
    return out


def sharded_rank_work(torch, rank: int, dev, job: dict) -> dict:
    """Phase 20's sub-phases on this rank, those of round ``job["round"]``
    (``SHARD_ROUNDS``); see the module docstring.  Each check's error is
    measured here against the parent's single-device result (shared
    tensors); the parent holds them to the tolerances."""
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(*SHARD_MESH, device_type="cuda")
    res = dict(rank=rank, coord=mesh.get_coordinate(), device=str(dev))
    res.update(SHARD_ROUNDS[job["round"]][2](torch, mesh, dev, job))
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return res


def dense_moe_rank_work(torch, mesh, dev, job: dict) -> dict:
    """(a) the qwen3-4b ``fsdp`` train step, (b) qwen3-8b serving, (c) the
    qwen3-moe loss, on this rank."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.config import ShardingConfig
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models import loss_fn, param_axes
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel.context import sharding_ctx
    from repro_torch.parallel.sharding import (
        batch_shardings, distribute_tree, make_ctx, tree_shardings,
    )
    from repro_torch.train import make_opt_state, make_train_step
    sync_ms = functools.partial(_sync_ms, torch)
    reset, launches = _reset_launches, _launches
    res = {}

    # (a) qwen3-4b train step, fsdp
    run, cfg = job["a_run"], job["a_cfg"]
    ctx = make_ctx(mesh, run.sharding)
    p_axes = param_axes(cfg)
    pd = distribute_tree(job["a_params"], tree_shardings(ctx, p_axes))
    od = make_opt_state(run, pd)      # laid out by state_axes, local
    bd = distribute_tree(job["a_batch"], batch_shardings(ctx, job["a_batch"]))
    step = make_train_step(run)
    torch.cuda.reset_peak_memory_stats(dev)
    comm, oa = CommDebugMode(), OpAnalysis()
    with sharding_ctx(ctx):
        with torch.no_grad():
            loss = float(loss_fn(cfg, pd, bd)[0].full_tensor())
        with comm, oa:
            _, first_ms = sync_ms(lambda: step(pd, od, bd))
        m_err = max(_block_err(g, w) for g, w in zip(
            tree_leaves(od["m"]), job["a_m"]))
        v_err = max(_block_err(g, w) for g, w in zip(
            tree_leaves(od["v"]), job["a_v"]))
        _, step_ms = sync_ms(lambda: step(pd, od, bd))
    counts = {str(k).split(".")[-1]: v
              for k, v in comm.get_comm_counts().items()}
    rec = oa.result()
    res["a"] = dict(loss=loss, loss_err=abs(loss - job["a_loss"])
                    / abs(job["a_loss"]), m_err=m_err, v_err=v_err,
                    first_step_ms=first_ms, step_ms=step_ms,
                    comm_counts=counts,
                    coll_bytes={k: rec[f"coll_{k}"] for k in (
                        "all-gather", "reduce-scatter", "all-reduce")},
                    coll_count=rec["collective_count"],
                    flops=rec["flops"],
                    peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del pd, od, bd, step, oa
    torch.cuda.empty_cache()

    # (b) qwen3-8b prefill + decode, baseline, bf16 then f32
    for dt in ("bfloat16", "float32"):
        res[f"b_{dt}"] = _sharded_serve(torch, mesh, job[f"b_{dt}"],
                                        job["b_params"], "baseline")

    # (c) qwen3-moe loss, fsdp, flash and gmm on local heads and experts
    for dt in ("bfloat16", "float32"):
        ref = job[f"c_{dt}"]
        cfg = ref["cfg"].replace(attention_impl="pallas", scan_impl="pallas")
        ctx = make_ctx(mesh, ShardingConfig(policy="fsdp"))
        pd = _distribute_as(job["c_params"],
                            tree_shardings(ctx, param_axes(cfg)),
                            getattr(torch, dt))
        bd = distribute_tree(ref["batch"], batch_shardings(ctx, ref["batch"]))
        routes = []
        real = _recording_routes(moe_mod, routes)
        try:
            with sharding_ctx(ctx), torch.no_grad():
                reset()
                loss_t, ms = sync_ms(lambda: loss_fn(cfg, pd, bd)[0])
                loss = float(loss_t.full_tensor())
                got = launches()
        finally:
            moe_mod._route = real
        keep_equal = all(torch.equal(g["keep"], w)
                         for g, w in zip(routes, ref["keep"]))
        near = []
        for layer, (g, w, gap) in enumerate(zip(routes, ref["keep"],
                                                ref["gap"])):
            for tok in (g["keep"] != w).nonzero()[:10].flatten().tolist():
                near.append(dict(layer=layer, assignment=tok))
        res[f"c_{dt}"] = dict(loss=loss, loss_err=abs(loss - ref["loss"])
                              / abs(ref["loss"]), loss_ms=ms, launches=got,
                              keep_equal=keep_equal, keep_differences=near,
                              min_gap=min(float(g.min()) for g in ref["gap"]))
        del pd, bd
        torch.cuda.empty_cache()
    return res


def encdec_rank_work(torch, mesh, dev, job: dict) -> dict:
    """(d) seamless-m4t-medium's 2-microbatch ``fsdp`` train step and its
    serving, on this rank."""
    res = {"d": _train_check(torch, mesh, dev, job, "d")}
    for dt in ("bfloat16", "float32"):
        res[f"d_{dt}"] = _sharded_serve(torch, mesh, job[f"d_{dt}"],
                                        job["d_params"], "baseline")
    return res


def vlm_rank_work(torch, mesh, dev, job: dict) -> dict:
    """(e) qwen2-vl-72b's ``baseline`` serving on this rank, bf16 then f32
    (the bf16 blocks dropped before the f32 ones are made)."""
    return {f"e_{dt}": _sharded_serve(torch, mesh, job[f"e_{dt}"],
                                      job["e_params"], "baseline")
            for dt in ("bfloat16", "float32")}


def _train_check(torch, mesh, dev, job: dict, key: str) -> dict:
    """An ``fsdp`` train step of ``job``'s ``<key>_run`` on this rank,
    against the one-device step: the loss before it, every metric, the
    moments' block errors, ms of the step, its collective bytes by kind
    and counts, the peak GB."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models import loss_fn, param_axes
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel.context import sharding_ctx
    from repro_torch.parallel.sharding import (
        batch_shardings, distribute_tree, make_ctx, tree_shardings,
    )
    from repro_torch.train import make_opt_state, make_train_step
    run, cfg = job[f"{key}_run"], job[f"{key}_cfg"]
    ctx = make_ctx(mesh, run.sharding)
    pd = distribute_tree(job[f"{key}_params"],
                         tree_shardings(ctx, param_axes(cfg)))
    od = make_opt_state(run, pd)
    batch = job[f"{key}_batch"]
    bd = distribute_tree(batch, batch_shardings(ctx, batch))
    step = make_train_step(run)
    comm, oa = CommDebugMode(), OpAnalysis()
    torch.cuda.reset_peak_memory_stats(dev)
    with sharding_ctx(ctx):
        with torch.no_grad():
            loss = float(loss_fn(cfg, pd, bd)[0].full_tensor())
        with comm, oa:
            (_, _, metrics), step_ms = _sync_ms(torch, lambda: step(pd, od,
                                                                   bd))
        m_err = max(_block_err(g, w) for g, w in zip(
            tree_leaves(od["m"]), job[f"{key}_m"]))
        v_err = max(_block_err(g, w) for g, w in zip(
            tree_leaves(od["v"]), job[f"{key}_v"]))
    rec = oa.result()
    out = dict(
        loss_err=_rel(loss, job[f"{key}_loss"]),
        metric_errs={k: _rel(float(metrics[k]), job[f"{key}_metrics"][k])
                     for k in ("loss", "grad_norm", "ce", "z", "aux")},
        m_err=m_err, v_err=v_err, step_ms=step_ms,
        comm_counts={str(k).split(".")[-1]: v
                     for k, v in comm.get_comm_counts().items()},
        coll_bytes={k: rec[f"coll_{k}"] for k in (
            "all-gather", "reduce-scatter", "all-reduce", "all-to-all")},
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del pd, od, bd, step, oa, metrics
    torch.cuda.empty_cache()
    return out


def rwkv_rank_work(torch, mesh, dev, job: dict) -> dict:
    """(f) rwkv6-3b on this rank: the 2-microbatch ``fsdp`` train step in
    f32, the ``fsdp`` bf16 loss through WKV6 on the rank's heads, then
    ``baseline`` serving, bf16 and f32."""
    from repro_torch.config import ShardingConfig
    from repro_torch.models import loss_fn, param_axes
    from repro_torch.parallel.context import sharding_ctx
    from repro_torch.parallel.sharding import (
        batch_shardings, distribute_tree, make_ctx, tree_shardings,
    )
    res = {"f": _train_check(torch, mesh, dev, job, "f")}
    cfg = job["f_cfg16"]
    ctx = make_ctx(mesh, ShardingConfig(policy="fsdp"))
    pd = _distribute_as(job["f_params"], tree_shardings(ctx, param_axes(cfg)),
                        torch.bfloat16)
    bd = distribute_tree(job["f_batch"], batch_shardings(ctx, job["f_batch"]))
    with sharding_ctx(ctx), torch.no_grad():
        loss_fn(cfg, pd, bd)                    # its DTensor ops' first run
        _reset_launches()
        loss_t, ms = _sync_ms(torch, lambda: loss_fn(cfg, pd, bd)[0])
        got = _launches()
    loss = float(loss_t.full_tensor())
    res["f_loss16"] = dict(loss=loss, loss_err=_rel(loss, job["f_loss16"]),
                           loss_ms=ms, launches=got)
    del pd, bd
    torch.cuda.empty_cache()
    for dt in ("bfloat16", "float32"):
        res[f"f_{dt}"] = _sharded_serve(torch, mesh, job[f"f_{dt}"],
                                        job["f_params"], "baseline")
    return res


def _shard_seq_serve(torch, mesh, ref: dict, params) -> dict:
    """``ref``'s prompt prefilled and SHARD_TICKS ticks fed its tokens,
    under the ``shard_seq`` decode rules (``baseline`` weights): ms of the
    prefill and the ticks, the prefill's launches, the logits' relative
    RMS errors against the one-device bf16 run (``errs``) and its f32
    twin (``f32_errs``), and for every cache entry this rank's block's
    relative RMS error against the one-device bf16 cache's slice
    (``rms``), its and that slice's against the f32 cache's slice
    (``f32_rms``, ``single_f32_rms``), and whether the same rows of it
    were written (nonzero)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.config import ShardingConfig
    from repro_torch.models import decode_step, param_axes, prefill
    from repro_torch.parallel.context import distribute, sharding_ctx
    from repro_torch.parallel.sharding import (
        batch_shardings, distribute_tree, make_ctx, tree_shardings,
    )
    cfg = ref["cfg"]
    ctx = make_ctx(mesh, ShardingConfig(policy="baseline", shard_seq=True),
                   decode=True)
    pd = _distribute_as(params, tree_shardings(ctx, param_axes(cfg)),
                        getattr(torch, cfg.dtype))
    bd = distribute_tree(ref["prompt"], batch_shardings(ctx, ref["prompt"]))
    feed = ref["tokens"]
    rms = functools.partial(rms_rel_err, torch)

    with sharding_ctx(ctx), torch.no_grad():
        _reset_launches()
        (lg, cache), pre_ms = _sync_ms(torch, lambda: prefill(
            cfg, pd, bd, ref["max_len"]))
        pre_launch = _launches()
        first = lg.full_tensor()[:, -1]
        errs, f32_errs = [rms(first, ref["prefill"])], \
            [rms(first, ref["f32_prefill"])]
        tick_ms = []
        for i in range(SHARD_TICKS):
            tok = distribute(feed[:, i:i + 1].to(torch.int32), "batch", None)
            (lg, cache), ms = _sync_ms(torch, lambda: decode_step(
                cfg, pd, tok, cache))
            tick_ms.append(ms)
            full = lg.full_tensor()[:, 0]
            errs.append(rms(full, ref["steps"][i]))
            f32_errs.append(rms(full, ref["f32_steps"][i]))
    blocks = {}
    for k, d in cache.items():
        want, want32 = (distribute_tensor(
            c[k], d.device_mesh, d.placements, src_data_rank=None).to_local()
            for c in (ref["cache"], ref["f32_cache"]))
        got = d.to_local()
        if k == "index":
            blocks[k] = dict(equal=bool(torch.equal(got, want)))
            continue
        same_rows = True
        if k in ("k", "v"):             # [nb, B, rows, kv]: which rows
            dims = (0, 1, 3)
            same_rows = bool(torch.equal(got.abs().amax(dim=dims) > 0,
                                         want.abs().amax(dim=dims) > 0))
        blocks[k] = dict(rms=rms(got, want), f32_rms=rms(got, want32),
                         single_f32_rms=rms(want, want32),
                         shape=list(got.shape),
                         placements=[str(p) for p in d.placements],
                         same_rows=same_rows)
    out = dict(prefill_ms=pre_ms, decode_ms=tick_ms, launches=pre_launch,
               errs=errs, f32_errs=f32_errs, blocks=blocks)
    del pd, bd, cache
    torch.cuda.empty_cache()
    return out


def jamba_rank_work(torch, mesh, dev, job: dict) -> dict:
    """(g) jamba without experts on this rank: the ``baseline`` loss
    (its all-to-all bytes counted), serving, and the ``shard_seq``
    decode."""
    from repro_torch.config import ShardingConfig
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models import loss_fn, param_axes
    from repro_torch.parallel.context import sharding_ctx
    from repro_torch.parallel.sharding import (
        batch_shardings, distribute_tree, make_ctx, tree_shardings,
    )
    cfg, res = job["g_cfg"], {}
    ctx = make_ctx(mesh, ShardingConfig(policy="baseline"))
    pd = distribute_tree(job["g_params"], tree_shardings(ctx, param_axes(cfg)))
    bd = distribute_tree(job["g_batch"], batch_shardings(ctx, job["g_batch"]))
    oa = OpAnalysis()
    with sharding_ctx(ctx), torch.no_grad():
        with oa:
            loss_fn(cfg, pd, bd)
        _reset_launches()
        loss_t, ms = _sync_ms(torch, lambda: loss_fn(cfg, pd, bd)[0])
        got = _launches()
    loss = float(loss_t.full_tensor())
    rec = oa.result()
    res["g"] = dict(loss=loss, loss_err=_rel(loss, job["g_loss"]), loss_ms=ms,
                    launches=got,
                    coll_bytes={k: rec[f"coll_{k}"] for k in (
                        "all-gather", "reduce-scatter", "all-reduce",
                        "all-to-all")})
    del pd, bd, oa
    torch.cuda.empty_cache()
    res["g_bfloat16"] = _sharded_serve(torch, mesh, job["g_bfloat16"],
                                       job["g_params"], "baseline")
    res["g_seq"] = _shard_seq_serve(torch, mesh, job["g_seq"],
                                    job["g_params"])
    return res


class CardPeak:
    """While entered, samples the bytes in use on every card (by all
    processes: the ranks and this one) every ``period`` seconds; ``gb``:
    the most seen on each card."""

    def __init__(self, torch, period: float = 0.2):
        import threading
        self.torch, self.period = torch, period
        self.gb = [0.0] * torch.cuda.device_count()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while True:
            for i in range(len(self.gb)):
                free, total = self.torch.cuda.mem_get_info(i)
                self.gb[i] = max(self.gb[i], (total - free) / 1e9)
            if self._stop.wait(self.period):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def run_shard_ranks(torch, job: dict) -> list:
    """Spawn the SHARD_RANKS ranks on ``job``; each rank's result, or raise
    if a rank fails or is still running after SHARD_LIMIT seconds (then it
    is killed)."""
    import queue
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=sharded_rank, args=(r, job, results))
             for r in range(SHARD_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARD_LIMIT
    got = {}
    while len(got) < SHARD_RANKS and time.monotonic() < deadline:
        try:
            rank, res = results.get(timeout=5.0)
        except queue.Empty:
            if any(p.exitcode not in (None, 0) for p in procs):
                break         # a rank died before it could report
            continue
        got[rank] = res
        if "error" in res:
            break
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(10)
    errors = {r: res["error"] for r, res in got.items() if "error" in res}
    if hung or errors or len(got) < SHARD_RANKS or \
            any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"sharded ranks: hung {hung}, exit codes "
            f"{[p.exitcode for p in procs]}, results from {sorted(got)}\n"
            + "\n".join(f"--- rank {r} ---\n{e}" for r, e in errors.items()))
    return [got[r] for r in range(SHARD_RANKS)]


# phase 20's rounds of rank processes: (what, the parent's single-device
# references, a rank's work); one round at a time, so the card holds one
# round's params
SHARD_ROUNDS = {1: ("(a)-(c)", shard_references, dense_moe_rank_work),
                2: ("(d)", encdec_references, encdec_rank_work),
                3: ("(e)", vlm_references, vlm_rank_work),
                4: ("(f)", rwkv_references, rwkv_rank_work),
                5: ("(g)", jamba_references, jamba_rank_work)}


def shard_round(torch, job: dict, backend: str, what: str):
    """One round of phase 20's rank processes on ``job``: (the ranks'
    results, the round's seconds spawn to exit, the most GB in use on each
    card meanwhile)."""
    import tempfile
    free, total = torch.cuda.mem_get_info(0)
    print(f"sharded round {what}: {(total - free) / 1e9:.2f} GB in use on "
          f"card 0 before the ranks start", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="shard_store_") as tmp, \
            CardPeak(torch) as peak:
        ranks = run_shard_ranks(torch, dict(
            job, backend=backend, store=os.path.join(tmp, "store")))
    seconds = time.perf_counter() - t0
    print(f"sharded round {what}: {seconds:.1f} s spawn to exit, peak on "
          f"the card {max(peak.gb):.2f} GB (every card: "
          f"{[round(g, 2) for g in peak.gb]}), a rank's own peak "
          f"{max(r['peak_gb'] for r in ranks):.2f} GB", flush=True)
    return ranks, seconds, peak.gb


def check_serve(r: dict, key: str, prefill: dict, tick: dict) -> None:
    """A rank's ``_sharded_serve`` result: the flash launches by route in
    the prefill and in all the ticks (``prefill``, ``tick``: route -> a
    rank's count, per tick for ``tick``), f32 within 1e-4 of the logits'
    scale with its greedy tokens equal, bf16 within ``RMS_TOL``."""
    got = r[key]
    want_tick = {k: v * SHARD_TICKS for k, v in tick.items()}
    pre = {k: v for k, v in got["launches"]["flash"].items() if v}
    ticks = {k: v for k, v in got["tick_launches"]["flash"].items() if v}
    if pre != prefill or ticks != want_tick:
        raise AssertionError(f"rank {r['rank']} {key} flash launches: "
                             f"prefill {pre} (want {prefill}), ticks {ticks} "
                             f"(want {want_tick})")
    worst = max([got["prefill_err"]] + got["step_errs"])
    if key.endswith("float32"):
        if worst > 1e-4 or not got["tokens_equal"]:
            raise AssertionError(f"rank {r['rank']} {key} f32: {got}")
    elif worst > RMS_TOL["bfloat16"]:
        raise AssertionError(f"rank {r['rank']} {key} bf16: {got}")


def check_train(r: dict, key: str) -> None:
    """A rank's ``_train_check`` result: the loss, every metric (1e-5) and
    the moments (1e-4 of each leaf's scale) as the one-device
    2-microbatch step's, the batch moved by an all-to-all and the grads
    reduce-scattered."""
    d = r[key]
    if d["loss_err"] > 1e-5 or max(d["metric_errs"].values()) > 1e-5 \
            or d["m_err"] > 1e-4 or d["v_err"] > 1e-4:
        raise AssertionError(f"rank {r['rank']} ({key}) 2-microbatch train "
                             f"step: {d}")
    if d["coll_bytes"]["all-to-all"] <= 0 or \
            d["coll_bytes"]["reduce-scatter"] <= 0:
        raise AssertionError(f"rank {r['rank']} ({key}): no all-to-all of "
                             f"the batch or reduce-scatter of the grads: "
                             f"{d['coll_bytes']}")


def check_round(n: int, ranks: list, ref_errs: dict) -> None:
    """Hold round ``n``'s rank results (``SHARD_ROUNDS``) to their limits
    and launch counts (``ref_errs``: the round's one-device bf16 errors
    against f32, where it has them); raise on the first that fails."""
    L, n_mamba = SHARD_LAYERS, SHARD_JAMBA_LAYERS - 1
    if n == 1:
        for r in ranks:
            a = r["a"]
            if a["loss_err"] > 1e-5 or a["m_err"] > 1e-4 or a["v_err"] > 1e-4:
                raise AssertionError(f"rank {r['rank']} (a) train step: loss "
                                     f"{a['loss_err']}, moments {a['m_err']} "
                                     f"{a['v_err']}")
            if not a["comm_counts"] or a["coll_bytes"]["reduce-scatter"] <= 0:
                raise AssertionError(f"rank {r['rank']} (a): no "
                                     f"reduce-scatter of the fsdp grads: {a}")
            check_serve(r, "b_bfloat16", {"wgmma": L}, {})
            check_serve(r, "b_float32", {"f32": L}, {})
            c16, c32 = r["c_bfloat16"], r["c_float32"]
            for d in c16["keep_differences"] + c32["keep_differences"]:
                print("routing difference "
                      + json.dumps(dict(d, rank=r["rank"])), flush=True)
            if c16["launches"]["gmm"]["wgmma"] != 3 * L or \
                    c16["launches"]["flash"]["wgmma"] != L or \
                    c32["launches"]["gmm"]["mma_sync"] != 3 * L:
                raise AssertionError(f"rank {r['rank']} (c) launches "
                                     f"{c16['launches']} {c32['launches']}")
            if c32["loss_err"] > 1e-5 or not c32["keep_equal"] or \
                    c16["loss_err"] > RMS_TOL["bfloat16"]:
                raise AssertionError(f"rank {r['rank']} (c): f32 {c32}, bf16 "
                                     f"{c16['loss_err']}")
    if n == 2:
        for r in ranks:
            check_train(r, "d")
            # 2 encoder, 2 decoder self, 2 cross in the prefill; cross a tick
            check_serve(r, "d_bfloat16", {"wgmma": 3 * L}, {"wgmma": L})
            check_serve(r, "d_float32", {"f32": 3 * L}, {"f32": L})
    if n == 3:
        for r in ranks:
            check_serve(r, "e_bfloat16", {"wgmma": L}, {})
            check_serve(r, "e_float32", {"f32": L}, {})
    if n == 4:
        for r in ranks:
            check_train(r, "f")
            f16 = r["f_loss16"]
            if f16["launches"]["wkv"] != L or \
                    f16["loss_err"] > RMS_TOL["bfloat16"]:
                raise AssertionError(f"rank {r['rank']} (f) bf16 loss: {f16}")
            for dt in ("bfloat16", "float32"):
                # the prefill takes the state-returning chunk path
                check_serve(r, f"f_{dt}", {}, {})
                if r[f"f_{dt}"]["launches"]["wkv"]:
                    raise AssertionError(f"rank {r['rank']} (f) {dt} prefill "
                                         f"launched WKV6")
    if n == 5:
        for r in ranks:
            g = r["g"]
            if g["launches"]["scan"] != n_mamba or \
                    {k: v for k, v in g["launches"]["flash"].items() if v} != \
                    {"wgmma": 1} or g["loss_err"] > RMS_TOL["bfloat16"] or \
                    g["coll_bytes"]["all-to-all"] <= 0:
                raise AssertionError(f"rank {r['rank']} (g) loss: {g}")
            sv = r["g_bfloat16"]
            pre = {k: v for k, v in sv["launches"]["flash"].items() if v}
            if pre != {"wgmma": 1} or sv["launches"]["scan"] != n_mamba:
                raise AssertionError(f"rank {r['rank']} (g) prefill launches "
                                     f"{sv['launches']}")
            check_floor(r, "(g) serving", sv["f32_errs"],
                        ref_errs["g_bfloat16"])
            sq = r["g_seq"]
            check_floor(r, "(g) shard_seq decode", sq["f32_errs"],
                        ref_errs["g_seq"])
            rows = sq["blocks"]["k"]["shape"][2]
            if rows != SHARD_SEQ_MAX_LEN // SHARD_MESH[0] or \
                    not sq["blocks"]["index"]["equal"] or any(
                        not b["same_rows"] or
                        b["f32_rms"] > BF16_FLOOR * b["single_f32_rms"]
                        for k, b in sq["blocks"].items() if k != "index"):
                raise AssertionError(f"rank {r['rank']} (g) shard_seq cache "
                                     f"blocks: {sq['blocks']}")


def check_floor(r: dict, what: str, errs: list, single: list) -> None:
    """A sharded bf16 run's relative RMS errors against the one-device f32
    run of the same weights, held to BF16_FLOOR times the one-device bf16
    run's own (``single``): as close to the function as one device."""
    if max(errs) > BF16_FLOOR * max(single):
        raise AssertionError(f"rank {r['rank']} {what}: bf16 errors against "
                             f"f32 {errs}, one device's {single}")


def sharded_phase(torch, card: str) -> dict:
    """Phase 20: every family sharded on a (data 2, model 2) DeviceMesh,
    each sub-phase held to the same run on one device, in the rounds of
    rank processes of ``SHARD_ROUNDS``; see the module docstring."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gm
    from repro_torch.kernels import mamba_scan as mb
    from repro_torch.kernels import rwkv6_scan as rw
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= SHARD_RANKS else "gloo"
    print(f"sharded: backend {backend} world {SHARD_RANKS} cards {cards} "
          f"(one card: {SHARD_RANKS} ranks share card 0 and gloo stages "
          f"the collectives through the host; four cards: nccl, one a "
          f"rank); mesh (data, model) = {SHARD_MESH}", flush=True)
    t_phase = time.perf_counter()
    free, total = torch.cuda.mem_get_info(0)
    print(f"sharded: {(total - free) / 1e9:.2f} GB of {total / 1e9:.2f} in "
          f"use on card 0 at the start", flush=True)
    kcases = shard_kernel_cases(torch, fa, gm, rw, mb)
    L = SHARD_LAYERS
    rounds = {}
    for n, (what, refs, _) in SHARD_ROUNDS.items():
        t0 = time.perf_counter()
        job = dict(refs(torch), round=n)
        ref_s = time.perf_counter() - t0
        floors = {k: v["single_f32_errs"] for k, v in job.items()
                  if isinstance(v, dict) and "single_f32_errs" in v}
        ranks, ranks_s, peak = shard_round(torch, job, backend, what)
        del job
        gc.collect()
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        rounds[n] = dict(references_s=ref_s, ranks_s=ranks_s,
                         card_peak_gb=peak, ranks=ranks,
                         single_f32_errs=floors)
    for n, rd in rounds.items():
        check_round(n, rd["ranks"], rd["single_f32_errs"])
    res = dict(card=card, backend=backend, world=SHARD_RANKS, cards=cards,
               mesh=SHARD_MESH, layers=L, kernel_cases=kcases,
               seconds=time.perf_counter() - t_phase,
               rounds={n: dict(rd, ranks=[dict(r) for r in rd["ranks"]])
                       for n, rd in rounds.items()})
    print("sharded " + json.dumps(res), flush=True)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def phase(name):
        print(f"== {name} (at {time.perf_counter() - t_start:.1f} s)",
              flush=True)

    # 1. card
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build: one nvcc per source, all started together
    phase("build")
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gm
    from repro_torch.kernels import mamba_scan as mb
    from repro_torch.kernels import rwkv6_scan as rw
    names = ("flash_attention", "rwkv6_scan", "mamba_scan", "gmm")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load, names))
    print(f"build: {len(names)} kernels loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in names:
        seconds, log = _build.build_report(name)
        print(f"build: {name}.cu in {seconds:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 3. kernels vs plain versions
    phase("kernel")
    cases = kernel_cases(torch, fa)
    grad_guard(torch, fa, rw, mb, gm)
    wcases = wkv_cases(torch, rw)
    clock_hz = max_sm_clock_hz()
    print(f"max SM clock {clock_hz / 1e6:.0f} MHz", flush=True)
    mcases = mamba_cases(torch, mb, clock_hz)
    gcases = gmm_cases(torch, gm)
    gc.collect()
    torch.cuda.empty_cache()

    # 4. qwen3-8b serving through the flash kernel, under grad mode (its
    # params require no grad, so the wrappers' grad guard lets it pass);
    # then the launcher's tiny configs
    phase("serve qwen3-8b")
    res = serve(torch, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 4b. qwen3-4b over the fabric: published, restored onto the card and
    # served from the restored params; a 2-layer train state round trip
    phase(f"checkpoint {TRAIN_ARCH}")
    cres = checkpoint(torch, card)
    phase("serve --tiny")
    with torch.inference_mode():
        tiny_serve(torch)

    # 5.-6. rwkv6-3b: forward and loss through the WKV6 kernel, then serving
    from repro_torch.configs import get_config
    cfg = get_config(RWKV_ARCH).replace(param_dtype="bfloat16",
                                        attention_impl="pallas",
                                        scan_impl="pallas")
    params = seeded_params(torch, cfg)
    with torch.inference_mode():
        phase("forward rwkv6-3b")
        fwd = rwkv_forward(torch, card, cfg, params)
        gc.collect()
        torch.cuda.empty_cache()
        phase("serve rwkv6-3b")
        rwkv_serve(torch, card, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # 7.-9. jamba without experts: forward and loss through the selective
    # scan and flash kernels, serving, then the f32 check at 8 layers
    cfg = get_config(JAMBA_ARCH).replace(
        moe=None, num_layers=JAMBA_LAYERS, param_dtype="bfloat16",
        attention_impl="pallas", scan_impl="pallas")
    params = seeded_params(torch, cfg)
    with torch.inference_mode():
        phase(f"forward {JAMBA_ARCH}")
        jfwd = jamba_forward(torch, card, cfg, params)
        gc.collect()
        torch.cuda.empty_cache()
        phase(f"serve {JAMBA_ARCH}")
        jserve = jamba_serve(torch, card, cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        phase(f"f32 {JAMBA_ARCH}")
        jamba_f32(torch, card, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    # 10.-12. qwen3-moe at full width and depth: forward and loss through
    # the gmm and flash kernels, serving, then the f32 check at 4 layers
    cfg = get_config(MOE_ARCH).replace(param_dtype="bfloat16",
                                       attention_impl="pallas",
                                       scan_impl="pallas")
    params = seeded_params(torch, cfg)
    with torch.inference_mode():
        phase(f"forward {MOE_ARCH}")
        qfwd = moe_forward(torch, card, cfg, params)
        gc.collect()
        torch.cuda.empty_cache()
        phase(f"serve {MOE_ARCH}")
        moe_serve(torch, card, cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        phase(f"f32 {MOE_ARCH}")
        moe_f32(torch, card, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    # 13.-14. qwen3-4b training at full width and depth on the plain
    # paths, its eval step through the flash kernel; then one train step at
    # 2 layers on the card against the same step on the host's CPU
    t_train = time.perf_counter()
    phase(f"train {TRAIN_ARCH}")
    tres = train(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"train {TRAIN_ARCH} card vs cpu")
    train_card_vs_cpu(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train phase: {time.perf_counter() - t_train:.1f} s", flush=True)

    # 15. the Trainer loop over the fabric: 12 layers, then faults and
    # checkpoints at 2 layers, a cold restore with flash, the launcher
    phase(f"trainer {TRAIN_ARCH}")
    trres = trainer(torch, card)

    # 16.-18. seamless-m4t-medium (enc-dec) at full width and depth, then
    # qwen2-vl-72b (VLM) at full width and 16 layers, then the training
    # launcher for both, tiny
    phase(f"encdec {ENCDEC_ARCH}")
    eres = encdec(torch, card)
    phase(f"vlm {VLM_ARCH}")
    vres = vlm(torch, card)
    phase("train --tiny")
    tiny_train_launchers(torch)
    gc.collect()
    torch.cuda.empty_cache()

    # 18b. the quickstart example on the card, then its requests again on
    # the flash kernel
    t_qs = time.perf_counter()
    phase("quickstart")
    qres = quickstart(torch, card)
    print(f"quickstart phase: {time.perf_counter() - t_qs:.1f} s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 19. dbrx-132b's MoE layer at full width across four ranks (expert
    # parallelism through all-to-alls, the experts through gmm)
    phase(f"ep {EP_ARCH}")
    epres = ep_moe_phase(torch, card)

    # 20. every family sharded on a (data 2, model 2) mesh: train steps,
    # prefill and decode (on a sequence-sharded cache too), the MoE loss
    phase("sharded")
    shres = sharded_phase(torch, card)

    # 21. kernel line: each kernel at its main path's largest shape
    phase("done")
    big = next(c for c in cases if c["Sq"] == 2048)
    if big["route"] != "wgmma" or big["prior_ms"] is None:
        raise AssertionError(f"the prefill's flash shape took {big['route']}")
    wbig = next(c for c in wcases if c["B"] == RWKV_BATCH
                and c["S"] == RWKV_SEQ and c["D"] == 64)
    mbig = mcases[0]    # (4, 2048, 16384, 16), the jamba forward's shape
    mone = mcases[1]    # (1, 2048, 16384, 16), a 2048-token jamba prefill
    gbig = gcases[0]    # bf16, 128 x 641 rows, 2048 -> 768: the forward's
    if gbig["route"] != "wgmma" or gbig["prior_ms"] is None:
        raise AssertionError(f"the forward's gmm shape took {gbig['route']}")
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:23",
        "tpu_kernel": "kernels/flash_attention.py:_flash_kernel",
        "launches": res["flash_launches"],
        "route_launches": res["flash_launches_by_route"],
        "train_eval_launches": tres["eval_flash_launches"],
        "trainer_eval_launches": trres["cold_restore"]["flash_launches"],
        "checkpoint_serve_launches": cres["serve"]["flash_launches"],
        "encdec_launches": eres["flash_launches"],
        "encdec_decode_launches": eres["serve"]["flash_launches_per_tick"],
        "vlm_launches": vres["flash_launches"],
        "quickstart_launches": qres["flash_launches"],
        "quickstart_route_launches": qres["flash_launches_by_route"],
        "encdec_cases": [{k: c[k] for k in (
            "B", "Sq", "Skv", "dtype", "route", "kernel_ms", "bound_ms",
            "bound_by", "library_ms", "max_err")}
            for c in cases if c["Hq"] == 16 and c["D"] == 64],
        "max_abs_err": max(c["max_err"] for c in cases),
        "max_err": max(c["max_err"] for c in cases),
        "ms": big["kernel_ms"],
        "prior_ms": big["prior_ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
        "library_causal_ms": big["library_causal_ms"],
        "sharded_prefill_launches_per_rank": [
            r["b_bfloat16"]["launches"]["flash"]
            for r in shres["rounds"][1]["ranks"]],
        "sharded_encdec_launches_per_rank": [
            {"prefill": r["d_bfloat16"]["launches"]["flash"],
             "ticks": r["d_bfloat16"]["tick_launches"]["flash"]}
            for r in shres["rounds"][2]["ranks"]],
        "sharded_vlm_prefill_launches_per_rank": [
            r["e_bfloat16"]["launches"]["flash"]
            for r in shres["rounds"][3]["ranks"]],
        "sharded_jamba_loss_launches_per_rank": [
            r["g"]["launches"]["flash"] for r in shres["rounds"][5]["ranks"]],
        "sharded_cases": shres["kernel_cases"]["flash"],
    }, {
        "name": "rwkv6_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:31",
        "tpu_kernel": "kernels/rwkv6_scan.py:_wkv_kernel",
        "launches": fwd["wkv_launches"],
        "sharded_loss_launches_per_rank": [
            r["f_loss16"]["launches"]["wkv"]
            for r in shres["rounds"][4]["ranks"]],
        "sharded_cases": shres["kernel_cases"]["rwkv6_scan"],
        "max_abs_err": max(c["max_err"] for c in wcases),
        "max_err": max(c["max_err"] for c in wcases),
        "ms": wbig["kernel_ms"],
        "plain_ms": wbig["plain_ms"],
        "bound_ms": wbig["bound_ms"],
        "bound_by": wbig["bound_by"],
        "library_ms": None,
    }, {
        "name": "mamba_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:24",
        "tpu_kernel": "kernels/mamba_scan.py:_mamba_kernel",
        "launches": jfwd["scan_launches"],
        "serve_launches": jserve["scan_launches"],
        "sharded_loss_launches_per_rank": [
            r["g"]["launches"]["scan"] for r in shres["rounds"][5]["ranks"]],
        "sharded_prefill_launches_per_rank": [
            r["g_bfloat16"]["launches"]["scan"]
            for r in shres["rounds"][5]["ranks"]],
        "sharded_cases": shres["kernel_cases"]["mamba_scan"],
        "max_abs_err": max(c["max_err"] for c in mcases),
        "max_err": max(c["max_err"] for c in mcases),
        "ms": mbig["kernel_ms"],
        "spt": mbig["spt"],
        "ms_b1": mone["state_ms"],
        "bound_ms_b1": mone["bound_ms"],
        "plain_ms": mbig["plain_ms"],
        "bound_ms": mbig["bound_ms"],
        "bound_by": mbig["bound_by"],
        "library_ms": None,
    }, {
        "name": "gmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gmm.cu",
        "replaces": "src/repro/kernels/gmm.py:25",
        "tpu_kernel": "kernels/gmm.py:_gmm_kernel",
        "launches": qfwd["gmm_launches"],
        "max_abs_err": max(c["max_err"] for c in gcases),
        "max_err": max(c["max_err"] for c in gcases),
        "ms": gbig["kernel_ms"],
        "prior_ms": gbig["prior_ms"],
        "plain_ms": gbig["plain_ms"],
        "bound_ms": gbig["bound_ms"],
        "bound_by": gbig["bound_by"],
        "library_ms": gbig["library_ms"],
        "ep_launches_per_rank": epres["gmm_launches"],
        "ep_cases": epres["gmm_cases"],
        "sharded_loss_launches_per_rank": [
            r["c_bfloat16"]["launches"]["gmm"]
            for r in shres["rounds"][1]["ranks"]],
        "sharded_cases": shres["kernel_cases"]["gmm"],
    }]}), flush=True)

    # 22. result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
