#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (src/repro_torch).

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-only   # phases 4c-4e alone
    python3 chip_smoke.py --dist-only   # phase 5e (c1)-(c5), (d)-(f) alone
    python3 chip_smoke.py --dist-part f  # 5e (f) alone, with its limits

Needs one CUDA card, nvcc (PATH, $CUDA_HOME or /usr/local/cuda) and the
repository's src/ beside this file; imports nothing of JAX or of the JAX
package. Phases, each fatal on failure:

1. device — require CUDA, disable TF32, print the card and its power limit;
2. build  — compile the seven kernels from src/repro_torch/kernels/csrc
   (one nvcc per source, all at once) into build/kernels/;
3. kernels against their plain PyTorch versions on the card, at main-path
   shapes, with the tolerance printed beside the error reached; each timed
   with CUDA events next to its plain version (and SDPA for mla_decode,
   flash_prefill (causal, in the operands' dtype) and, with the selection
   as a boolean mask, for sparse_select); mla_decode at one request, ROUTE
   groups of 256, 4096 and 16 384 rows and model (a)'s decode (B = 2), each
   logging the loop and the spans its plan took, with both 16-row loops
   timed where the plan takes one, and a sweep of the 16-row rule over
   batch, rows and cache length; sparse_select (one launch a call) at
   m_q = 1, 4 and 16 over 8 blocks, over all 32, ragged, token-level and
   at model (b)'s shape, each logging its plan, with mla_decode over the
   gathered rows as one dense chunk checked and timed beside it, and its
   three loops' shared memory and blocks an SM; softmax_merge stacked at
   M = 2, 4, 8 and, at a serve request's partials, through the in-place
   entry, the backend's _merge as issued and the stacked path (three
   stacks + the stacked entry), each bit for bit the plain version;
   delta_rotate (the FETCH splice, one launch) in f32 and bf16 at deltas 0,
   1, 17, 4095 through the band entry and the splice, on the 16-byte path
   and one element off alignment, into a new tensor, a pool's rows and
   over V2-Lite's 27 layers of a chunk, bit for bit the plain version with
   the source unchanged and the profiler seeing one kernel a splice; timed
   warm and cold (a ring of source/destination pairs larger than L2)
   beside the two-launch splice it replaced and copy_ of the same bytes;
   flash_prefill once
   with f32 operands (csrc/flash_prefill.cu, split-TF32 products on the
   tensor cores) and once with bf16 operands (csrc/flash_prefill_bf16.cu),
   SDPA's own error against the plain version printed beside its time;
   ssd_chunk (split TF32) at one sequence (hb 4 and 5), at model (c)'s
   two and at 5d (a)'s Zamba2-7B prefill (H 112, N 64); the two split-TF32 kernels' bounds under both the f32 CUDA-core
   peak and three TF32 products, their shared memory and blocks an SM;
4. serve  — repro_torch.launch.serve at DeepSeek-V2-Lite width over the
   CLI's default world, every step verified against the plain oracle;
4b. selection serve — the same world with the live indexer (--selection,
   half the sessions selecting 512 tokens), every step verified against
   the selection oracle, selected pairs > 0;
4c. mesh serve — the multi-instance backend (--backend shard_map: each
   serving instance a partition of the card with its own stream), priced
   on the H100 fabrics (h100_nvlink4 / h100_ibgda): the serve world fused,
   --serial-exec and fused at --pipeline-depth 2, and the selection serve
   fused and serial, every step within the oracle's tolerance with no
   filled stage; the goldens and the selection scenario in both modes
   (StepStats equal to the analytic run, fused against serial within
   1e-6); each step's measured stage walls beside the analytic ones (serial:
   host wall and CUDA-event time), the fused phase_wall_total, one fused
   step's kernels by stream under the profiler; the mesh indexer (scoring
   on the holder's stream) choosing a host IndexerService's blocks for
   every (step, request, chunk) of the selection serves and the selection
   scenario, and its index stage's median wall, serial and fused;
5. goldens — the routed_only / fetch_heavy / mixed_congested scenarios,
   the selection scenario and a FETCH forced under selection, at V2-Lite
   width: StepStats equal to the analytic backend's (replaying the live
   indexer's selections), outputs within tolerance of the oracle;
5b. model — the model's serving form (repro_torch.models.model):
   (a) DeepSeek-V2-Lite at full depth and width in bf16, weights drawn on
   the card from seed 0: prefill of 2 x 2048 tokens, then 8 greedy
   decode_steps on a 2056-slot cache holding the prefill caches — finite
   logits, the cache layout, wall times; (b) the same width in f32 with the
   depth cut to 4 layers (1 dense + 3 MoE): prefill of 2 x 512 tokens and 8
   decode steps (2 more with selection_k = 512) through the kernels against the same steps
   through their plain versions — equal MoE routes, logits and every
   layer's latent cache within tolerance; (c) Mamba2-370m at full config in
   f32: prefill of 2 x 2048 tokens and 8 decode steps, kernels against
   plain versions; (d) one V2-Lite MLA layer (mla_attention, no MoE) in
   bf16 at 2 x 2048 tokens through the bf16 flash_prefill kernel against
   its plain version: the latent attention and the entries elementwise,
   the layer output in norm, each within 2e-2;
5c. training — repro_torch.launch.train and the training substrate
   (bf16 weights drawn on the card from seed 0, f32 AdamW moments): (a)
   the launcher on the DeepSeek and Mamba2 smoke configs, 20 steps of
   16 x 128 tokens, a checkpoint every 10: finite, falling losses and the
   checkpoints [10, 20]; (b) V2-Lite at full width cut to 4 layers (1
   dense + 3 MoE), 2 x 2048 tokens in 2 microbatches, 8 steps, a
   checkpoint every 4, a failure induced before step 6: one restore, step
   4 replayed bit for bit, later replays within 1e-3; (c) Mamba2-370m as
   published, 4 x 2048 tokens, 8 steps, falling loss; each with its step
   wall, tokens/s, one step's device busy share under the profiler and
   max_memory_allocated beside the nvidia-smi line; (d) (b)'s trained
   weights through prefill (the bf16 flash_prefill once per layer)
   against the train form on the same routes, last-token logits within
   2e-2 in norm; (e) the f32 train form against f64 on V2-Lite width, 2
   layers, 2 x 512 tokens: loss within 1e-5, grad norm within 1e-4,
   equal routes;
5d. families — the model families the port runs with GQA attention
   (repro_torch.models.attention: einsums, no kernel, as in the
   reference), weights drawn on the card from seed 0: (a) Zamba2-7B as
   published (81 Mamba2 layers, 13 groups of 6 each followed by the shared
   attention block, then 3 more) in bf16: prefill 2 x 2048 tokens
   (ssd_chunk once per Mamba2 layer at x (2, 16, 128, 112, 64)), 8 greedy
   decode steps on a 2056-slot cache filled from the prefill (SSM states
   and shared K/V) — finite logits, the cache and state layouts, walls,
   device busy share, peak memory; (b) Zamba2 at full width cut to 7
   layers (one group of 6 and 1 more) in f32, 2 x 512 tokens and 8 decode
   steps, kernels against plain versions: logits, every SSM state, conv
   tail and the shared K/V, prefill caches and the state after decode,
   within 1e-4; (c) the GQA families in bf16 at full width, each freed
   before the next, the depth cuts and their reasons printed: qwen3-32b,
   qwen2.5-32b, qwen1.5-32b (8 of 64 layers), nemotron-4-340b (2 of 96),
   qwen3-moe-235b-a22b (2 of 94), llava-next-mistral-7b in full (576 patch
   embeddings + 2 x 1472 tokens), whisper-large-v3 in full (1500 frames, 2
   x 448 tokens): prefill, the decode state filled from it, 8 greedy decode
   steps, finite logits, layouts, walls, busy share, peak memory; (d)
   decode against forward in f32 (qwen3-32b cut to 2 layers; (b)'s
   Zamba2): prefill S - 1 tokens into exactly S slots, decode token S - 1,
   its logits against forward's last position, 1e-4 GQA and 1e-3 hybrid;
5e. distribution — (a) the sharded train step on a world-1 NCCL group
   against the unsharded one, (b) the 236B production-mesh dry run and,
   beside it, each in a subprocess of its own at full depth, qwen3-32b
   train_4k on (16, 16) and zamba2-7b long_500k on (2, 16, 16), every
   record printed and ok; the sharded serve over NCCL, each part a
   process group of its own, one process per visible card: (c1)
   V2-Lite cut to 4 layers in f32 with the kernels, prefill 2 x 2048 into
   a 4096-slot cache laid out by decode_state_shardings (the sequence over
   `model`), 8 decode steps at slots 2048-2055, then 4 selection steps
   (selection_k 512: a global top-k over the shards, sparse_select on each
   card's chosen rows, softmax_merge) fed the unsharded run's greedy
   tokens, on (1, n) and, on four cards, (2, 2) and one row on (2, 2) (its
   sequence over both mesh dims, its prefill unsharded): against the same
   steps unsharded (1e-4) and against the sharded PLAIN ops (MODEL_TOL),
   limits held whatever the routes do, routes and every layer's chosen set
   equal but for a few near-ties (router margin < 1e-3; k-th and (k +
   1)-th scores within 1e-5), and after a flip the comparison also held in
   f64 with PLAIN ops; each step's kb by rank, one 0 required where a mesh
   splits the sequence; (c2) on two cards or more, V2-Lite as published in
   bf16 on (1, n): against card 0's unsharded run, last-token logits,
   top-1 per row, routes, per-layer divergence, walls, peak memory by card
   and the cross-card merge's share of a decode step; (c3) in (c2)'s
   process on its weights, long_500k's decode: one row, 524 288 slots
   drawn N(0, 1) on the cards (each its own rows), selection_k 2048, 4
   steps: the first step's chosen ids, every layer, equal to the top k of
   the all-gathered scores; reported against card 0's unsharded run (and
   its PLAIN control): the chosen sets' overlap by layer, logits, top-1,
   walls, peak memory, the selection's and the merge's share of a step;
   then the sharded steps and the PLAIN control again, both pinned to the
   unsharded run's MoE routes (decode_step(pinned=...)), and the sharded
   steps pinned to its routes and chosen sets, their overlaps, logits and
   written entries by step and layer beside the unpinned ones;
   in all three, each kernel's first call on each card held against its
   plain version at TOL on the same inputs (the shapes the shard gives it);
   mla_decode, softmax_merge, flash_prefill (f32 in (c1), bf16 in (c2))
   and sparse_select ((c1), (c3)) launched on every card; (c4) the GQA
   and Mamba2/Zamba2 families sharded, in a process group of their own:
   (a) Zamba2-7B at full width cut to 7 layers (one group of 6 and 1
   more) in f32, prefill 2 x 2048 into 4096 slots (ssd_chunk on each
   card's batch rows and local heads) and 8 decode steps (the shared
   block's K/V cache over the sequence, each card's rows attended, the
   partials merged by softmax_merge), on (1, n) and, on four cards, (2, 2)
   and one row on (2, 2) (its prefill sharded with the batch whole),
   against the same steps unsharded and the sharded PLAIN ops (1e-4);
   on two cards or more (b) qwen3-32b at full width cut to 8 of 64 layers
   in f32 on (1, n), held the same way, and (c) Zamba2-7B as published in
   bf16 on (1, n): its logits against card 0's unsharded run, top-1,
   walls, peak memory by card and the merge's share of a decode step,
   reported; each kernel's first call on each card held at TOL, ssd_chunk
   and softmax_merge (softmax_merge alone in (b)) launched on every card;
   (c5) on two cards or more, a process group of its own, ROADMAP C.7's
   check: (c3)'s long_500k decode in f32 with V2-Lite at full width cut to
   12 layers, against card 0's unsharded run (its routes, router margins,
   chosen ids and scores, written entries recorded), the sharded run
   pinned to the unsharded routes and chosen sets (each layer's own
   choice recorded and equal but for near-ties: k-th and (k + 1)-th
   unsharded scores within 1e-5; the unsharded rows attended; logits
   within 1e-4), pinned to the routes alone (the first differing chosen
   set a near-tie, the logits before it within 1e-4) and unpinned (routes
   equal but for at most 4 near-ties, router margin < 1e-3), each by step
   and layer: overlap, each differing id's score gap, the written entries'
   error, routes, logits, top-1; peak memory by card; sparse_select and
   softmax_merge held at TOL, launched on every card and timed at the
   shard's shapes beside their bounds; (d) on four cards or more, a
   process group of its own on the first four, the sharded train step:
   V2-Lite at full width cut to 4 layers in f32 (and to 2 in f64), its
   weights drawn and laid out leaf by leaf, 3 steps of 4 x 512 tokens,
   AdamWConfig(), on (2, 2) at n_micro 2 against card 0's unsharded step
   at n_micro 4 and on (1, 4) against n_micro 2 (the same microbatch rows:
   the EP form dispatches each data shard with its own capacity), pinned
   to the unsharded routes through the train step's route hook: losses
   within 1e-5 relative, the first step's gradients within 1e-9 (f64) and
   1e-4 (f32) x their leaf's max, the parameters after that step within
   rtol 1e-6 (atol 1e-6 x lr) of adamw_update applied unsharded to the
   sharded run's own first-step gradients, in f64 every parameter within
   1e-4 x max after 3 steps (in f32 printed); unpinned in f32, the first
   step's routes equal but for at most 4 near-ties (router margin <
   1e-3); the step walls, peak memory by card, and one sharded step under
   the profiler on every card (busy share, NCCL kernels by kind); no
   kernel launched; (e) in a process group of its own on the same four
   cards, V2-Lite as published (27 layers) trained: (e1) in f32, 3 steps
   of (d)'s batches on (1, 4) at n_micro 2 and on (2, 2) at n_micro 1
   pinned to (1, 4)'s routes (each EP capacity group the same rows):
   losses within 1e-5 relative, routes recorded = pinned, the first
   step's global and per-leaf gradient norms within 1e-4 relative, the
   gradients of the embedding, the final norm and layers 0, 1 and 26
   within 1e-4 x their max, an unpinned forward's expert sets (1, 4)'s
   but in the first MoE call that differs at most 4 near-ties (later
   calls carry a flip through attention); (e2) bf16 weights and gradients
   with f32
   moments on (1, 4), 6 steps on one batch: finite losses and parameters,
   the last loss below the first; in both, each card's step walls, one
   profiled step, max_memory_allocated beside the reckoned state of its
   local shards; no kernel launched; (f) in a process group of its own on
   the same four cards, the training substrate, V2-Lite at full width cut
   to 2 layers in f32, 4 x 512 tokens a step from a SyntheticPipeline:
   (f1) train_loop driven by a sharded step on (1, 4) at n_micro 2, 6
   steps, a snapshot every 2, a fault on every rank at step 3, replayed
   bit for bit against the same loop unbroken (every logged loss and
   gradient norm, every parameter and moment, one restore at step 2, the
   same snapshots on disk), ranks 1-3 keeping no host copy in a save
   (host RSS growth by rank); (f2) a new job on (2, 2) at n_micro 1 with
   other weights warm-started by train_loop from (f1)'s snapshots up to
   step 4: the restored state bit for bit on (2, 2)'s placements, steps 4
   and 5 pinned to the unbroken run's routes (recorded = pinned, losses
   within 1e-5 relative, the parameters after step 5 within 1e-4 x max);
   (f3) the compressed all-reduce on a 4-rank NCCL group: the toy
   regression's convergence, an int32 payload of int8 values and an f32
   MAX scale, at a gradient's size the mean and the new error bit for
   bit, device ms and bytes against a plain f32 all-reduce; (f4) the
   collective matmul on a 4-rank ring at two V2-Lite widths: both forms
   within 2e-5 of x @ w, 3 point-to-point passes and no all-gather
   against one all-gather, walls, SendRecv time inside GEMM time; (f5)
   one step on (2, 2) and one on (1, 4): the collectives NCCL's flight
   recorder logged, by kind, against step_costs' count of the same step
   on meta tensors (counts equal, result bytes within 1%), achieved ring
   rates against 125 GB/s; no kernel launched;
5f. examples — repro_torch.examples in-process through run():
   quickstart (route+merge and the mla_decode kernel within 1e-5),
   serve_routed, agentic_fanout (routed fork decode within 1e-5),
   plan_execute (equal primitives and latency every step, within 1e-5;
   routed and fetched counts) and train_mla_100m --full, the ~100M
   configuration unreduced, 200 steps (falling loss, one restore, the
   steps run checked and any replay bit for bit; step wall, tokens/s,
   one step's busy share, peak memory);
6. proof of the path — each kernel's launch counter, zeroed before each of
   phases 4, 4b, 4c, 5, the four parts of 5b, the parts of 5c and of 5d
   and each example of 5f, and read after it, is > 0 over the phases that run it (4c alone runs
   all four exec kernels; flash_prefill's f32 and bf16 kernels
   counted apart: (a) launches the bf16 one once per layer in each prefill
   and the f32 one never, (d) the bf16 one once), and 0 for every kernel
   in the train steps of 5c, whose (d) launches the bf16 flash_prefill
   once per layer and nothing else; in 5d, ssd_chunk once per Mamba2 layer
   in each prefill of (a) and (b) and nothing else, and no kernel in (c);
   in 5f, mla_decode in quickstart, agentic_fanout and plan_execute,
   softmax_merge in quickstart and plan_execute, delta_rotate in
   plan_execute where it fetched, and no kernel in the train steps; in
   5e's sharded serve, counted in each rank's process around the sharded
   run with the kernels ("dist_serve"), its four kernels on every card,
   and (c4)'s ssd_chunk and softmax_merge; in (d), (e) and (f), no
   kernel on any card;
7. report — a JSON line of the kernels, the nvidia-smi line, and last the
   {"ok": true, "device": ...} line.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data-sheet peaks (at the 700 W limit): HBM3 bytes/s, f32
# operations/s outside the tensor cores, dense bf16 and TF32 tensor-core
# operations/s. A split-TF32 kernel (csrc/tf32x3.cuh) spends three TF32
# products on each f32 product: its bound is also given at PEAK_TF32_S / 3.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12
PEAK_TF32_S = 495e12

# Tolerances, card kernel against its plain version, f32:
# mla_decode sums over S = 2048 rows and D = 576 columns in another order
# (tiled online softmax with rescaling vs one max then one sum), so it is
# held at 1e-5 absolute and relative; softmax_merge and delta_rotate round
# every product and sum as the plain version does, and are held at 1e-6.
# sparse_select and flash_prefill sum over the attended rows in another
# order in the same way as mla_decode and are held to the same (the f32
# flash_prefill's split-TF32 products err by ~3 * 2^-22 relative each,
# tests/test_torch_tf32x3.py). ssd_chunk sums its gated products and state
# terms (split TF32) in another order than the cuBLAS-based plain version,
# at outputs of order 10-100: 1e-4 absolute and relative, the reference
# kernel test's own (tests/test_ssd_kernel.py).
# flash_prefill_bf16 (bf16 operands, f32 accumulation) rounds P to bf16
# before the PV product, <= 2^-9 relative per weight, where the plain
# version keeps it in f32: 2e-2 absolute and relative, under the reference
# kernel tests' own bf16 5e-2 (tests/test_kernels.py:50).
TOL = {"mla_decode": (1e-5, 1e-5), "softmax_merge": (1e-6, 0.0),
       "delta_rotate": (1e-6, 0.0), "sparse_select": (1e-5, 1e-5),
       "flash_prefill": (1e-5, 1e-5), "flash_prefill_bf16": (2e-2, 2e-2),
       "ssd_chunk": (1e-4, 1e-4)}
# The model phase, kernels against plain versions through a whole model in
# f32: every f32 reordering (about 1e-6 relative per kernel call) passes
# through the layers, and the logits are O(1). V2-Lite cut to 4 layers:
# 1e-4 absolute and relative; Mamba2-370m, 48 layers deep: 1e-3; Zamba2-7B
# cut to 7 Mamba2 layers and the shared block: V2-Lite's 1e-4.
MODEL_TOL = {"v2_lite": (1e-4, 1e-4), "mamba2": (1e-3, 1e-3),
             "zamba2": (1e-4, 1e-4)}
# serve and goldens against the plain single-instance oracle (a tree of
# merged partials vs one attention over the concatenated chunks)
ORACLE_ATOL = 1e-5

KERNELS = ("mla_decode", "softmax_merge", "delta_rotate", "sparse_select",
           "flash_prefill", "flash_prefill_bf16", "ssd_chunk")
# the kernels of the mesh's path (phases 4c-4e)
MESH_KERNELS = KERNELS[:4]

CHUNK = 2048          # tokens per chunk on the main path
PLAIN_ITERS = 30      # timed calls of a plain version (many kernels each)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"[chip_smoke] FAIL: {msg}")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def max_err(torch, got, want) -> float:
    """Max |got - want| counting equal values (including equal infinities)
    as 0; NaN anywhere is an infinite error."""
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if torch.isnan(got).any() or torch.isnan(want).any():
        return math.inf
    same = got == want
    diff = torch.where(same, torch.zeros_like(got), (got - want).abs())
    return float(diff.max()) if diff.numel() else 0.0


def within(torch, got, want, atol, rtol) -> bool:
    if torch.isnan(got).any():
        return False
    same = got == want
    ok = same | ((got - want).abs() <= atol + rtol * want.abs())
    return bool(ok.all())


def time_ms(torch, fn, iters: int, warmup: int = 3):
    """(device_ms, host_ms) per call of fn, by CUDA events around `iters`
    calls after a warm-up. host_ms: the calls as the host issues them (the
    per-call Python, allocation and launch cost shows when it exceeds the
    device work). device_ms: the same calls queued behind a GPU spin long
    enough to hide their issue, so the events see the device work back to
    back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # iters x kernels per call stays under the ~1000 launches the stream
    # queues before the host blocks: PLAIN_ITERS for the multi-kernel plain
    # versions and SDPA
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    issue_s = time.perf_counter() - t0
    host_ms = start.elapsed_time(end) / iters
    # ~2e9 spin cycles per second at the H100's top clock; 2x margin
    torch.cuda._sleep(int(2 * 2e9 * issue_s) + 1_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def device_split_us(torch, fn, iters: int = 20) -> dict:
    """Device µs per call of fn by CUDA kernel name, from torch.profiler
    (CUPTI): where a wrapper's time goes when it launches more than one
    kernel. Empty when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            name = evt.key.replace("(anonymous namespace)::", "")
            out[name.split("(")[0]] = us / iters
    return out


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_S):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over `peak`, the rate of their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# the cache types the decode kernels read in place, beside f32
CACHE_DTYPES = ("bfloat16", "float16")


def typed_caches(torch, dev, what, tag, ckv, call, out_bytes, iters):
    """ckv in bf16 and in f16 through `call` (a decode kernel's wrapper on a
    cache): each held bit for bit (o, m, l) against the f32 kernel on the
    cache cast to f32, its allocator growth over one call (less out_bytes,
    the outputs and span partials the call returns or merges) held below
    the cache's f32 bytes (no f32 copy of it is made), and timed. Returns
    {dtype: {"ms", "growth_bytes", "f32_cache_bytes"}}."""
    out = {}
    f32_bytes = 4 * ckv.numel()
    for name in CACHE_DTYPES:
        c16 = ckv.to(getattr(torch, name))
        want = call(c16.float())
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        got = call(c16)
        torch.cuda.synchronize(dev)
        growth = torch.cuda.max_memory_allocated(dev) - base
        bits = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
        ms = time_ms(torch, lambda: call(c16), iters)[0]
        log(f"[kernels] {what} {tag} {name} cache: o, m, l "
            f"{'bit for bit' if bits else 'NOT EQUAL to'} the f32 kernel on "
            f"its f32 cast; {ms:.4f} ms device; allocator growth over one "
            f"call {growth} B ({out_bytes} B of outputs and span partials, "
            f"the cache in f32 {f32_bytes} B)")
        if not bits:
            fail(f"{what} {tag}: the {name} cache differs from the f32 "
                 f"kernel on its f32 cast")
        if growth - out_bytes >= f32_bytes:
            fail(f"{what} {tag}: one call on the {name} cache grew the "
                 f"allocator by {growth} B, past its outputs by the cache's "
                 f"f32 size or more: a copy of the cache")
        out[name] = {"ms": ms, "growth_bytes": growth,
                     "f32_cache_bytes": f32_bytes}
        del c16, want, got
    return out


def partial_bytes(plan, B, R, d_v):
    """Bytes of a decode call's o, m, l and its span partials under plan."""
    one = 4 * (B * R * d_v + 2 * B * R)
    return one * (1 + (plan.n_split if plan.n_split > 1 else 0))


def stamp_split(torch, stamps, phases):
    """The mean ms a block of a stamped launch spends in each phase, its
    wall (%globaltimer, end - start) and the SM clock it ran at; each
    block's clock64 cycles by phase turned into ns at its own
    globaltimer-ns a cycle."""
    st = stamps.double().cpu()
    ns = st[:, 1] - st[:, 0]
    per_cycle = ns / st[:, 2].clamp(min=1)
    out = {name: float((st[:, 3 + i] * per_cycle).mean()) / 1e6
           for i, name in enumerate(phases)}
    out["block_ms"] = float(ns.mean()) / 1e6
    out["launch_ms"] = float(st[:, 1].max() - st[:, 0].min()) / 1e6
    out["sm_ghz"] = float((st[:, 2] / ns).mean())
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_mla_decode(torch, dev, cfg):
    from repro_torch.kernels import build
    from repro_torch.kernels.mla_decode import mla_decode, mla_decode_ref
    from repro_torch.kernels.mla_decode import ops as mla_ops
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    atol, rtol = TOL["mla_decode"]
    D, d_v, scale = cfg.d_qk, cfg.kv_lora_rank, cfg.scale
    H = cfg.n_heads
    g = torch.Generator(device=dev).manual_seed(1)
    worst, cases = 0.0, []

    def compare(tag, got, want):
        nonlocal worst
        torch.cuda.synchronize()
        e = {k: max_err(torch, getattr(got, k), getattr(want, k))
             for k in ("o", "m", "l")}
        ok = all(within(torch, getattr(got, k), getattr(want, k), atol, rtol)
                 for k in ("o", "m", "l"))
        log(f"[kernels] mla_decode {tag}: max|err| o {e['o']:.3e} "
            f"m {e['m']:.3e} l {e['l']:.3e} (atol {atol:g}, rtol {rtol:g})"
            f" {'ok' if ok else 'OVER TOLERANCE'}")
        if not ok:
            fail(f"mla_decode {tag} disagrees with its plain version")
        worst = max(worst, e["o"])

    def time_16_row_loops(q, ckv, want, tag, iters):
        """Both sides of decode_plan's 16-row rule: each 16-row loop under
        the split it would take, checked and timed."""
        B, R, _ = q.shape
        S = ckv.shape[1]
        out = {}
        for name in ("tiled16", "attend16"):
            p = mla_ops.loop_plan(name, B, R, S, build.sm_count(dev))
            run = lambda: mla_ops._launch(q, ckv, None, d_v, scale, p)
            compare(f"{tag} through {name} x {p.n_split} spans", run(), want)
            out[name] = time_ms(torch, run, iters)[0]
        return out

    # (tag, B, R, S): one request (m_q = 1), ROUTE groups of 16, 256 and
    # 1024-row requests (the last the mixed_congested golden's four
    # m_q = 1024 requests on one 2048-token chunk), model (a)'s decode
    # (B = 2 sequences of 16 heads over the 2056-slot cache)
    shapes = [("m_q=1", 1, H, CHUNK), ("m_q=16", 1, H * 16, CHUNK),
              ("m_q=256", 1, H * 256, CHUNK),
              ("4 x m_q=1024 (golden)", 1, H * 1024, CHUNK),
              ("model (a) decode", 2, H, 2056)]
    for tag, B, R, S in shapes:
        q = torch.randn((B, R, D), device=dev, generator=g)
        ckv = torch.randn((B, S, D), device=dev, generator=g)
        plan = mla_ops.decode_plan(B, R, S, build.sm_count(dev))
        got = mla_decode(q, ckv, d_v=d_v, scale=scale)
        want = mla_decode_ref(q, ckv, None, d_v, scale)
        compare(f"{tag} q({B},{R},{D}) ckv({B},{S},{D}), loop "
                f"{plan.loop} x {plan.n_split} spans", got, want)
        iters = 100 if R < 256 else (20 if R < 16384 else 10)
        ms, host_ms = time_ms(
            torch, lambda: mla_decode(q, ckv, d_v=d_v, scale=scale), iters)
        loops_ms = (time_16_row_loops(q, ckv, want, tag, iters)
                    if plan.loop != "group" else {})
        plain_ms, _ = time_ms(torch, lambda: mla_decode_ref(q, ckv, None, d_v,
                                                            scale),
                              PLAIN_ITERS)
        q4, k4, v4 = q[:, None], ckv[:, None], ckv[:, None, :, :d_v]
        try:
            lib_ms, _ = time_ms(torch, lambda: sdpa(q4, k4, v4, scale=scale),
                                PLAIN_ITERS)
        except RuntimeError as exc:       # a yardstick only, never a check
            log(f"[kernels] sdpa yardstick unavailable: {exc}")
            lib_ms = None
        nbytes = 4 * (B * R * D + B * S * D + B * R * (d_v + 2))
        flops = 2.0 * B * R * S * (D + d_v)
        b_ms, b_by = bound(nbytes, flops)
        split = device_split_us(
            torch, lambda: mla_decode(q, ckv, d_v=d_v, scale=scale))
        typed = typed_caches(
            torch, dev, "mla_decode", tag, ckv,
            lambda c: mla_decode(q, c, d_v=d_v, scale=scale),
            partial_bytes(plan, B, R, d_v), iters)
        # the bytes a bf16 cache needs read: the bound of that call
        b16_ms, b16_by = bound(nbytes - 2 * B * S * D, flops)
        cases.append({"shape": f"q({B},{R},{D}) ckv({B},{S},{D})",
                      "loop": plan.loop, "n_split": plan.n_split,
                      "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "bf16_bound_ms": b16_ms, "bf16_bound_by": b16_by,
                      "device_us_by_kernel": split, "loops_ms": loops_ms,
                      "caches": typed})
        log(f"[kernels] mla_decode {tag}: loop {plan.loop} x "
            f"{plan.n_split} spans, {ms:.4f} ms device, "
            f"{host_ms:.4f} ms as issued (plain "
            f"{plain_ms:.4f}, sdpa {lib_ms}, bound {b_ms:.5f} by {b_by}); "
            + "".join(f"{k} {v:.4f} ms; " for k, v in loops_ms.items())
            + "".join(f"{k} cache {v['ms']:.4f} ms; "
                      for k, v in typed.items())
            + f"bf16 bound {b16_ms:.5f} by {b16_by}; "
            + "profiler µs/call " + ", ".join(f"{k} {v:.1f}"
                                              for k, v in split.items()))

    # the group loops' time split at the ROUTE groups of 4096 and 16 384
    # rows: per-block %globaltimer / clock64 stamps of a measurement
    # launch (held against the plain version too), each loop under the
    # split it would take
    for R in (H * 256, H * 1024):
        q = torch.randn((1, R, D), device=dev, generator=g)
        ckv = torch.randn((1, CHUNK, D), device=dev, generator=g)
        want = mla_decode_ref(q, ckv, None, d_v, scale)
        for name in ("group", "group32"):
            p = mla_ops.loop_plan(name, 1, R, CHUNK, build.sm_count(dev))
            got, stamps = mla_ops.stamped(q, ckv, d_v, scale, p)
            compare(f"stamped {name} x {p.n_split} spans q(1,{R},{D})", got,
                    want)
            sp = stamp_split(torch, stamps, mla_ops.STAMP_PHASES)
            log(f"[kernels] mla_decode {name} q(1,{R},{D}) "
                f"ckv(1,{CHUNK},{D}) x {p.n_split} spans, time split a "
                f"block (ms, %globaltimer and clock64 stamps, "
                f"{stamps.shape[0]} blocks): "
                + ", ".join(f"{k} {v:.4f}" for k, v in sp.items()))
            cases.append({"shape": f"q(1,{R},{D}) ckv(1,{CHUNK},{D})",
                          "stamped": True, "loop": name,
                          "n_split": p.n_split, "split_ms": sp})

    # decode_plan's group rule over rows and cache length: the loop it
    # picks beside both group loops' times
    for B, R, S in ((1, 256, CHUNK), (1, 512, CHUNK), (1, 1024, CHUNK),
                    (1, 2048, CHUNK), (2, 256, CHUNK), (1, 256, 8192)):
        q = torch.randn((B, R, D), device=dev, generator=g)
        ckv = torch.randn((B, S, D), device=dev, generator=g)
        want = mla_decode_ref(q, ckv, None, d_v, scale)
        plan = mla_ops.decode_plan(B, R, S, build.sm_count(dev))
        loops_ms = {}
        for name in ("group", "group32"):
            p = mla_ops.loop_plan(name, B, R, S, build.sm_count(dev))
            run = lambda: mla_ops._launch(q, ckv, None, d_v, scale, p)
            compare(f"group rule q({B},{R},{D}) ckv({B},{S},{D}) through "
                    f"{name} x {p.n_split} spans", run(), want)
            loops_ms[name] = time_ms(torch, run, 20)[0]
        faster = min(loops_ms, key=loops_ms.get)
        log(f"[kernels] mla_decode group rule q({B},{R},{D}) "
            f"ckv({B},{S},{D}): plan {plan.loop}, "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in loops_ms.items())
            + f"; {'the faster' if plan.loop == faster else 'NOT the faster'}")
        cases.append({"shape": f"q({B},{R},{D}) ckv({B},{S},{D})",
                      "rule_sweep": True, "loop": plan.loop,
                      "n_split": plan.n_split, "ms": loops_ms[plan.loop],
                      "loops_ms": loops_ms})

    # decode_plan's 16-row rule over batch, rows and cache length: the
    # loop it picks beside both loops' times
    for B, R, S in ((3, H, CHUNK), (4, H, CHUNK), (16, H, CHUNK),
                    (1, 48, CHUNK), (2, H, 520), (1, H, 8192)):
        q = torch.randn((B, R, D), device=dev, generator=g)
        ckv = torch.randn((B, S, D), device=dev, generator=g)
        plan = mla_ops.decode_plan(B, R, S, build.sm_count(dev))
        loops_ms = time_16_row_loops(
            q, ckv, mla_decode_ref(q, ckv, None, d_v, scale),
            f"rule q({B},{R},{D}) ckv({B},{S},{D})", 100)
        faster = min(loops_ms, key=loops_ms.get)
        log(f"[kernels] mla_decode 16-row rule q({B},{R},{D}) "
            f"ckv({B},{S},{D}): plan {plan.loop}, "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in loops_ms.items())
            + f"; {'the faster' if plan.loop == faster else 'NOT the faster'}")
        cases.append({"shape": f"q({B},{R},{D}) ckv({B},{S},{D})",
                      "rule_sweep": True, "loop": plan.loop,
                      "n_split": plan.n_split, "ms": loops_ms[plan.loop],
                      "loops_ms": loops_ms})

    # ragged lengths with an empty row, in each loop (tiled16, group,
    # attend16): the empty row is the identity
    for R, lens in ((H, [CHUNK, 1000, 0]), (64, [CHUNK, 1000, 0]),
                    (H, [CHUNK, 1000, 517, 0])):
        B = len(lens)
        q = torch.randn((B, R, D), device=dev, generator=g)
        ck = torch.randn((B, CHUNK, D), device=dev, generator=g)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        plan = mla_ops.decode_plan(B, R, CHUNK, build.sm_count(dev))
        got = mla_decode(q, ck, lengths, d_v=d_v, scale=scale)
        compare(f"ragged {lens} R={R}, loop {plan.loop}", got,
                mla_decode_ref(q, ck, lengths, d_v, scale))
        torch.cuda.synchronize()
        if not (bool((got.o[-1] == 0).all()) and bool((got.l[-1] == 0).all())
                and bool(torch.isneginf(got.m[-1]).all())):
            fail(f"mla_decode: the length-0 row (R={R}) is not the identity")
    return worst, cases


def check_softmax_merge(torch, dev, cfg):
    from repro_torch.core.merge import Partial
    from repro_torch.kernels.softmax_merge import (softmax_merge,
                                                   softmax_merge_parts,
                                                   softmax_merge_ref)
    from repro_torch.serving.backends.torch_exec import TorchExecBackend
    atol, _ = TOL["softmax_merge"]
    H, d_v, m_q = cfg.n_heads, cfg.kv_lora_rank, 16
    g = torch.Generator(device=dev).manual_seed(2)
    worst, cases = 0.0, []
    for M in (2, 4, 8):
        o = torch.randn((M, m_q, H, d_v), device=dev, generator=g)
        m = 3.0 * torch.randn((M, m_q, H), device=dev, generator=g)
        l = 1.0 + 100.0 * torch.rand((M, m_q, H), device=dev, generator=g)
        # identity slots: slot 0 empty for half the rows, every slot empty
        # for one row
        m[0, : m_q // 2] = -math.inf
        l[0, : m_q // 2] = 0.0
        o[0, : m_q // 2] = 0.0
        m[:, 0, 0] = -math.inf
        l[:, 0, 0] = 0.0
        got = softmax_merge(o, m, l)
        want = softmax_merge_ref(o, m, l)
        torch.cuda.synchronize()
        e = max(max_err(torch, got.o, want.o), max_err(torch, got.m, want.m))
        el = max_err(torch, got.l, want.l) / float(want.l.abs().max())
        ok = e <= atol and el <= 1e-6
        log(f"[kernels] softmax_merge M={M} ({m_q},{H},{d_v}): max|err| "
            f"o/m {e:.3e} (atol {atol:g}), l relative {el:.3e} (1e-6) "
            f"{'ok' if ok else 'OVER TOLERANCE'}")
        if not ok:
            fail(f"softmax_merge M={M} disagrees with its plain version")
        worst = max(worst, e)
        ms, host_ms = time_ms(torch, lambda: softmax_merge(o, m, l), 300)
        plain_ms, _ = time_ms(torch, lambda: softmax_merge_ref(o, m, l),
                              PLAIN_ITERS)
        N = m_q * H
        nbytes = 4 * (M * N * (d_v + 2) + N * (d_v + 2))
        flops = float(M * N * (3 * d_v + 6))
        b_ms, b_by = bound(nbytes, flops)
        cases.append({"shape": f"o({M},{m_q},{H},{d_v})", "ms": ms,
                      "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": None,
                      "bound_ms": b_ms, "bound_by": b_by})
        log(f"[kernels] softmax_merge M={M}: {ms:.4f} ms device, "
            f"{host_ms:.4f} ms as issued (plain "
            f"{plain_ms:.4f}, bound {b_ms:.5f} by {b_by})")

    # the device time of a launch that does no work (a one-element zero_,
    # back to back): the floor under a merge of a few KB
    tiny = torch.zeros(1, device=dev)
    floor_ms, _ = time_ms(torch, tiny.zero_, 300)
    cases[0]["launch_floor_ms"] = floor_ms
    log(f"[kernels] launch floor: a one-element zero_ {floor_ms:.4f} ms "
        f"device, back to back")

    # a serve request's merge: M partials of (m_q, H, d_v), each its own
    # tensor as the exec backend holds them; the in-place entry, _merge as
    # the backend issues it, and the stacked path (three torch.stack + the
    # stacked entry) on the same partials, each bit for bit the plain
    # version
    for m_q in (1, 16):
        for M in (2, 4):
            o, m, l = _merge_inputs(torch, dev, g, M, m_q, H, d_v)
            parts = [Partial(o[i].clone(), m[i].clone(), l[i].clone())
                     for i in range(M)]
            want = softmax_merge_ref(o, m, l)

            def stacked():
                return softmax_merge(torch.stack([p.o for p in parts]),
                                     torch.stack([p.m for p in parts]),
                                     torch.stack([p.l for p in parts]))

            runs = {"parts": lambda: softmax_merge_parts(parts),
                    "_merge": lambda: TorchExecBackend._merge(parts),
                    "stacked": stacked}
            before = softmax_merge.launches
            runs["_merge"]()
            if softmax_merge.launches != before + 1:
                fail("softmax_merge: _merge is not one launch a request")
            for name, fn in runs.items():
                got = fn()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    fail(f"softmax_merge {name} M={M} ({m_q},{H},{d_v}) is "
                         f"not the plain version bit for bit")
            # five rounds, the three in turns (the host's issue time
            # varies with its neighbours): the median of each
            rounds = {name: [] for name in runs}
            for _ in range(5):
                for name, fn in runs.items():
                    rounds[name].append(time_ms(torch, fn, 300))
            times = {name: tuple(statistics.median(t[k] for t in r)
                                 for k in (0, 1))
                     for name, r in rounds.items()}
            N = m_q * H
            b_ms, b_by = bound(4 * (M * N * (d_v + 2) + N * (d_v + 2)),
                              float(M * N * (3 * d_v + 6)))
            ms, host_ms = times["parts"]
            plain_ms, _ = time_ms(torch, lambda: softmax_merge_ref(o, m, l),
                                  PLAIN_ITERS)
            cases.append({
                "shape": f"{M} parts of ({m_q},{H},{d_v}), serve request",
                "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                "merge_as_issued_ms": times["_merge"][1],
                "stacked_ms": times["stacked"][0],
                "stacked_as_issued_ms": times["stacked"][1]})
            log(f"[kernels] softmax_merge serve request M={M} "
                f"({m_q},{H},{d_v}): bit for bit the plain version through "
                f"each entry; device / as issued ms, medians of 5 rounds: "
                + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}"
                            for k, v in times.items())
                + f" (plain {plain_ms:.4f}, bound {b_ms:.5f} by {b_by})")
    return worst, cases


def _merge_inputs(torch, dev, g, M, m_q, H, d_v):
    """M partials of (m_q, H, d_v) with identity slots: slot 0 empty for
    half the rows, every slot empty for one row."""
    o = torch.randn((M, m_q, H, d_v), device=dev, generator=g)
    m = 3.0 * torch.randn((M, m_q, H), device=dev, generator=g)
    l = 1.0 + 100.0 * torch.rand((M, m_q, H), device=dev, generator=g)
    m[0, :, : H // 2] = -math.inf
    l[0, :, : H // 2] = 0.0
    o[0, :, : H // 2] = 0.0
    m[:, 0, 0] = -math.inf
    l[:, 0, 0] = 0.0
    return o, m, l


RING_PAIRS = 10      # source/destination pairs a cold timing walks (> L2)


def check_delta_rotate(torch, dev, cfg):
    """The splice kernel through both entries, bit for bit the plain
    version, then timed: the band entry, the splice warm and cold, the
    two-launch splice it replaced, copy_ of the same bytes, and V2-Lite's
    27 layers of a chunk in bf16."""
    from repro_torch.core.splice import splice_delta_rotate
    from repro_torch.kernels.delta_rotate import delta_rotate_ref
    from repro_torch.kernels.delta_rotate import ops as rot_ops
    from repro_torch.models.layers import rope_cos_sin
    d_c, d_r, d_qk = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.d_qk
    theta = cfg.rope_theta
    counter = rot_ops.delta_rotate
    g = torch.Generator(device=dev).manual_seed(3)

    def plain_splice(src, cos, sin):
        want = torch.empty_like(src)
        want[..., :d_c] = src[..., :d_c]
        want[..., d_c:] = delta_rotate_ref(src[..., d_c:], cos, sin)
        return want

    def path_of(src, dst):
        plan = rot_ops.launch_plan(src.reshape(-1, d_qk),
                                   dst.reshape(-1, d_qk), d_c)
        return plan, ("vec16" if plan.vec else "scalar")

    def held(tag, fn, want, src, n_launch=1):
        """fn() bit for bit want, src unchanged, n_launch launches."""
        kept = src.clone()
        before = counter.launches
        got = fn()
        torch.cuda.synchronize()
        if counter.launches != before + n_launch:
            fail(f"delta_rotate {tag}: {counter.launches - before} launches,"
                 f" want {n_launch}")
        if not torch.equal(got, want):
            fail(f"delta_rotate {tag}: not the plain version bit for bit "
                 f"(max|err| {max_err(torch, got.float(), want.float()):.3e})")
        if not torch.equal(src, kept):
            fail(f"delta_rotate {tag}: the source changed")
        return got

    # 1. bits: f32 and bf16, every delta, the band entry, the splice on
    # the 16-byte path and (a source one element off alignment) the
    # one-element path, into a new tensor and into rows of a pool
    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    for name, dt in types.items():
        flat = torch.randn((CHUNK * d_qk + 1,), device=dev,
                           generator=g).to(dt)
        ckv = flat[:CHUNK * d_qk].view(CHUNK, d_qk)
        off = flat[1:].view(CHUNK, d_qk)         # storage offset 1 element
        pool = torch.randn((3 * CHUNK, d_qk), device=dev, generator=g).to(dt)
        band_plan = rot_ops.launch_plan(ckv[:, d_c:], ckv[:, d_c:], 0)
        paths = {"splice": path_of(ckv, ckv)[1],
                 "splice, source off by one": path_of(off, ckv)[1],
                 "band": "vec16" if band_plan.vec else "scalar"}
        if paths != {"splice": "vec16", "splice, source off by one":
                     "scalar", "band": "vec16"}:
            fail(f"delta_rotate {name}: plans took {paths}")
        for delta in (0, 1, 17, 4095):
            cos, sin = rot_ops.delta_cos_sin(delta, d_r, theta)
            band, moved = ckv[:, d_c:], torch.empty_like(ckv)
            held(f"{name} band delta={delta}",
                 lambda: rot_ops.delta_rotate(band, cos, sin,
                                              out=moved[:, d_c:]),
                 delta_rotate_ref(band, cos, sin), ckv)
            want = plain_splice(ckv, cos, sin)
            held(f"{name} splice delta={delta}",
                 lambda: splice_delta_rotate(ckv, delta, cfg), want, ckv)
            held(f"{name} splice off alignment delta={delta}",
                 lambda: splice_delta_rotate(off, delta, cfg),
                 plain_splice(off, cos, sin), off)
            outside = torch.cat([pool[:CHUNK], pool[2 * CHUNK:]])
            held(f"{name} splice into a pool delta={delta}",
                 lambda: splice_delta_rotate(ckv, delta, cfg,
                                             out=pool[CHUNK:2 * CHUNK]),
                 want, ckv)
            if not torch.equal(torch.cat([pool[:CHUNK], pool[2 * CHUNK:]]),
                               outside):
                fail(f"delta_rotate {name} delta={delta}: the pool's other "
                     "rows changed")
        log(f"[kernels] delta_rotate {name}: band ({CHUNK},{d_r}) of "
            f"({CHUNK},{d_qk}) [{paths['band']}], splice ({CHUNK},{d_qk}) "
            f"[{paths['splice']}], off alignment "
            f"[{paths['splice, source off by one']}], into rows of a "
            f"({3 * CHUNK},{d_qk}) pool, deltas 0, 1, 17, 4095: bit for bit "
            f"the plain version (torch.equal), source unchanged, one launch "
            f"a call")
    layers = 27
    stack = torch.randn((layers, CHUNK, d_qk), device=dev,
                        generator=g).to(torch.bfloat16)
    for delta in (0, 1, 17, 4095):
        cos, sin = rot_ops.delta_cos_sin(delta, d_r, theta)
        held(f"bf16 stack delta={delta}",
             lambda: splice_delta_rotate(stack, delta, cfg),
             plain_splice(stack, cos, sin), stack)
    stack_path = path_of(stack, stack)
    log(f"[kernels] delta_rotate bf16 stack ({layers},{CHUNK},{d_qk}) "
        f"[{stack_path[1]}, {stack_path[0].blocks} blocks]: deltas 0, 1, "
        f"17, 4095 bit for bit the plain version, one launch a call")

    # 2. times, f32 (2048, 576): warm on the same buffers, cold walking a
    # ring of RING_PAIRS pairs (> L2)
    cos, sin = rot_ops.delta_cos_sin(17, d_r, theta)
    ring = [(torch.randn((CHUNK, d_qk), device=dev, generator=g),
             torch.empty((CHUNK, d_qk), device=dev))
            for _ in range(RING_PAIRS)]
    ring_mb = sum(2 * s.numel() * 4 for s, _ in ring) / 1e6

    # one splice of the main path's chunk issues one device kernel and
    # nothing else
    kernels_seen = device_split_us(
        torch, lambda: splice_delta_rotate(ring[0][0], 0, cfg), iters=5)
    if len(kernels_seen) != 1 or "splice_kernel" not in next(
            iter(kernels_seen)):
        fail(f"splice_delta_rotate issued device kernels {kernels_seen}, "
             "want the splice kernel alone")
    log(f"[kernels] delta_rotate: one splice_delta_rotate call of "
        f"({CHUNK},{d_qk}) f32 issues {kernels_seen} (torch.profiler, us a "
        f"call): one kernel")

    def new(src, dst):
        return splice_delta_rotate(src, 17, cfg, out=dst)

    def old(src, dst):
        # the two-launch splice this kernel replaced: a strided copy_ of
        # the latent columns, the host's cos/sin ops, the band launch
        dst[:, :d_c].copy_(src[:, :d_c])
        c, s = rope_cos_sin(torch.as_tensor(17.0), d_r, theta)
        return rot_ops.delta_rotate(src[:, d_c:], c.contiguous(),
                                    s.contiguous(), out=dst[:, d_c:])

    def copy(src, dst):
        return dst.copy_(src)

    def warm(fn):
        return lambda: fn(*ring[0])

    def cold(fn):
        at = [0]

        def call():
            k = at[0]
            at[0] = (k + 1) % RING_PAIRS
            return fn(*ring[k])
        return call

    t = {}
    for rnd in range(2):                 # in turns: new, old, copy, ...
        for name, fn in (("new", new), ("old", old), ("copy", copy)):
            for kind, wrap in (("warm", warm), ("cold", cold)):
                ms = time_ms(torch, wrap(fn), 300)
                t.setdefault((name, kind), []).append(ms)
    t = {k: tuple(min(v[i] for v in r) for i in (0, 1))
         for k, r in t.items()}
    plain_ms, _ = time_ms(torch, lambda: plain_splice(ring[0][0], cos, sin),
                          PLAIN_ITERS)
    # as issued, the whole function: the new splice_delta_rotate at delta
    # 0 (memoised cos/sin, one allocation, one launch) against the old one
    # (allocation, strided copy_, cos/sin ops, band launch)
    src0 = ring[0][0]
    _, issued_ms = time_ms(torch, lambda: splice_delta_rotate(src0, 0, cfg),
                           300)
    _, old_issued_ms = time_ms(
        torch, lambda: old(src0, torch.empty_like(src0)), 300)
    n = CHUNK * d_qk
    b_ms, b_by = bound(2 * 4 * n + 4 * d_r, float(CHUNK * d_r * 3))

    def share(ms):
        return (f"{b_ms / ms:.0%} of bound" if ms >= b_ms
                else "under the HBM bound: L2-resident")

    plan = path_of(ring[0][0], ring[0][1])[0]
    log(f"[kernels] delta_rotate splice ({CHUNK},{d_qk}) f32 [vec16, "
        f"{plan.blocks} x {plan.threads} threads, {plan.per_row} items a "
        f"row], device / as issued ms, best of 2 rounds in turns; bound "
        f"{b_ms:.5f} by {b_by} (HBM); cold = a ring of {RING_PAIRS} pairs, "
        f"{ring_mb:.1f} MB:")
    for name, what in (("new", "splice kernel"),
                       ("old", "old splice (copy_ + band launch)"),
                       ("copy", "copy_ of the same bytes")):
        (cm, ch), (wm, wh) = t[(name, "cold")], t[(name, "warm")]
        log(f"[kernels]   {what}: cold {cm:.4f} / {ch:.4f} ({share(cm)}); "
            f"warm {wm:.4f} / {wh:.4f} (reads L2: no share of the HBM "
            f"bound{'; under it' if wm < b_ms else ''})")
    (cm, ch), (wm, wh) = t[("new", "cold")], t[("new", "warm")]
    log(f"[kernels]   new / old device, cold {cm / t[('old', 'cold')][0]:.3f}"
        f", warm {wm / t[('old', 'warm')][0]:.3f}; new / copy_ cold "
        f"{cm / t[('copy', 'cold')][0]:.3f}, warm "
        f"{wm / t[('copy', 'warm')][0]:.3f}; splice_delta_rotate as issued "
        f"{issued_ms:.4f} ms, the old one {old_issued_ms:.4f}; plain "
        f"{plain_ms:.4f}")
    cases = [{
        "shape": f"splice ({CHUNK},{d_qk}) f32, cold", "ms": cm,
        "host_ms": ch, "warm_ms": wm, "warm_host_ms": wh,
        "plain_ms": plain_ms, "library_ms": None,
        "copy_ms": t[("copy", "cold")][0],
        "copy_warm_ms": t[("copy", "warm")][0],
        "old_ms": t[("old", "cold")][0], "old_warm_ms": t[("old", "warm")][0],
        "issued_ms": issued_ms, "old_issued_ms": old_issued_ms,
        "bound_ms": b_ms, "bound_by": b_by}]

    # the FETCH dispatch as the exec backend issues it for one request
    # (m_q = 1): the delta-0 splice, then mla_decode over the moved copy
    from repro_torch.models.mla import absorbed_partial
    q = torch.randn((1, cfg.n_heads, d_qk), device=dev, generator=g)
    moved = splice_delta_rotate(src0, 0, cfg)
    dec_ms, _ = time_ms(torch, lambda: absorbed_partial(cfg, q, moved), 300)
    spl_ms, _ = time_ms(torch, lambda: splice_delta_rotate(src0, 0, cfg),
                        300)
    pair_ms, pair_host = time_ms(torch, lambda: absorbed_partial(
        cfg, q, splice_delta_rotate(src0, 0, cfg)), 300)
    cases[0].update({"fetch_pair_ms": pair_ms, "fetch_decode_ms": dec_ms,
                     "fetch_splice_ms": spl_ms})
    log(f"[kernels] delta_rotate FETCH dispatch, m_q=1 over ({CHUNK},{d_qk})"
        f" f32, warm: splice {spl_ms:.4f} + mla_decode {dec_ms:.4f} = "
        f"{spl_ms + dec_ms:.4f} ms device apart; the pair {pair_ms:.4f} ms "
        f"device, {pair_host:.4f} ms as issued")

    # the band entry alone, warm: the shape the band kernel was timed at
    # before the splice became one launch
    band, out = ring[0][0][:, d_c:], ring[0][1][:, d_c:]
    ms, host_ms = time_ms(torch, lambda: rot_ops.delta_rotate(
        band, cos, sin, out=out), 500)
    plain_b, _ = time_ms(torch, lambda: delta_rotate_ref(band, cos, sin),
                         PLAIN_ITERS)
    bb_ms, bb_by = bound(4 * (2 * CHUNK * d_r + d_r), float(CHUNK * d_r * 3))
    cases.append({"shape": f"band({CHUNK},{d_r}) of ({CHUNK},{d_qk})",
                  "ms": ms, "host_ms": host_ms, "plain_ms": plain_b,
                  "library_ms": None, "bound_ms": bb_ms, "bound_by": bb_by})
    log(f"[kernels] delta_rotate band ({CHUNK},{d_r}) of ({CHUNK},{d_qk}) "
        f"f32: {ms:.4f} ms device, {host_ms:.4f} ms as issued (plain "
        f"{plain_b:.4f}, bound {bb_ms:.5f} by {bb_by})")

    # V2-Lite's 27 layers of a chunk in bf16 (63.7 MB each way: > L2)
    out = torch.empty_like(stack)
    ms, host_ms = time_ms(torch, lambda: splice_delta_rotate(
        stack, 17, cfg, out=out), 100)
    copy_ms, _ = time_ms(torch, lambda: out.copy_(stack), 100)
    plain_s, _ = time_ms(torch, lambda: plain_splice(stack, cos, sin),
                         PLAIN_ITERS)
    n = stack.numel()
    sb_ms, sb_by = bound(2 * 2 * n + 4 * d_r,
                         float(layers * CHUNK * d_r * 3))
    cases.append({"shape": f"splice ({layers},{CHUNK},{d_qk}) bf16",
                  "ms": ms, "host_ms": host_ms, "plain_ms": plain_s,
                  "library_ms": None, "copy_ms": copy_ms,
                  "bound_ms": sb_ms, "bound_by": sb_by})
    log(f"[kernels] delta_rotate splice ({layers},{CHUNK},{d_qk}) bf16 "
        f"[{stack_path[1]}, {stack_path[0].blocks} blocks]: {ms:.4f} ms "
        f"device ({sb_ms / ms:.0%} of bound), {host_ms:.4f} ms as issued; "
        f"copy_ of the same bytes {copy_ms:.4f} (new / copy_ "
        f"{ms / copy_ms:.3f}); plain {plain_s:.4f}; bound {sb_ms:.5f} by "
        f"{sb_by}")
    return 0.0, cases


def _sparse_cases():
    """(tag, R, S, block ids per batch row, kb or None, block_tokens): one
    request (16 rows), m_q = 4 (64 rows) and a 16-request group (256 rows)
    over 8 and over all 32 blocks of a chunk; a ragged batch with its tail
    block selected and an empty row; token-level selection of 37 scattered
    rows; model (b)'s selection decode (B = 2 sequences of 16 heads, 512
    token ids of a 522-slot cache)."""
    return [
        ("R=16 kb=8", 16, CHUNK, [[1, 4, 5, 9, 17, 20, 28, 31]], None, 64),
        ("R=16 kb=32", 16, CHUNK, [list(range(32))], None, 64),
        ("R=64 kb=8", 64, CHUNK, [[2, 6, 7, 10, 16, 22, 27, 29]], None, 64),
        ("R=256 kb=8", 256, CHUNK, [[0, 2, 3, 11, 12, 19, 25, 30]], None,
         64),
        ("R=256 kb=32", 256, CHUNK, [list(range(32))], None, 64),
        ("ragged kb=[8,3,0] S=2080", 16, CHUNK + 32,
         [[0, 3, 7, 9, 12, 20, 31, 32], [32, 5, 1, 0, 0, 0, 0, 0],
          [0] * 8], [8, 3, 0], 64),
        ("bt=1 37 rows", 16, CHUNK, [[(i * 331) % CHUNK for i in range(37)]],
         None, 1),
        ("model (b) bt=1 512 of 522", 16, 522,
         [sorted((i * 97 + b) % 522 for i in range(512)) for b in range(2)],
         None, 1),
    ]


def check_sparse_select(torch, dev, cfg):
    """Each case against the plain version, its plan (loop, spans) logged;
    where every selected position holds a row, also against mla_decode
    over the gathered rows as one dense chunk (the same loop and spans over
    the same rows in the same order), timed beside it as the gather's
    yardstick."""
    from repro_torch.kernels import build
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.mla_decode import ops as mla_ops
    from repro_torch.kernels.sparse_select import (sparse_select,
                                                   sparse_select_ref)
    from repro_torch.kernels.sparse_select import ops as sel_ops
    from repro_torch.kernels.sparse_select.ref import covered_rows
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    atol, rtol = TOL["sparse_select"]
    D, d_v, scale = cfg.d_qk, cfg.kv_lora_rank, cfg.scale
    g = torch.Generator(device=dev).manual_seed(4)
    worst, cases = 0.0, []
    res = {}
    for loop, lp in mla_ops.LOOPS.items():
        smem, per_sm = sel_ops.resources(loop, D)
        res[loop] = {"smem_bytes": smem, "blocks_per_sm": per_sm}
        log(f"[kernels] sparse_select loop {loop} at D={D}: {smem} B of "
            f"dynamic shared memory a block, {per_sm} block(s) an SM "
            f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor; the plan "
            f"assumes {lp.blocks_per_sm})")
        if per_sm < lp.blocks_per_sm:
            fail(f"sparse_select loop {loop}: {per_sm} blocks an SM, the "
                 f"plan's cooperative launches need {lp.blocks_per_sm}")

    def compare(tag, got, want, what="its plain version"):
        nonlocal worst
        torch.cuda.synchronize()
        e = {k: max_err(torch, getattr(got, k), getattr(want, k))
             for k in ("o", "m", "l")}
        ok = all(within(torch, getattr(got, k), getattr(want, k), atol, rtol)
                 for k in ("o", "m", "l"))
        log(f"[kernels] sparse_select {tag} vs {what}: max|err| o "
            f"{e['o']:.3e} m {e['m']:.3e} l {e['l']:.3e} (atol {atol:g}, "
            f"rtol {rtol:g}) {'ok' if ok else 'OVER TOLERANCE'}")
        if not ok:
            fail(f"sparse_select {tag} disagrees with {what}")
        worst = max(worst, e["o"])

    for tag, R, S, ids, kb, bt in _sparse_cases():
        B = len(ids)
        q = torch.randn((B, R, D), device=dev, generator=g)
        ckv = torch.randn((B, S, D), device=dev, generator=g)
        idx = torch.tensor(ids, dtype=torch.int32, device=dev)
        kbt = None if kb is None else torch.tensor(kb, dtype=torch.int32,
                                                   device=dev)

        def kernel():
            return sparse_select(q, ckv, idx, kbt, d_v=d_v, scale=scale,
                                 block_tokens=bt)

        def plain():
            return sparse_select_ref(q, ckv, idx, kbt, None, d_v, bt, scale)

        plan = sel_ops.select_plan(B, R, idx.shape[1], bt,
                                   build.sm_count(dev))
        before = sparse_select.launches
        got = kernel()
        if sparse_select.launches != before + 1:
            fail(f"sparse_select {tag}: not one launch a call")
        compare(f"{tag} (loop {plan.loop} x {plan.n_split} spans)", got,
                plain())
        if kb is not None:
            torch.cuda.synchronize()
            if not (bool((got.o[2] == 0).all()) and bool((got.l[2] == 0).all())
                    and bool(torch.isneginf(got.m[2]).all())):
                fail("sparse_select: the kb = 0 row is not the identity")
        if len(ids[0]) * bt == S:           # every row selected
            compare(tag, got, mla_decode(q, ckv, d_v=d_v, scale=scale),
                    "mla_decode over the whole chunk")
        rows, valid = covered_rows(idx, kbt, None, bt, S)
        dense_ms = bits = None
        if bool(valid.all()):
            # the gathered rows as one dense (B, T, D) chunk
            dense = torch.gather(ckv, 1, rows[..., None].expand(-1, -1, D))
            want = mla_decode(q, dense, d_v=d_v, scale=scale)
            compare(tag, got, want, "mla_decode over the gathered rows")
            bits = all(torch.equal(a, b) for a, b in zip(got, want))
            dense_ms, _ = time_ms(
                torch, lambda: mla_decode(q, dense, d_v=d_v, scale=scale),
                100 if R < 256 else 20)
        mask = torch.zeros((B, S), dtype=torch.bool, device=dev)
        batch = torch.arange(B, device=dev)[:, None].expand_as(rows)
        mask[batch[valid], rows[valid]] = True
        ms, host_ms = time_ms(torch, kernel, 100 if R < 256 else 20)
        plain_ms, _ = time_ms(torch, plain, PLAIN_ITERS)
        q4, k4, v4 = q[:, None], ckv[:, None], ckv[:, None, :, :d_v]
        m4 = mask[:, None, None, :]
        try:
            lib_ms, _ = time_ms(
                torch, lambda: sdpa(q4, k4, v4, attn_mask=m4, scale=scale),
                PLAIN_ITERS)
        except RuntimeError as exc:       # a yardstick only, never a check
            log(f"[kernels] sdpa yardstick unavailable: {exc}")
            lib_ms = None
        t_sel = int(valid.sum())            # selected rows these inputs hold
        nbytes = 4 * (B * R * D + t_sel * D + B * R * (d_v + 2)
                      + idx.numel() + (0 if kb is None else B))
        flops = 2.0 * R * t_sel * (D + d_v)
        b_ms, b_by = bound(nbytes, flops)
        typed = typed_caches(
            torch, dev, "sparse_select", tag, ckv,
            lambda c: sparse_select(q, c, idx, kbt, d_v=d_v, scale=scale,
                                    block_tokens=bt),
            partial_bytes(plan, B, R, d_v), 100 if R < 256 else 20)
        cases.append({"shape": f"q({B},{R},{D}) ckv({B},{S},{D}) "
                               f"{tag}, {t_sel} selected rows",
                      "loop": plan.loop, "n_split": plan.n_split,
                      "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "mla_decode_gathered_ms": dense_ms,
                      "bits_equal_mla_decode_gathered": bits,
                      "caches": typed,
                      **({"resources": res} if not cases else {})})
        log(f"[kernels] sparse_select {tag}: loop {plan.loop} x "
            f"{plan.n_split} spans, {ms:.4f} ms device, {host_ms:.4f} ms as "
            f"issued (plain {plain_ms:.4f}, sdpa with mask {lib_ms}, bound "
            f"{b_ms:.5f} by {b_by}; mla_decode over the gathered rows "
            f"{dense_ms}, bits equal: {bits}); "
            + ", ".join(f"{k} cache {v['ms']:.4f} ms"
                        for k, v in typed.items()))
    return worst, cases


# card 0's peak in (c3)'s unsharded long_500k decode, when the decode
# wrappers cast a bf16 cache to f32 before each launch (PERF.md §6)
LONG_PEAK_CAST_GIB = 52.94


def long_unsharded_peak(torch, dev, v2_lite):
    """5e (c3)'s unsharded long_500k decode on this card (V2-Lite as
    published in bf16, one row, LONG_SLOTS slots, selection_k LONG_K,
    LONG_STEPS steps, KERNELS): finite logits, and its peak memory held
    below LONG_PEAK_CAST_GIB, the peak of the same run when sparse_select's
    wrapper cast the bf16 cache to f32 (1.2 GB a layer) before each call."""
    from repro_torch.models import model as M
    cfg = dataclasses.replace(v2_lite, selection_k=LONG_K)
    first = torch.randint(0, cfg.vocab, (1, 1), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(2))
    t0 = time.perf_counter()
    r = long_unsharded(torch, M, cfg, dev, first, M.KERNELS,
                       dtype=torch.bfloat16)
    wall = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(lg).all()) for lg in r["logits"])
    peak = r["peak_gib"]
    log(f"[long] 5e (c3)'s unsharded long_500k decode on card 0: "
        f"{cfg.name} ({cfg.n_layers} layers) in bf16, {LONG_SLOTS} slots, "
        f"selection_k {LONG_K}, {LONG_STEPS} steps, KERNELS: peak "
        f"{peak:.2f} GiB (with the f32 cast of the cache: "
        f"{LONG_PEAK_CAST_GIB:.2f} GiB); steps "
        + ", ".join(f"{w * 1e3:.1f}" for w in r["decode_s"])
        + f" ms; logits finite: {finite}; {wall:.1f} s")
    if not finite:
        fail("long_500k unsharded: non-finite logits")
    if peak >= LONG_PEAK_CAST_GIB:
        fail(f"long_500k unsharded: peak {peak:.2f} GiB, not below the "
             f"{LONG_PEAK_CAST_GIB:.2f} GiB of the run that cast its cache")
    return {"peak_gib": peak, "peak_cast_gib": LONG_PEAK_CAST_GIB,
            "decode_s": r["decode_s"], "wall_s": wall}


def check_flash_prefill(torch, dev, cfg, dtype):
    """flash_prefill with operands of `dtype`: f32 runs csrc/flash_prefill.cu
    (CUDA cores), bf16 csrc/flash_prefill_bf16.cu (tensor cores); each
    against the plain version on the same inputs, timed beside it and
    beside SDPA in the same dtype."""
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_ref)
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    bf16 = dtype == torch.bfloat16
    name = "flash_prefill_bf16" if bf16 else "flash_prefill"
    key = "bfloat16" if bf16 else "float32"
    atol, rtol = TOL[name]
    D, d_v, scale, H = cfg.d_qk, cfg.kv_lora_rank, cfg.scale, cfg.n_heads
    g = torch.Generator(device=dev).manual_seed(6)
    worst, cases = 0.0, []
    res = {}
    if not bf16:
        from repro_torch.kernels.flash_prefill.ops import f32_resources
        smem, per_sm = f32_resources(D, d_v)
        res = {"smem_bytes": smem, "blocks_per_sm": per_sm}
        log(f"[kernels] {name} f32 kernel at D={D}, d_v={d_v}: {smem} B of "
            f"dynamic shared memory a block, {per_sm} block(s) an SM "
            f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    # one V2-Lite sequence, its last 256 queries over the whole cache
    # (tail-aligned), a ragged length no tile divides
    for Sq, Sk in ((CHUNK, CHUNK), (256, CHUNK), (2000, 2000)):
        q = torch.randn((1, Sq, H, D), device=dev, generator=g).to(dtype)
        ckv = torch.randn((1, Sk, D), device=dev, generator=g).to(dtype)
        before = flash_prefill.launches_by_dtype[key]
        got = flash_prefill(q, ckv, d_v=d_v, scale=scale)
        if flash_prefill.launches_by_dtype[key] != before + 1:
            fail(f"{name}: the {key} operands did not launch the {key} "
                 "kernel")
        want = flash_prefill_ref(q, ckv, d_v, scale)
        torch.cuda.synchronize()
        e = max_err(torch, got, want)
        ok = within(torch, got, want, atol, rtol)
        tag = f"q(1,{Sq},{H},{D}) ckv(1,{Sk},{D}) {key}"
        log(f"[kernels] {name} {tag}: max|err| {e:.3e} (atol "
            f"{atol:g}, rtol {rtol:g}) {'ok' if ok else 'OVER TOLERANCE'}")
        if not ok:
            fail(f"{name} {tag} disagrees with its plain version")
        worst = max(worst, e)
        ms, host_ms = time_ms(
            torch, lambda: flash_prefill(q, ckv, d_v=d_v, scale=scale),
            50 if bf16 else 10)
        plain_ms, _ = time_ms(
            torch, lambda: flash_prefill_ref(q, ckv, d_v, scale), 10)
        lib_ms = lib_err = None
        if Sq == Sk:     # SDPA's is_causal aligns to the top left
            q4 = q.transpose(1, 2)
            k4 = ckv[:, None].expand(1, H, Sk, D)
            v4 = ckv[:, None, :, :d_v].expand(1, H, Sk, d_v)
            try:
                lib_ms, _ = time_ms(torch, lambda: sdpa(
                    q4, k4, v4, is_causal=True, scale=scale), 10)
                # a data point beside its time, never a check
                lib_err = max_err(torch, sdpa(q4, k4, v4, is_causal=True,
                                              scale=scale)
                                  .transpose(1, 2).float(), want)
            except RuntimeError as exc:   # a yardstick only, never a check
                log(f"[kernels] sdpa yardstick unavailable: {exc}")
        seen = sum(Sk - Sq + i + 1 for i in range(Sq))   # causal pairs
        width = 2 if bf16 else 4                         # operand bytes
        nbytes = width * (Sq * H * D + Sk * D) + 4 * Sq * H * d_v
        flops = 2.0 * H * seen * (D + d_v)
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_S if bf16 else PEAK_F32_S)
        cases.append({"shape": tag, "ms": ms, "host_ms": host_ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "library_max_abs_err": lib_err, "max_abs_err": e,
                      "bound_ms": b_ms, "bound_by": b_by, **res})
        b3 = ""
        if not bf16:
            b3_ms, b3_by = bound(nbytes, flops, PEAK_TF32_S / 3)
            cases[-1]["bound_3xtf32_ms"] = b3_ms
            b3 = f", 3xTF32 bound {b3_ms:.5f} by {b3_by}"
        split = ""
        if bf16:
            us = device_split_us(
                torch, lambda: flash_prefill(q, ckv, d_v=d_v, scale=scale))
            cases[-1]["device_us_by_kernel"] = us
            split = "; profiler µs/call " + ", ".join(
                f"{k} {v:.1f}" for k, v in us.items())
        log(f"[kernels] {name} {tag}: {ms:.4f} ms device, "
            f"{host_ms:.4f} ms as issued (plain {plain_ms:.4f}, sdpa causal "
            f"{lib_ms} at max|err| {lib_err} vs plain, bound {b_ms:.5f} by "
            f"{b_by}{b3}){split}")
    return worst, cases


def check_ssd_chunk(torch, dev, mcfg, zcfg):
    """mcfg Mamba2-370m's and zcfg Zamba2-7B's Mamba2 geometry."""
    from repro_torch.kernels.ssd_chunk import (ssd_intra_chunk,
                                               ssd_intra_chunk_ref)
    from repro_torch.kernels.ssd_chunk.ops import resources
    atol, rtol = TOL["ssd_chunk"]
    g = torch.Generator(device=dev).manual_seed(7)
    worst, cases = 0.0, []
    for c in (mcfg, zcfg):
        smem, per_sm = resources(c.chunk, c.head_dim, c.d_state)
        log(f"[kernels] ssd_chunk at Q={c.chunk}, P={c.head_dim}, "
            f"N={c.d_state}: {smem} B of dynamic shared memory a block, "
            f"{per_sm} block(s) an SM "
            f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    # one 2048-token sequence of mamba2-370m; a head block that does not
    # divide H; model (c)'s prefill (two sequences, the wrapper's hb); 5d
    # (a)'s Zamba2-7B prefill (two sequences, 112 heads in 28 blocks of 4)
    for c, b, hb in ((mcfg, 1, 4), (mcfg, 1, 5), (mcfg, MODEL_BATCH, 4),
                     (zcfg, MODEL_BATCH, 4)):
        Q, H, P, N = c.chunk, c.n_heads, c.head_dim, c.d_state
        nc = (CHUNK if b == 1 else MODEL_PROMPT) // Q
        smem, per_sm = resources(Q, P, N)
        # drawn as the reference's kernel test draws them
        rnd = lambda *shape: torch.randn(shape, device=dev, generator=g)
        ins = (rnd(b, nc, Q, H, P),
               torch.nn.functional.softplus(rnd(b, nc, Q, H)),
               -torch.exp(0.5 * rnd(H)), rnd(b, nc, Q, N), rnd(b, nc, Q, N))
        got = ssd_intra_chunk(*ins, hb=hb)
        want = ssd_intra_chunk_ref(*ins)
        torch.cuda.synchronize()
        errs = [max_err(torch, a, w) for a, w in zip(got, want)]
        ok = all(within(torch, a, w, atol, rtol) for a, w in zip(got, want))
        tag = f"x({b},{nc},{Q},{H},{P}) B/C({b},{nc},{Q},{N}) hb={hb}"
        log(f"[kernels] ssd_chunk {tag}: max|err| y {errs[0]:.3e} states "
            f"{errs[1]:.3e} cum {errs[2]:.3e} (atol {atol:g}, rtol {rtol:g})"
            f" {'ok' if ok else 'OVER TOLERANCE'}")
        if not ok:
            fail(f"ssd_chunk {tag} disagrees with its plain version")
        worst = max(worst, *errs)
        ms, host_ms = time_ms(torch, lambda: ssd_intra_chunk(*ins, hb=hb),
                              50)
        plain_ms, _ = time_ms(torch, lambda: ssd_intra_chunk_ref(*ins),
                              PLAIN_ITERS)
        seen = Q * (Q + 1) // 2
        flops = 2.0 * b * nc * (H * (seen * P + Q * P * N) + Q * Q * N)
        nbytes = 4 * b * nc * (2 * Q * H * P + 2 * Q * H + 2 * Q * N
                               + H * P * N) + 4 * H
        b_ms, b_by = bound(nbytes, flops)
        b3_ms, b3_by = bound(nbytes, flops, PEAK_TF32_S / 3)
        cases.append({"shape": tag, "ms": ms, "host_ms": host_ms,
                      "plain_ms": plain_ms, "library_ms": None,
                      "max_abs_err": dict(zip(("y", "states", "cum"), errs)),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "bound_3xtf32_ms": b3_ms, "smem_bytes": smem,
                      "blocks_per_sm": per_sm})
        log(f"[kernels] ssd_chunk {tag}: {ms:.4f} ms device, {host_ms:.4f} "
            f"ms as issued (plain {plain_ms:.4f}, bound {b_ms:.5f} by "
            f"{b_by}, 3xTF32 bound {b3_ms:.5f} by {b3_by})")
    return worst, cases


# ---------------------------------------------------------------------------
# phase 5: the golden scenarios, built with the port's engine
# ---------------------------------------------------------------------------

def scenarios(ecfg=None):
    """The three dense goldens; ecfg (an EngineConfig, default the
    engine's) sets the fabrics that price them."""
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
    ecfg = ecfg or EngineConfig()

    def routed_only(backend):
        eng = ServingEngine(8, pool_tokens=10**6, cfg=ecfg,
                            instances_per_pod=4, backend=backend)
        for i in range(6):
            eng.register_chunk(f"c{i}", holder=i % 4, length=2048)
        return eng, [
            [Request(0, home=4, chunk_ids=["c0", "c1"], m_q=64),
             Request(1, home=5, chunk_ids=["c2"], m_q=128),
             Request(2, home=1, chunk_ids=["c0"], m_q=32)],
            [Request(0, home=4, chunk_ids=["c0", "c1"], m_q=64),
             Request(3, home=6, chunk_ids=["c3", "c4"], m_q=16)],
            [Request(4, home=2, chunk_ids=["c5"], m_q=256)]]

    def fetch_heavy(backend):
        eng = ServingEngine(4, pool_tokens=10**6, cfg=ecfg,
                            backend=backend)
        for i in range(3):
            eng.register_chunk(f"doc{i}", holder=1 + (i % 3), length=2048)
        reqs = [Request(i, home=0, chunk_ids=[f"doc{i}"], m_q=1,
                        expected_reuse_steps=100_000) for i in range(3)]
        return eng, [reqs, reqs, reqs]

    def mixed_congested(backend):
        eng = ServingEngine(8, pool_tokens=10**6, cfg=ecfg,
                            instances_per_pod=8, backend=backend)
        for i in range(4):
            eng.register_chunk(f"hot{i}", holder=1, length=2048)
        eng.register_chunk("cold", holder=2, length=2048)
        eng.register_chunk("tiny", holder=1, length=8)
        return eng, [
            [Request(i, home=3 + i, chunk_ids=[f"hot{i}"], m_q=1024)
             for i in range(4)]
            + [Request(10, home=7, chunk_ids=["cold"], m_q=1,
                       expected_reuse_steps=100_000),
               Request(11, home=6, chunk_ids=["tiny"], m_q=4096)],
            [Request(i, home=3 + i, chunk_ids=[f"hot{i}"], m_q=1024)
             for i in range(2)]
            + [Request(10, home=7, chunk_ids=["cold"], m_q=1,
                       expected_reuse_steps=100_000)]]

    return {"routed_only": routed_only, "fetch_heavy": fetch_heavy,
            "mixed_congested": mixed_congested}


def selection_scenario(backend=None, selector=None, ecfg=None):
    """The frozen selection-regime trace of the reference's test scenarios:
    two selecting requests over chunks of 192 and 160 tokens (2.5 blocks:
    a partial tail block), a dense rider, a chunk the budget leaves
    empty."""
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
    eng = ServingEngine(4, pool_tokens=10**6, cfg=ecfg or EngineConfig(),
                        instances_per_pod=2, backend=backend,
                        selector=selector)
    eng.register_chunk("sel0", holder=1, length=192)
    eng.register_chunk("sel1", holder=2, length=192)
    eng.register_chunk("sel2", holder=3, length=160)
    return eng, [
        [Request(0, home=0, chunk_ids=["sel0", "sel1"], m_q=4,
                 k_selected=128),
         Request(1, home=0, chunk_ids=["sel2"], m_q=1, k_selected=96),
         Request(2, home=3, chunk_ids=["sel0"], m_q=8)],
        [Request(0, home=0, chunk_ids=["sel0", "sel1"], m_q=4,
                 k_selected=128),
         Request(3, home=2, chunk_ids=["sel1", "sel2"], m_q=2,
                 k_selected=64)]]


def _analytic_twin(build, svc):
    """The scenario on the analytic backend, replaying the live indexer's
    selections (an analytic engine's own indexer would materialize other
    arrays)."""
    from repro_torch.serving.backends import AnalyticBackend
    from repro_torch.serving.selection import (ReplaySelector,
                                               selection_trace_payload)
    return build(AnalyticBackend(), ReplaySelector(selection_trace_payload(
        svc.log, svc.block_tokens, svc.d_index)))


def run_selection_goldens(torch, cfg, device="cuda"):
    """selection_scenario and a FETCH forced under selection (the gather
    path: it must persist no replica), against the selection oracle and
    the analytic twin's StepStats."""
    import dataclasses
    from repro_torch.serving.backends import AnalyticBackend
    from repro_torch.serving.backends.torch_exec import (TorchExecBackend,
                                                         max_oracle_err)
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.selection import IndexerService
    svc = IndexerService(mla=cfg, device=device)
    exe, steps = selection_scenario(TorchExecBackend(cfg, device=device),
                                    svc)
    err = 0.0
    for reqs in steps:
        exe.schedule_step(reqs)
        if not exe.plans[-1].selections:
            fail("selection scenario: a step ran without selections")
        err = max(err, max_oracle_err(exe, reqs, exe.step_idx))
    ana, _ = _analytic_twin(selection_scenario, svc)
    for reqs in steps:
        ana.schedule_step(reqs)
    if [s.comparable() for s in ana.stats] \
            != [s.comparable() for s in exe.stats]:
        fail("selection scenario: StepStats differ from the analytic twin")
    prims = sorted({r.primitive for r in exe.log})
    log(f"[goldens] selection_scenario: StepStats == analytic twin over "
        f"{len(steps)} steps, primitives {prims}, "
        f"{sum(s.n_selected for s in exe.stats)} selected pairs, max|err| "
        f"vs selection oracle {err:.3e} (atol {ORACLE_ATOL:g})")
    if not err <= ORACLE_ATOL:
        fail(f"selection scenario: outputs off the oracle by {err:.3e}")

    def forced_fetch(backend, selector):
        eng = ServingEngine(2, pool_tokens=10**5, backend=backend,
                            selector=selector)
        eng.register_chunk("doc", holder=1, length=160)
        rq = Request(0, home=0, chunk_ids=["doc"], m_q=2, k_selected=96)
        plan = eng.plan_step([rq])
        plan = dataclasses.replace(plan, records=[
            dataclasses.replace(r, primitive="fetch") for r in plan.records])
        ex = eng.backend.execute(eng, plan)
        eng._account(plan, ex, 0.0)
        return eng, [[rq]]

    svc = IndexerService(mla=cfg, device=device)
    exe, steps = forced_fetch(TorchExecBackend(cfg, device=device), svc)
    ana, _ = _analytic_twin(forced_fetch, svc)
    if [s.comparable() for s in ana.stats] \
            != [s.comparable() for s in exe.stats]:
        fail("forced FETCH under selection: StepStats differ from the "
             "analytic twin")
    if exe.log[0].primitive != "fetch" or not exe.plans[0].selections:
        fail("forced FETCH under selection did not run as a selected FETCH")
    ferr = max_oracle_err(exe, steps[0], 1)
    doc = exe.store.lookup("doc")
    log(f"[goldens] forced FETCH under selection: StepStats == analytic "
        f"twin, max|err| vs selection oracle {ferr:.3e} (atol "
        f"{ORACLE_ATOL:g}), replicas {doc.replicas}")
    if not ferr <= ORACLE_ATOL:
        fail(f"forced FETCH under selection: off the oracle by {ferr:.3e}")
    if doc.replicas or doc.replica_data:
        fail("forced FETCH under selection persisted a replica")
    return max(err, ferr)


def run_goldens(torch, cfg, device="cuda"):
    from repro_torch.serving.backends import AnalyticBackend
    from repro_torch.serving.backends.torch_exec import (TorchExecBackend,
                                                         oracle_partial)
    worst = 0.0
    for name, build in scenarios().items():
        ana, steps = build(AnalyticBackend())
        backend = TorchExecBackend(cfg, device=device)
        exe, _ = build(backend)
        for reqs in steps:
            ana.schedule_step(reqs)
            exe.schedule_step(reqs)
        if [s.comparable() for s in ana.stats] \
                != [s.comparable() for s in exe.stats]:
            fail(f"golden {name}: StepStats differ from the analytic run")
        err = 0.0
        for step, reqs in enumerate(steps, start=1):
            outs = exe.outputs_of(step)
            for rq in reqs:
                want = oracle_partial(cfg, exe.store, rq, step,
                                      q=backend.fresh_query(rq, step))
                err = max(err, max_err(torch, outs[rq.req_id].o, want.o))
        prims = sorted({r.primitive for r in exe.log})
        log(f"[goldens] {name}: StepStats == analytic over {len(steps)} "
            f"steps, primitives {prims}, max|err| vs oracle {err:.3e} "
            f"(atol {ORACLE_ATOL:g})")
        if not err <= ORACLE_ATOL:
            fail(f"golden {name}: outputs off the oracle by {err:.3e}")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phase 4c: the multi-instance backend (a stream per serving instance)
# ---------------------------------------------------------------------------

# the analytic side prices this card's fabrics (core/constants.py): NVLink 4
# inside a pod, IBGDA between pods. One card partitioned into instances is
# not that fabric: a transfer is a copy inside HBM, and the measured /
# analytic ratios are reported as measured, with no limit.
MESH_FABRICS = ("h100_nvlink4", "h100_ibgda")
# fused against serial: the same kernels on the same inputs with the same
# plans, in another issue order (and the FETCH splice as one launch from the
# holder's rows vs a copy then an in-place delta-0 splice, bit for bit)
MESH_MODES_ATOL = 1e-6


def mesh_ecfg():
    from repro_torch.serving.engine import EngineConfig
    return EngineConfig(intra_pod_fabric=MESH_FABRICS[0],
                        cross_pod_fabric=MESH_FABRICS[1])


def _us(x):
    return "-" if x is None else f"{x * 1e6:.2f}"


def stage_rows(logs):
    """The backend's per-step stage logs aggregated by (path, stage): how
    many, and the medians of the analytic duration, the measured one (the
    serial host wall, or the fused group's apportioned device wall) and the
    serial CUDA-event time."""
    groups = {}
    for entries in logs:
        for e in entries:
            groups.setdefault((e["kind"], e["stage"]), []).append(e)
    rows = []
    for (kind, stage), es in sorted(groups.items()):
        row = {"kind": kind, "stage": stage, "n": len(es)}
        for k in ("analytic_s", "measured_s", "device_s"):
            vals = [e[k] for e in es if e.get(k) is not None]
            row[k] = statistics.median(vals) if vals else None
        rows.append(row)
    return rows


def log_stage_rows(tag, rows, fused):
    what = "fused group share" if fused else "host"
    for r in rows:
        ratio = (f"x{r['measured_s'] / r['analytic_s']:.3g}"
                 if r["analytic_s"] else "-")
        event = "" if fused else f", event {_us(r['device_s'])} us"
        log(f"[mesh] {tag} {r['kind']:>23} {r['stage']:<8} n {r['n']:3d}: "
            f"analytic {_us(r['analytic_s'])} us, {what} "
            f"{_us(r['measured_s'])} us{event} ({ratio})")


def log_step_totals(tag, backend):
    """Each step's stage walls summed over its dispatch groups, beside the
    analytic sums: the serial host wall and CUDA-event time, or the fused
    groups' apportioned device walls."""
    for step, entries in sorted(backend.stage_log.items()):
        tot = {}
        for e in entries:
            t = tot.setdefault(e["stage"], [0.0, 0.0, 0.0])
            t[0] += e["analytic_s"]
            t[1] += e["measured_s"]
            t[2] += e.get("device_s") or 0.0
        body = ", ".join(
            f"{k} a {_us(a)} / {'fused' if backend.fused else 'host'} "
            f"{_us(m)}" + ("" if backend.fused else f" / event {_us(d)}")
            for k, (a, m, d) in tot.items())
        log(f"[mesh] {tag} step {step} (us): {body}")


def run_mesh_serve(torch, serve, extra, device="cuda", devices=None):
    """The serve CLI through --backend shard_map at V2-Lite width (its mesh
    over `devices`, the card slots; None: the CLI's own, every visible
    card once): every step within ORACLE_ATOL of its oracle and a measured
    report with no filled stage."""
    argv = (["--backend", "shard_map", "--device", device, "--exec-geometry",
             "v2-lite", "--verify", "--intra-fabric", MESH_FABRICS[0],
             "--cross-fabric", MESH_FABRICS[1]] + extra)
    log(f"[mesh] repro_torch.launch.serve {' '.join(argv)}"
        + ("" if devices is None else f" (slots {slot_names(devices)})"))
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eng = serve.main(argv, devices=devices)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    sys.stdout.write(out)
    errs = [float(x) for x in re.findall(r"max\|err\| (\S+)", out)]
    if len(errs) != 5 or not all(e <= ORACLE_ATOL for e in errs):
        fail(f"mesh serve {extra}: per-step max|err| {errs} (want 5 steps, "
             f"each <= {ORACLE_ATOL:g})")
    reps = eng.measured_reports
    if len(reps) != 5 or any(r is None or r.stage_fills for r in reps):
        fail(f"mesh serve {extra}: measured reports {reps!r} (want 5, no "
             f"filled stage)")
    return wall, eng


def stream_trace(torch, fn):
    """fn() once under torch.profiler: each device kernel as (name, stream,
    start us, duration us), from the trace's kernel events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", "mesh_step_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return [(e["name"], e.get("args", {}).get("stream"), e["ts"], e["dur"])
            for e in events if e.get("cat") == "kernel"]


def mesh_concurrency(kernels):
    """(streams that ran a kernel, kernels by name family, share of the
    busy time with two or more kernels running at once)."""
    edges = sorted([(ts, 1) for _, _, ts, _ in kernels]
                   + [(ts + dur, -1) for _, _, ts, dur in kernels])
    busy = multi = 0.0
    active, last = 0, None
    for t, d in edges:
        if last is not None and active >= 1:
            busy += t - last
            if active >= 2:
                multi += t - last
        active += d
        last = t
    fams = {}
    for name, _, _, _ in kernels:
        # mla_decode and sparse_select run the decode loops of
        # csrc/decode_launch.cuh (tiled_kernel, attend_kernel)
        fam = next((k for k in ("tiled_kernel", "attend_kernel",
                                "merge_kernel", "splice_kernel")
                    if k in name), "other")
        fams[fam] = fams.get(fam, 0) + 1
    return ({st for _, st, _, _ in kernels}, fams,
            multi / busy if busy else 0.0)


def profile_mesh_step(torch, serve, devices=None):
    """One fused step of the serve default world (after a warm step) under
    the profiler: the streams its kernels ran on and how much of the busy
    time had more than one kernel running."""
    args = serve.build_parser().parse_args(
        ["--backend", "shard_map", "--device", "cuda", "--exec-geometry",
         "v2-lite", "--selection-frac", "0", "--intra-fabric",
         MESH_FABRICS[0], "--cross-fabric", MESH_FABRICS[1]])
    eng = serve.build_engine(args, devices)
    steps = serve.build_trace(args, eng)
    eng.schedule_step(steps[0])
    kernels = stream_trace(torch, lambda: eng.schedule_step(steps[1]))
    streams, fams, overlap = mesh_concurrency(kernels)
    log(f"[mesh] one fused serve step under the profiler: {len(kernels)} "
        f"kernels {fams} on {len(streams)} streams; two or more kernels "
        f"running in {overlap:.1%} of the busy time")
    if len(streams) < 2:
        fail("fused mesh step: every kernel ran on one stream")
    return {"kernels": len(kernels), "streams": len(streams),
            "overlap_share": overlap}


# The index stage when the mesh service scored in host numpy after copying
# the gathered query back (its earlier version, on an NVIDIA H100 80GB HBM3
# at 700 W): the serial median host wall and the analytic stage, us
INDEX_HOST_US, INDEX_ANALYTIC_US = 361.79, 16.04


def check_mesh_indexer(eng, tag, acc):
    """The mesh service's verdicts (on-card scoring) against a host
    IndexerService's on the same store and queries, per (step, request,
    chunk): the blocks must be equal (a near-tie flip fails, printing the
    two pooled block scores of every block that differs). Accumulates the
    pairs checked, the service's call walls by mode (fused or serial) and
    the plan's analytic index stages into acc."""
    from repro_torch.core import selection as SEL
    from repro_torch.serving.selection import IndexerService
    svc = eng.selector
    host = IndexerService(svc.cfg, svc.mla, svc.dtype, svc.device,
                          svc.query_source)
    n = 0
    for step, sels in sorted(svc.log.items()):
        reqs = {rq.req_id: rq for rq in eng.plans[step - 1].requests}
        for rid, got in sorted(sels.items()):
            rq = reqs[rid]
            want = host.select_request(eng.store, rq, step)
            for cid in rq.chunk_ids:
                n += 1
                if got.blocks[cid] == want.blocks[cid]:
                    continue
                iq = host.index_query(rq, step)
                card = SEL.block_scores(svc.pooled_scores(
                    eng.store, rq, iq, cid, step), svc.block_tokens)
                hst = SEL.block_scores(host.pooled_scores(
                    eng.store, rq, iq, cid, step), svc.block_tokens)
                flips = sorted(set(got.blocks[cid]) ^ set(want.blocks[cid]))
                fail(f"mesh indexer {tag}: step {step}, request {rid}, chunk "
                     f"{cid}: blocks {got.blocks[cid]} on the card, "
                     f"{want.blocks[cid]} on the host; pooled block scores "
                     + ", ".join(f"block {b}: card {float(card[b])!r} / host "
                                 f"{float(hst[b])!r}" for b in flips))
    acc["pairs"] += n
    acc["fused" if eng.backend.fused else "serial"] += list(
        svc.measured_index_s.values())
    acc["analytic"] += [e["analytic_s"]
                        for es in eng.backend.stage_log.values() for e in es
                        if e["stage"] == "index"]
    log(f"[mesh] {tag}: on-card index scoring chose the host "
        f"IndexerService's blocks for all {n} (step, request, chunk)")


def run_mesh_goldens(torch, cfg, index_acc, device="cuda", devices=None,
                     outs=None):
    """The three dense goldens and the selection scenario (priced on the
    H100 fabrics) through ShardMapExecBackend over `devices`, fused and
    serial: StepStats equal to the analytic run, outputs within
    ORACLE_ATOL of the oracle, fused against serial within
    MESH_MODES_ATOL, no filled stage on any planned step; the selection
    scenario's verdicts against the host indexer's (check_mesh_indexer).
    Every output lands in outs (keep_outputs)."""
    import functools
    from repro_torch.serving.backends import AnalyticBackend
    from repro_torch.serving.backends.shard_map import ShardMapExecBackend
    from repro_torch.serving.backends.torch_exec import max_oracle_err
    from repro_torch.serving.selection import ShardMapIndexerService
    ecfg = mesh_ecfg()
    worst = {"oracle": 0.0, "modes": 0.0}
    logs = {"fused": [], "serial": []}
    sel_build = functools.partial(selection_scenario, ecfg=ecfg)
    cases = [(name, lambda be, b=build: b(be)[0], build(AnalyticBackend()))
             for name, build in scenarios(ecfg).items()]
    svcs = {}

    def with_indexer(be):
        svcs[be.fused] = ShardMapIndexerService(mla=cfg, device=device,
                                                devices=devices)
        return sel_build(be, svcs[be.fused])[0]
    cases.append(("selection_scenario", with_indexer, None))
    for name, build, ana_steps in cases:
        engines = {}
        for mode in ("fused", "serial"):
            be = ShardMapExecBackend(cfg, device=device,
                                     fused=mode == "fused", devices=devices)
            eng = engines[mode] = build(be)
            steps = ana_steps[1] if ana_steps else sel_build()[1]
            for reqs in steps:
                eng.schedule_step(reqs)
        if ana_steps is None:
            ana, _ = _analytic_twin(sel_build, svcs[True])
        else:
            ana = ana_steps[0]
        for reqs in steps:
            ana.schedule_step(reqs)
        for mode, eng in engines.items():
            if [s.comparable() for s in ana.stats] \
                    != [s.comparable() for s in eng.stats]:
                fail(f"mesh golden {name} ({mode}): StepStats differ from "
                     f"the analytic run")
            reps = eng.measured_reports
            if len(reps) != len(steps) or any(
                    r is None or r.stage_fills for r in reps):
                fail(f"mesh golden {name} ({mode}): a step without a "
                     f"measured report or with filled stages")
            for step, reqs in enumerate(steps, start=1):
                worst["oracle"] = max(worst["oracle"],
                                      max_oracle_err(eng, reqs, step))
            log_step_totals(f"{name} {mode}", eng.backend)
            logs[mode] += list(eng.backend.stage_log.values())
            if outs is not None:
                keep_outputs(outs, f"golden {name} {mode}", eng,
                             len(steps))
            if eng.selector is not None:
                check_mesh_indexer(eng, f"{name} {mode}", index_acc)
        modes = 0.0
        for step in range(1, len(steps) + 1):
            fo = engines["fused"].outputs_of(step)
            so = engines["serial"].outputs_of(step)
            if sorted(fo) != sorted(so):
                fail(f"mesh golden {name}: the modes output other requests")
            for rid in fo:
                for k in range(3):
                    modes = max(modes, max_err(torch, fo[rid][k],
                                               so[rid][k]))
        worst["modes"] = max(worst["modes"], modes)
        prims = sorted({r.primitive for r in engines["fused"].log})
        log(f"[mesh] {name}: both modes StepStats == analytic over "
            f"{len(steps)} steps, primitives {prims}, no filled stage; "
            f"fused vs serial max|diff| {modes:.3e} (atol "
            f"{MESH_MODES_ATOL:g})")
        if not modes <= MESH_MODES_ATOL:
            fail(f"mesh golden {name}: fused and serial differ by "
                 f"{modes:.3e}")
    if not worst["oracle"] <= ORACLE_ATOL:
        fail(f"mesh goldens: outputs off the oracle by {worst['oracle']:.3e}")
    log(f"[mesh] goldens max|err| vs oracle {worst['oracle']:.3e} (atol "
        f"{ORACLE_ATOL:g})")
    return worst, logs


def slot_names(devices):
    return "[" + ", ".join(str(d) for d in devices) + "]"


def keep_outputs(outs, label, eng, n_steps):
    """Every request's merged output (o, m, l) of a mesh run, on the host,
    keyed (label, step, request)."""
    for step in range(1, n_steps + 1):
        for rid, p in eng.outputs_of(step).items():
            outs[(label, step, rid)] = tuple(t.detach().cpu() for t in p)


def outputs_diff(torch, got, want):
    """The largest |got - want| over two runs' kept outputs, which must
    cover the same (run, step, request) keys."""
    if sorted(got) != sorted(want):
        fail(f"mesh outputs: the runs cover other keys: "
             f"{sorted(set(got) ^ set(want))[:6]}")
    return max(float(torch.max(torch.abs(a - b)))
               for k in got for a, b in zip(got[k], want[k]))


def slot_walls(entries, k):
    """Stage-log entries summed by slot (the requester's instance mod k):
    (stages, seconds measured: the serial host walls or the fused groups'
    apportioned device walls, seconds of serial CUDA-event time)."""
    rows = {s: [0, 0.0, 0.0] for s in range(k)}
    for e in entries:
        r = rows[e["instance"] % k]
        r[0] += 1
        r[1] += e["measured_s"]
        r[2] += e.get("device_s") or 0.0
    return {s: tuple(r) for s, r in rows.items()}


def run_mesh(torch, cfg, device="cuda", devices=None, tag="4c"):
    """Phase 4c (and 4d / 4e over other card slots): the serve world and
    the selection serve through the mesh backend (fused, --serial-exec,
    fused at --pipeline-depth 2), the goldens in both modes, and (4c) one
    fused step's streams. Returns the walls, the worst errors, the
    concurrency, the index stage, every output (keep_outputs), the stage
    logs by run and the slot-origin skews by run."""
    from repro_torch.launch import serve
    from repro_torch.serving.backends.shard_map import peer_flows
    dense, sel = ["--selection-frac", "0"], [
        "--selection", "--selection-frac", "0.5", "--selection-k", "512"]
    walls, stage, outs, logs_by_run, skews = {}, {}, {}, {}, {}
    index_acc = {"pairs": 0, "fused": [], "serial": [], "analytic": []}
    for label, extra in (("fused", dense), ("serial", dense + [
            "--serial-exec"]), ("fused depth 2", dense + [
                "--pipeline-depth", "2"]), ("selection fused", sel),
            ("selection serial", sel + ["--serial-exec"])):
        walls[label], eng = run_mesh_serve(torch, serve, extra, device,
                                           devices)
        keep_outputs(outs, f"serve {label}", eng, 5)
        logs_by_run[label] = [e for es in eng.backend.stage_log.values()
                              for e in es]
        skews[label] = list(eng.backend.slot_skew.values())
        stage[label] = stage_rows(eng.backend.stage_log.values())
        log_step_totals(f"{tag} serve {label}", eng.backend)
        log_stage_rows(f"{tag} serve {label}", stage[label],
                       eng.backend.fused)
        if eng.backend.fused:
            log(f"[mesh] {tag} serve {label}: phase_wall_total "
                + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                            eng.backend.phase_wall_total.items()))
            stage[label + " phase_wall_total_s"] = dict(
                eng.backend.phase_wall_total)
        peers = sum(peer_flows(r) for r in eng.measured_reports)
        flows = sum(len(r.measured.flows) for r in eng.measured_reports)
        log(f"[mesh] {tag} serve {label}: {walls[label]:.2f} s wall, every "
            f"step within {ORACLE_ATOL:g} of its oracle; {peers}/{flows} "
            f"measured flows crossed slots (peer)")
        if eng.selector is not None:
            if eng.selector.mesh.devices != eng.backend.mesh.devices:
                fail(f"mesh {tag}: the indexer's placement "
                     f"{eng.selector.mesh.devices} is not the backend's "
                     f"{eng.backend.mesh.devices}")
            check_mesh_indexer(eng, f"{tag} serve {label}", index_acc)
    worst, logs = run_mesh_goldens(torch, cfg, index_acc, device, devices,
                                   outs)
    for mode in ("fused", "serial"):
        stage[f"goldens {mode}"] = stage_rows(logs[mode])
        log_stage_rows(f"{tag} goldens {mode}", stage[f"goldens {mode}"],
                       mode == "fused")
    conc = (profile_mesh_step(torch, serve, devices)
            if device == "cuda" and tag == "4c" else {"streams": 0})
    index = {"pairs": index_acc["pairs"],
             "analytic_us": statistics.median(index_acc["analytic"]) * 1e6}
    for mode in ("serial", "fused"):
        w = index_acc[mode]
        index[mode] = {"n": len(w), "median_us": statistics.median(w) * 1e6,
                       "min_us": min(w) * 1e6, "max_us": max(w) * 1e6}
    return {"walls": walls, "worst": worst, "conc": conc, "index": index,
            "outs": outs, "logs": logs_by_run, "skews": skews}


def report_slots(tag, res, ref, k, smi_line):
    """4d / 4e against 4c: the slot-origin skew of every step, and each
    serve run's stage walls summed per slot beside 4c's same dispatch
    groups (4c's requesters bucketed by instance mod k)."""
    for label, sk in res["skews"].items():
        known = [x for x in sk if x is not None]
        log(f"[mesh] {tag} {label}: slot-origin skew over {len(sk)} steps: "
            + (f"median {statistics.median(known) * 1e6:.3f} us, max "
               f"{max(known) * 1e6:.3f} us" if known else
               "not measured (the slots lie on other cards)")
            + f"; {smi_line}")
    for label, entries in res["logs"].items():
        mine, base = slot_walls(entries, k), slot_walls(ref["logs"][label], k)
        serial = "serial" in label
        log(f"[mesh] {tag} {label}: stage walls summed per slot over the run "
            f"(us, {'host / CUDA event' if serial else 'fused group share'}"
            f"; {tag} vs 4c's same dispatch groups): " + "; ".join(
                f"slot {s} ({mine[s][0]} stages) {_us(mine[s][1])}"
                + (f" / {_us(mine[s][2])}" if serial else "")
                + f" vs {_us(base[s][1])}"
                + (f" / {_us(base[s][2])}" if serial else "")
                for s in range(k)) + f"; {smi_line}")


def peer_pulls(torch, cards, smi_line):
    """Phase 4e's peer copies between cards 0 and 1 of a mesh over the
    visible cards: a routed row of 1 KiB and a 2048-row V2-Lite chunk
    (4.7 MB), each timed by CUDA events on the source's stream (where
    the copy runs) over 200 and 50 pulls, twice: as issued (the host
    paces the stream) and with both cards' streams held behind a GPU spin
    that hides the issue (the device's time for a pull, its two-way
    barrier with the destination's stream included); beside the
    h100_nvlink4 price (its probe, 1.2 us, + bytes at its link peak, 125
    GB/s); and whether record_stream takes a stream of another card."""
    from repro_torch.core.constants import FABRICS
    from repro_torch.core.instance_mesh import InstanceMesh
    mesh = InstanceMesh(2, cards[:2])
    fab = FABRICS["h100_nvlink4"]
    out = {}
    for what, shape, iters in (("row", (256,), 200),
                               ("chunk", (CHUNK, 576), 50)):
        with mesh.on(0):
            x = torch.randn(shape, device=mesh.device_of(0))
        with mesh.on(1):
            y = torch.empty(shape, device=mesh.device_of(1))
        for _ in range(5):
            mesh.pull(x, 0, 1, out=y)
        mesh.synchronize()
        times = {}
        for how in ("issued", "device"):
            if how == "device":
                # ~0.5 ms of host issue a pull at most, at ~2e9 cycles/s
                mesh.begin(spin_cycles=int(2e9 * 5e-4 * iters))
            t0 = mesh.stamp(0)
            for _ in range(iters):
                mesh.pull(x, 0, 1, out=y)
            t1 = mesh.stamp(0)
            mesh.synchronize()
            times[how] = mesh.seconds(t0, t1) / iters * 1e6
        if not torch.equal(y.cpu(), x.cpu()):
            fail(f"phase 4e: the peer pull of a {what} changed its bytes")
        nbytes = x.numel() * x.element_size()
        model = (fab.t_probe_s + nbytes / fab.link_peak_Bps) * 1e6
        out[what] = {"bytes": nbytes, "model_us": model, **{
            f"{how}_us": us for how, us in times.items()}}
        log(f"[mesh] 4e peer pull {cards[0]} -> {cards[1]} of a {what} "
            f"({nbytes} B) over {iters}: " + ", ".join(
                f"{how} {us:.3f} us a pull ({nbytes / us / 1e3:.2f} GB/s, "
                f"x{us / model:.2f})" for how, us in times.items())
            + f"; h100_nvlink4 prices it {model:.3f} us; {smi_line}")
    t = torch.empty(16, device=cards[0])
    try:
        t.record_stream(torch.cuda.Stream(device=cards[1]))
        out["record_stream_across_cards"] = True
    except RuntimeError as exc:
        out["record_stream_across_cards"] = f"refused: {exc}"
    log(f"[mesh] 4e record_stream of a {cards[0]} tensor on a {cards[1]} "
        f"stream: {out['record_stream_across_cards']} (the mesh never "
        f"needs it: a pull reads on the source's card)")
    return out


# ---------------------------------------------------------------------------
# phase 5b: the model's serving form
# ---------------------------------------------------------------------------

MODEL_BATCH = 2       # sequences per prefill
MODEL_PROMPT = 2048   # tokens per sequence
MODEL_STEPS = 8       # decode steps after the prefill
# The V2-Lite f32 verify prefills 2 x 512 tokens. Its route check compares
# ~3000 top-6-of-64 router choices per MoE layer that the two runs make on
# hidden states differing by f32 reordering (~1e-6): at 2 x 2048 tokens one
# near-tie flipped (one token of 12288 token-layers, on an H100).
VERIFY_PROMPT = 512


def profiled(torch, fn, top: int = 6):
    """fn() once under torch.profiler (CUPTI): (result, device busy ms,
    {kernel: ms} of the `top` kernels by device time). On one stream the
    kernels do not overlap, so their sum is the busy time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    by = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            name = evt.key.replace("(anonymous namespace)::", "")
            by[name.split("(")[0][:60]] = us / 1e3
    ranked = dict(sorted(by.items(), key=lambda kv: -kv[1])[:top])
    return out, sum(by.values()), ranked


def run_model(torch, M, params, cfg, batch, step_cfgs, *, dtype, ops,
              feed=None, routes=None, profile_last=False, slots=None,
              keep_state_at=None):
    """prefill batch ({"tokens": (B, S)} and the family's stub inputs)
    through the entry points, then one decode_step per config of step_cfgs
    on a cache of the context (S, and the VLM's patches) plus
    len(step_cfgs) slots (or of `slots` slots) holding the prefill caches
    (fill_decode_state).
    Greedy tokens, or `feed`'s. Returns the prefill logits and caches, the
    decode logits, the tokens fed, the state after the last step (and a
    copy of it after keep_state_at steps, "kept_state") and the walls; with
    profile_last, the last step's device busy time and top kernels (that
    step runs under the profiler, its wall is not kept)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    S += cfg.vlm_patches if cfg.family == "vlm" else 0
    dev = tokens.device
    t0 = time.perf_counter()
    logits, caches = M.prefill(params, cfg, batch, ops=ops, routes=routes)
    torch.cuda.synchronize(dev)
    t_prefill = time.perf_counter() - t0
    state = M.fill_decode_state(cfg, M.init_decode_state(
        cfg, B, slots or S + len(step_cfgs), dtype=dtype, device=dev), caches)
    tok = logits.argmax(-1)
    fed, outs, walls, prof, kept = [], [], [], None, None
    for i, scfg in enumerate(step_cfgs):
        if i == keep_state_at:
            kept = clone_tree(state)
        tok = tok if feed is None else feed[i]
        fed.append(tok)

        def step():
            return M.decode_step(params, scfg, state, tok,
                                 torch.full((B, 1), S + i, device=dev),
                                 S + i, ops=ops, routes=routes)
        if profile_last and i == len(step_cfgs) - 1:
            (lg, state), busy, top = profiled(torch, step)
            prof = {"busy_ms": busy, "top_ms": top}
        else:
            t0 = time.perf_counter()
            lg, state = step()
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        outs.append(lg)
        tok = lg.argmax(-1)
    return {"prefill": logits, "caches": caches, "decode": outs, "fed": fed,
            "state": state, "kept_state": kept, "prefill_s": t_prefill,
            "decode_s": walls, "profile": prof}


def clone_tree(tree):
    """A copy of a state tree (dicts and tuples of tensors or DTensors)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone()


def leaves(tree):
    """The tensors of a cache or state tree (dicts by key, tuples in
    order; None holds none)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [] if tree is None else [tree]


def shapes(tree):
    """{key: [leaf shapes]} of a cache or state dict."""
    return {k: [tuple(x.shape) for x in leaves(v)] for k, v in tree.items()}


def _prompt(torch, dev, vocab, length):
    g = torch.Generator(device=dev).manual_seed(1)
    return torch.randint(0, vocab, (MODEL_BATCH, length), device=dev,
                         generator=g)


def _finite(torch, t, what):
    if not bool(torch.isfinite(t.float()).all()):
        fail(f"{what}: non-finite values")


def model_full_bf16(torch, dev, cfg):
    """(a) the full-depth model in bf16: prefill, greedy decode, finite
    logits and the reference's cache layout."""
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.models import model as M
    from repro_torch.models.module import count_params
    by_dtype = fp_ops.flash_prefill.launches_by_dtype
    at_start = dict(by_dtype)
    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n = count_params(params)
    torch.cuda.reset_peak_memory_stats(dev)
    tokens = _prompt(torch, dev, cfg.vocab, MODEL_PROMPT)
    out = run_model(torch, M, params, cfg, {"tokens": tokens},
                    [cfg] * (MODEL_STEPS + 1), dtype=torch.bfloat16,
                    ops=M.KERNELS, profile_last=True)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # the first prefill above pays each kernel's and GEMM's first call: a
    # second one gives the warm wall, a third the device busy time
    before = dict(by_dtype)
    t0 = time.perf_counter()
    M.prefill(params, cfg, {"tokens": tokens})
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    per_prefill = {k: by_dtype[k] - before[k] for k in by_dtype}
    if per_prefill != {"float32": 0, "bfloat16": cfg.n_layers}:
        fail(f"{cfg.name} bf16 prefill launched flash_prefill {per_prefill}, "
             f"want the bf16 kernel once per layer ({cfg.n_layers}) and the "
             "f32 one never")
    _, pf_busy, pf_top = profiled(
        torch, lambda: M.prefill(params, cfg, {"tokens": tokens}))
    # three prefills (cold, warm, profiled), each the bf16 kernel per layer
    in_phase = {k: by_dtype[k] - at_start[k] for k in by_dtype}
    if in_phase != {"float32": 0, "bfloat16": 3 * cfg.n_layers}:
        fail(f"{cfg.name} bf16 prefills launched flash_prefill {in_phase}")
    _finite(torch, out["prefill"], f"{cfg.name} prefill logits")
    for i, lg in enumerate(out["decode"]):
        _finite(torch, lg, f"{cfg.name} decode step {i} logits")
    want = {"dense_blocks": (cfg.first_k_dense, MODEL_BATCH, MODEL_PROMPT,
                             cfg.mla.d_qk),
            "blocks": (cfg.n_layers - cfg.first_k_dense, MODEL_BATCH,
                       MODEL_PROMPT, cfg.mla.d_qk)}
    got = {k: tuple(v.shape) for k, v in out["caches"].items()}
    if got != want:
        fail(f"{cfg.name} caches {got}, want {want}")
    shape = tuple(out["prefill"].shape)
    if shape != (MODEL_BATCH, 1, cfg.vocab):
        fail(f"{cfg.name} prefill logits {shape}")
    log(f"[model] (a) {cfg.name} full depth ({cfg.n_layers} layers, {n} "
        f"parameters) in bf16, weights from seed 0 on the card in "
        f"{init_s:.2f} s: prefill {MODEL_BATCH} x {MODEL_PROMPT} tokens "
        f"{out['prefill_s']:.3f} s (warm {warm_s:.3f} s), {MODEL_STEPS} "
        "decode steps "
        + ", ".join(f"{w * 1e3:.1f}" for w in out["decode_s"])
        + f" ms; logits finite, caches {got}; peak {peak:.1f} GiB; "
        f"flash_prefill per prefill {per_prefill}")
    dp = out["profile"]
    log(f"[model] (a) device busy (profiler): prefill {pf_busy:.1f} ms of "
        f"{warm_s * 1e3:.1f} ms warm wall, top kernels ms {pf_top}; a "
        f"decode step {dp['busy_ms']:.2f} ms of {min(out['decode_s']) * 1e3:.1f}"
        f"-{max(out['decode_s']) * 1e3:.1f} ms wall, top kernels ms "
        f"{dp['top_ms']}")
    del params, out
    torch.cuda.empty_cache()


def _compare(torch, what, got, want, tol):
    atol, rtol = tol
    e = max_err(torch, got.float(), want.float())
    ok = within(torch, got.float(), want.float(), atol, rtol)
    if not ok:
        fail(f"{what}: kernels off the plain ops by {e:.3e} (atol {atol:g},"
             f" rtol {rtol:g})")
    return e


def model_verify(torch, dev, cfg, tol, step_cfgs, label, prompt):
    """The model in f32 through the kernels and through their plain
    versions on the same weights and tokens (a prefill of MODEL_BATCH x
    prompt, then step_cfgs' decode steps): equal MoE routes, prefill and
    decode logits, every cache leaf (latent rows, SSM states and conv
    tails, K/V) and the decode state after the last step within tol."""
    from repro_torch.models import model as M
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=torch.float32)
    batch = {"tokens": _prompt(torch, dev, cfg.vocab, prompt)}
    rk, rp = [], []
    k = run_model(torch, M, params, cfg, batch, step_cfgs,
                  dtype=torch.float32, ops=M.KERNELS, routes=rk)
    p = run_model(torch, M, params, cfg, batch, step_cfgs,
                  dtype=torch.float32, ops=M.PLAIN, feed=k["fed"], routes=rp)
    if len(rk) != len(rp) or not all(torch.equal(a, b)
                                     for a, b in zip(rk, rp)):
        where = [(i, (a != b).any(-1).nonzero().flatten().tolist())
                 for i, (a, b) in enumerate(zip(rk, rp))
                 if a.shape != b.shape or bool((a != b).any())]
        fail(f"{label}: MoE routes differ, (call, tokens): {where}")
    errs = {"prefill": _compare(torch, f"{label} prefill logits",
                                k["prefill"], p["prefill"], tol)}
    for what in ("caches", "state"):
        got, want = leaves(k[what]), leaves(p[what])
        if [x.shape for x in got] != [x.shape for x in want]:
            fail(f"{label} {what}: layouts differ")
        errs[what] = max(_compare(torch, f"{label} {what} leaf {i}", a, b,
                                  tol)
                         for i, (a, b) in enumerate(zip(got, want)))
    errs["decode"] = max(_compare(torch, f"{label} decode step {i}", a, b,
                                  tol)
                         for i, (a, b) in enumerate(zip(k["decode"],
                                                        p["decode"])))
    del params
    torch.cuda.empty_cache()
    return errs, sum(int(r.numel()) for r in rk), k, p


def mla_layer_bf16(torch, dev, cfg):
    """(d) one V2-Lite MLA layer (mla_attention: no MoE, so no route can
    flip) in bf16 at MODEL_BATCH x MODEL_PROMPT tokens, weights and input
    from seed 0 on the card: through the flash_prefill wrapper (the bf16
    kernel) against the same layer through its plain version.

    The latent attention the inner op returns (the kernel's own output)
    and the cache entries are held elementwise at the bf16 tolerance. The
    layer output is the latent attention rounded to bf16 and carried
    through two bf16 products (512 and 2048 terms, to outputs of order
    10): a one-ulp difference of a rounded input moves every output element
    by an amount set by the output's scale, not its own, so it is held at
    the same 2e-2 as a relative error in norm, ||kernel - plain|| / ||plain||."""
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_ref)
    from repro_torch.models import mla as MLA
    mcfg = cfg.mla
    g = torch.Generator(device=dev).manual_seed(0)
    mod = MLA.MLA(mcfg, dtype=torch.bfloat16, device=dev, generator=g)
    x = torch.randn((MODEL_BATCH, MODEL_PROMPT, mcfg.d_model), device=dev,
                    generator=g).to(torch.bfloat16)
    pos = torch.arange(MODEL_PROMPT, dtype=torch.int32,
                       device=dev)[None].expand(MODEL_BATCH, -1)
    runs = {}
    for name, fn in (("kernel", flash_prefill), ("plain", flash_prefill_ref)):
        lat = []

        def keep(q, ckv, **kw):
            lat.append(fn(q, ckv, **kw))
            return lat[-1]
        out, entries = MLA.mla_attention(mod, mcfg, x, pos, prefill_fn=keep)
        runs[name] = {"latent attention": lat[0], "output": out,
                      "entries": entries}
    tol = TOL["flash_prefill_bf16"]
    label = f"(d) {cfg.name} MLA layer bf16"
    errs = {what: _compare(torch, f"{label} {what}", runs["kernel"][what],
                           runs["plain"][what], tol)
            for what in ("latent attention", "entries")}
    got = runs["kernel"]["output"].float()
    want = runs["plain"]["output"].float()
    errs["output"] = max_err(torch, got, want)
    rel = float((got - want).norm() / want.norm())
    if not rel <= tol[1]:
        fail(f"{label} output: kernels off the plain ops by {rel:.3e} in "
             f"norm (relative tolerance {tol[1]:g})")
    log(f"[model] {label}, {MODEL_BATCH} x {MODEL_PROMPT} tokens, bf16 "
        f"flash_prefill against its plain version: max|err| latent "
        f"attention {errs['latent attention']:.3e}, entries "
        f"{errs['entries']:.3e} (atol {tol[0]:g}, rtol {tol[1]:g}); layer "
        f"output ||err||/||plain|| {rel:.3e} (<= {tol[1]:g}), max|err| "
        f"{errs['output']:.3e} at max|plain| {float(want.abs().max()):.3e}, "
        f"rms {float(want.pow(2).mean().sqrt()):.3e}")
    del mod
    torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# phase 5c: the training path
# ---------------------------------------------------------------------------

TRAIN_SEQ = 2048      # tokens per training sequence
TRAIN_STEPS = 8       # steps of runs (b) and (c)
TRAIN_LR = 1e-3       # the launcher's default learning rate
# Replayed steps after the restore: the restored step replays bit for bit
# (its weights, moments and batch are restored exactly and the forward is
# deterministic); later ones may differ in the last bits where backward
# accumulates with atomic adds, and are held at 1e-3 relative.
REPLAY_RTOL = 1e-3
# (d): the prefill's last-token logits (bf16 flash_prefill) against the
# last position of the train form on the same trained bf16 weights,
# relative in norm, as 5b (d) holds a bf16 layer.
TRAIN_SERVE_RTOL = 2e-2
# (e): the f32 train form against f64 on the same weights and tokens: the
# loss (~11.5, a mean over 1024 tokens) to 1e-5 relative, the global grad
# norm (a sum over ~0.9e9 squared entries) to 1e-4.
F64_LOSS_RTOL, F64_GNORM_RTOL = 1e-5, 1e-4


def train_cli(torch, arch):
    """(a) repro_torch.launch.train --smoke on the card, 20 steps of 16 x
    128 tokens, a checkpoint every 10: finite losses, the last logged below
    the first, the checkpoints [10, 20].

    A logged loss is one batch's mean. At the launcher's default batch of
    4 x 128 tokens its batch-to-batch spread (~0.1) is as large as what 20
    steps learn: on the CPU, 2 of 5 seeds of the DeepSeek smoke config
    ended above their first loss (one on the card), where at 16 x 128 every
    seed fell, by 0.06-0.28, for both smoke configs."""
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", arch, "--smoke", "--steps", "20", "--batch", "16",
                "--ckpt-every", "10", "--ckpt-dir", d, "--device", "cuda"]
        log(f"[train] (a) repro_torch.launch.train {' '.join(argv)}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            entries = train.main(argv)
        wall = time.perf_counter() - t0
    out = buf.getvalue()
    sys.stdout.write(out)
    losses = [e["loss"] for e in entries if "loss" in e]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"(a) {arch}: losses {losses}, want finite and falling")
    if "checkpoints: [10, 20]" not in out:
        fail(f"(a) {arch}: want checkpoints [10, 20]: {out.strip()}")
    return wall


def train_run(torch, dev, cfg, *, batch, n_micro, ckpt_every=None,
              fault_at=None):
    """cfg trained from bf16 weights drawn on the card from seed 0, f32
    AdamW moments, for TRAIN_STEPS steps of batch x TRAIN_SEQ tokens of the
    synthetic pipeline through train_loop: each step's wall on the host
    clock ending in a synchronize, a checkpoint every ckpt_every steps (in
    a temporary directory), a failure induced before step fault_at. Then
    one more step under the profiler, for its device busy time."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import model as M
    from repro_torch.models.module import count_params, trainable
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         cosine_schedule)
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.step import TrainConfig, make_train_step
    params = trainable(M.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=torch.bfloat16))
    ocfg = AdamWConfig(lr=TRAIN_LR)
    opt = adamw_init(params, ocfg)
    step_fn = make_train_step(
        cfg, ocfg, TrainConfig(n_micro=n_micro),
        cosine_schedule(TRAIN_LR, warmup=TRAIN_STEPS // 10 + 1,
                        total=TRAIN_STEPS))
    walls = []

    def timed(p, o, b):
        t = time.perf_counter()
        out = step_fn(p, o, b)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t)
        return out

    fired = []

    def fault(step):
        if step == fault_at and not fired:
            fired.append(step)
            raise RuntimeError(f"induced failure before step {step}")

    pipe = SyntheticPipeline.for_model(cfg, TRAIN_SEQ, batch, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d, keep=1)
        t0 = time.perf_counter()
        _, _, entries = train_loop(
            timed, params, opt, pipe, ckpt,
            LoopConfig(total_steps=TRAIN_STEPS,
                       ckpt_every=ckpt_every or TRAIN_STEPS + 1,
                       log_every=1),
            fault_hook=fault if fault_at is not None else None)
        loop_s = time.perf_counter() - t0
        saved = ckpt.all_steps()
    peak = torch.cuda.max_memory_allocated(dev)
    extra = pipe.batch_at(TRAIN_STEPS)
    t0 = time.perf_counter()
    _, busy_ms, top = profiled(torch, lambda: step_fn(params, opt, extra))
    prof_s = time.perf_counter() - t0
    losses = [(e["step"], e["loss"]) for e in entries if "loss" in e]
    if not all(math.isfinite(x) for _, x in losses):
        fail(f"{cfg.name}: non-finite training losses {losses}")
    wall = statistics.median(walls[1:])           # the first step warms up
    tokens = batch * TRAIN_SEQ
    return {"params": params, "n": count_params(params), "losses": losses,
            "entries": entries, "walls": walls, "wall_s": wall,
            "tokens_s": tokens / wall, "busy_ms": busy_ms,
            "busy_share": busy_ms / 1e3 / wall, "prof_s": prof_s,
            "top_ms": top, "peak_gib": peak / 2**30, "loop_s": loop_s,
            "saved": saved, "tokens": tokens}


def log_train_run(tag, cfg, r, smi_line, what):
    log(f"[train] {tag} {cfg.name} ({cfg.n_layers} layers, {r['n']} "
        f"parameters, bf16, f32 AdamW moments), {what}: losses "
        + ", ".join(f"{s}:{x:.4f}" for s, x in r["losses"]))
    log(f"[train] {tag} step wall median {r['wall_s'] * 1e3:.1f} ms of "
        f"steps 1.. (" + ", ".join(f"{w * 1e3:.1f}" for w in r["walls"])
        + f" ms), {r['tokens_s']:.0f} tokens/s ({r['tokens']} tokens a "
        f"step); one step under the profiler: device busy "
        f"{r['busy_ms']:.1f} ms = {100 * r['busy_share']:.1f}% of the "
        f"median wall (its own wall {r['prof_s'] * 1e3:.1f} ms), top "
        f"kernels ms {r['top_ms']}; max_memory_allocated "
        f"{r['peak_gib']:.2f} GiB; loop {r['loop_s']:.1f} s, of which "
        f"steps {sum(r['walls']):.1f} s; {smi_line}")


def check_replay(cfg, r, fault_at, ckpt_every):
    """(b): one restore, to the checkpoint before fault_at; the restored
    step's loss bit for bit its first run's, later replays within
    REPLAY_RTOL. Returns the replayed steps' relative differences."""
    events = [e for e in r["entries"] if e.get("event") == "restored"]
    back = (fault_at // ckpt_every) * ckpt_every
    if len(events) != 1 or events[0]["step"] != back:
        fail(f"(b) {cfg.name}: restore events {events}, want one to {back}")
    steps = [s for s, _ in r["losses"]]
    want = list(range(fault_at)) + list(range(back, TRAIN_STEPS))
    if steps != want:
        fail(f"(b) {cfg.name}: logged steps {steps}, want {want}")
    first, again = {}, {}
    for s, x in r["losses"]:
        (again if s in first else first)[s] = x
    if again[back] != first[back]:
        fail(f"(b) {cfg.name}: restored step {back} loss {again[back]!r} "
             f"differs from its first run {first[back]!r}")
    rel = {s: abs(again[s] - first[s]) / abs(first[s]) for s in again}
    if not all(v <= REPLAY_RTOL for v in rel.values()):
        fail(f"(b) {cfg.name}: replayed losses off their first run by {rel}"
             f" (rtol {REPLAY_RTOL:g})")
    if r["saved"] != [TRAIN_STEPS]:
        fail(f"(b) {cfg.name}: checkpoints left {r['saved']}, want "
             f"[{TRAIN_STEPS}] (keep 1)")
    log(f"[train] (b) one restore, to step {back}, after the failure before "
        f"step {fault_at}; replayed losses against their first run, "
        f"relative: {rel} (step {back} bit for bit; rtol {REPLAY_RTOL:g}); "
        f"checkpoints left {r['saved']}")
    return rel


def trained_serve(torch, dev, cfg, params):
    """(d) the trained bf16 weights served: prefill (the serving form, the
    bf16 flash_prefill once per layer) of MODEL_BATCH x MODEL_PROMPT tokens
    against the train form's forward on the same tokens, last position,
    relative in norm.

    The two forms round in bf16 at other places, and a token whose router
    scores are near a tie takes another top-k in one form than in the
    other; its hidden state then differs by an expert's output and reaches
    the last token through attention (on an H100: 93, 322 and 658 of 4096
    tokens over the three MoE layers, the last tokens' own routes equal,
    2.38e-2 in norm). So the train form is held on the served routes
    (train_forward(pinned_routes=...)), where the two differ by the forms'
    bf16 roundings alone, as 5b (d) holds a bf16 layer; the train form on
    its own routes is printed beside it, with the tokens whose routes
    differ."""
    from repro_torch.models import model as M
    tokens = _prompt(torch, dev, cfg.vocab, MODEL_PROMPT)
    rp, rt, rpin = [], [], []
    with torch.no_grad():
        served, _ = M.prefill(params, cfg, {"tokens": tokens}, routes=rp)
        own, _ = M.train_forward(params, cfg, {"tokens": tokens}, routes=rt)
        pinned, _ = M.train_forward(params, cfg, {"tokens": tokens},
                                    routes=rpin, pinned_routes=rp)
    if not all(torch.equal(a, b) for a, b in zip(rpin, rp)):
        fail("(d) the pinned train form took other routes than the served")
    got = served[:, 0].float()
    _finite(torch, got, "(d) prefill logits")
    rel = {}
    for name, out in (("pinned", pinned), ("own", own)):
        want = out[:, -1].float()
        rel[name] = float((got - want).norm() / want.norm())
    want = pinned[:, -1].float()
    last = [MODEL_PROMPT * (b + 1) - 1 for b in range(MODEL_BATCH)]
    flips, last_flips = [], []
    for a, b in zip(rp, rt):
        differ = (a.sort(-1).values != b.sort(-1).values).any(-1)
        flips.append(int(differ.sum()))
        last_flips.append([bool(differ[i]) for i in last])
    log(f"[train] (d) {cfg.name} trained weights: prefill {MODEL_BATCH} x "
        f"{MODEL_PROMPT} tokens (bf16 flash_prefill) against the train "
        f"form on the served routes, last-token logits ||err||/||train|| "
        f"{rel['pinned']:.3e} (<= {TRAIN_SERVE_RTOL:g}), max|err| "
        f"{float((got - want).abs().max()):.3e} at max|train| "
        f"{float(want.abs().max()):.3e}; the train form on its own routes "
        f"{rel['own']:.3e}, tokens whose top-k differs by MoE layer {flips} "
        f"of {MODEL_BATCH * MODEL_PROMPT}, the last tokens' {last_flips}")
    if not rel["pinned"] <= TRAIN_SERVE_RTOL:
        fail(f"(d) {cfg.name}: served logits off the train form by "
             f"{rel['pinned']:.3e} in norm (rtol {TRAIN_SERVE_RTOL:g})")
    return rel


def train_f64(torch, dev, cfg):
    """(e) one step's loss and gradients through the train form in f32 and
    in f64 on the same weights (drawn in f32 from seed 0; the f64 copy is
    f64 end to end, norms, rope, router and softmax included) and the same
    2 x 512 tokens: equal routes, the loss within F64_LOSS_RTOL, the global
    grad norm within F64_GNORM_RTOL."""
    import copy
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import model as M
    from repro_torch.models.module import trainable
    batch = SyntheticPipeline.for_model(cfg, VERIFY_PROMPT, MODEL_BATCH,
                                        device=dev).batch_at(0)
    p32 = trainable(M.init_model(cfg, torch.Generator(device=dev)
                                 .manual_seed(0), device=dev,
                                 dtype=torch.float32))
    out = {}
    for name in ("f32", "f64"):
        params = p32 if name == "f32" else trainable(
            copy.deepcopy(p32).double())
        routes = []
        t0 = time.perf_counter()
        loss = M.loss_fn(params, cfg, batch, routes=routes)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        gnorm = math.sqrt(sum(float(torch.sum(torch.square(g.double())))
                              for g in grads))
        torch.cuda.synchronize(dev)
        out[name] = {"loss": float(loss.detach()), "gnorm": gnorm,
                     "routes": routes,
                     "s": time.perf_counter() - t0}
        del params, grads, loss
    a, b = out["f32"], out["f64"]
    if len(a["routes"]) != len(b["routes"]) or not all(
            torch.equal(x, y) for x, y in zip(a["routes"], b["routes"])):
        fail(f"(e) {cfg.name}: MoE routes differ between f32 and f64")
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    gnorm_rel = abs(a["gnorm"] - b["gnorm"]) / b["gnorm"]
    log(f"[train] (e) {cfg.name} {cfg.n_layers} layers, {MODEL_BATCH} x "
        f"{VERIFY_PROMPT} tokens, train form f32 against f64: loss "
        f"{a['loss']:.9f} / {b['loss']:.9f} (rel {loss_rel:.3e} <= "
        f"{F64_LOSS_RTOL:g}), grad norm {a['gnorm']:.9g} / {b['gnorm']:.9g}"
        f" (rel {gnorm_rel:.3e} <= {F64_GNORM_RTOL:g}), "
        f"{sum(int(r.numel()) for r in a['routes'])} routes equal; "
        f"{a['s']:.2f} s / {b['s']:.2f} s")
    if not loss_rel <= F64_LOSS_RTOL or not gnorm_rel <= F64_GNORM_RTOL:
        fail(f"(e) {cfg.name}: f32 off f64 by loss {loss_rel:.3e}, grad "
             f"norm {gnorm_rel:.3e}")
    del p32
    torch.cuda.empty_cache()
    return loss_rel, gnorm_rel


def run_training(torch, dev, v2_lite, mamba2, counted, smi_line):
    """Phase 5c. Every counter is zeroed before each part and read after:
    the train steps launch no kernel; (d) the bf16 flash_prefill once per
    layer and nothing else. Returns (results, launches by part)."""
    def none_launched(part, n):
        if any(n.values()):
            fail(f"(5c) {part} launched kernels: {n}")
        return n

    by_part, res = {}, {}
    for arch in ("deepseek-v2-lite", "mamba2-370m"):
        res[f"cli {arch}"], n = counted(lambda: train_cli(torch, arch))
        by_part[f"train_cli_{arch}"] = none_launched(f"(a) {arch}", n)
    cut = dataclasses.replace(v2_lite, n_layers=4)
    fault_at, every = 6, 4
    rb, n = counted(lambda: train_run(torch, dev, cut, batch=2, n_micro=2,
                                      ckpt_every=every, fault_at=fault_at))
    by_part["train_v2_lite"] = none_launched("(b)", n)
    log_train_run("(b)", cut, rb, smi_line,
                  f"depth cut from {v2_lite.n_layers} to {cut.n_layers} "
                  f"layers (1 dense + 3 MoE), 2 x {TRAIN_SEQ} tokens, "
                  f"n_micro 2, a checkpoint every {every} steps, a failure "
                  f"induced before step {fault_at}")
    res["replay_rel"] = check_replay(cut, rb, fault_at, every)
    res["serve_rel"], n = counted(lambda: trained_serve(
        torch, dev, cut, rb["params"]))
    if n["flash_prefill_bf16"] != cut.n_layers or any(
            v for k, v in n.items() if k != "flash_prefill_bf16"):
        fail(f"(d) launched {n}, want flash_prefill_bf16 once per layer "
             f"({cut.n_layers}) and nothing else")
    by_part["train_serve"] = n
    res["b"] = {k: v for k, v in rb.items() if k not in ("params",
                                                         "entries")}
    del rb
    torch.cuda.empty_cache()
    rc, n = counted(lambda: train_run(torch, dev, mamba2, batch=4,
                                      n_micro=1))
    by_part["train_mamba2"] = none_launched("(c)", n)
    log_train_run("(c)", mamba2, rc, smi_line,
                  f"as published, 4 x {TRAIN_SEQ} tokens")
    if not rc["losses"][-1][1] < rc["losses"][0][1]:
        fail(f"(c) {mamba2.name}: loss did not fall: {rc['losses']}")
    res["c"] = {k: v for k, v in rc.items() if k not in ("params",
                                                         "entries")}
    del rc
    torch.cuda.empty_cache()
    two = dataclasses.replace(v2_lite, n_layers=2)
    res["f64"], n = counted(lambda: train_f64(torch, dev, two))
    by_part["train_f64"] = none_launched("(e)", n)
    return res, by_part


# ---------------------------------------------------------------------------
# phase 5d: the model families (GQA attention, the hybrid, VLM, audio)
# ---------------------------------------------------------------------------

# (c) the GQA families in bf16 at full width: arch, the layers kept (None:
# all) and why the depth is cut. Each weight is drawn in f32 before its
# bf16 cast, so the largest tensor needs 6 bytes a parameter while it is
# drawn (Nemotron's embedding, 256 000 x 18 432: 28 GB).
FAMILY_RUNS = (
    ("qwen3-32b", 8, "time, and memory beside the phase's other tensors"),
    ("qwen2.5-32b", 8, "time, and memory beside the phase's other tensors"),
    ("qwen1.5-32b", 8, "time, and memory beside the phase's other tensors"),
    ("nemotron-4-340b", 2, "memory"),
    ("qwen3-moe-235b-a22b", 2, "memory"),
    ("llava-next-mistral-7b", None, None),
    ("whisper-large-v3", None, None),
)
VLM_TEXT = MODEL_PROMPT - 576  # LLaVA's text after its 576 patch embeddings
AUDIO_TOKENS = 448             # Whisper's decoder positions (its release's)
# (d) decode against forward, f32: one GQA layer stack's reorderings, 1e-4;
# the hybrid carries the SSD recurrence's (5b (c)'s SSM bound), 1e-3
DECODE_FORWARD_TOL = {"gqa": 1e-4, "hybrid": 1e-3}
DECODE_FORWARD_TOKENS = {"gqa": MODEL_PROMPT, "hybrid": 513}


def family_batch(torch, dev, cfg, text: int):
    """MODEL_BATCH sequences of `text` tokens from seed 1 on the card, and
    the family's stub input (0.02 x N(0, 1) in bf16, seed 2): LLaVA's patch
    embeddings, Whisper's 1500 frame embeddings."""
    batch = {"tokens": _prompt(torch, dev, cfg.vocab, text)}
    n = {"vlm": cfg.vlm_patches, "audio": cfg.enc_seq}.get(cfg.family)
    if n:
        g = torch.Generator(device=dev).manual_seed(2)
        key = "patch_embeds" if cfg.family == "vlm" else "frame_embeds"
        batch[key] = (0.02 * torch.randn((MODEL_BATCH, n, cfg.d_model),
                                         device=dev, generator=g)).to(
            torch.bfloat16)
    return batch


def prefill_cache_shapes(cfg, B: int, ctx: int, text: int):
    """The reference's prefill cache layout of cfg for B sequences of ctx
    context positions (text decoder tokens for the audio model)."""
    a = cfg.attn_cfg
    kv = lambda *lead, s=ctx: [lead + (B, s, a.n_kv_heads, a.hd)] * 2
    if cfg.family == "hybrid":
        s = cfg.ssm
        ng, rem = divmod(cfg.n_layers, cfg.hybrid_group)
        ssm = lambda *lead: [lead + (B, s.n_heads, s.head_dim, s.d_state),
                             lead + (B, s.d_conv - 1,
                                     s.d_inner + 2 * s.d_state)]
        out = {"groups": ssm(ng, cfg.hybrid_group) + kv(ng)}
        out["rem"] = ssm(rem) if rem else []
        return out
    if cfg.family == "audio":
        return {"blocks": kv(cfg.n_layers, s=text)
                + kv(cfg.n_layers, s=cfg.enc_seq)}
    return {"blocks": kv(cfg.n_layers)}


def family_full_bf16(torch, dev, cfg, text: int, label: str):
    """One family's model in bf16, weights drawn on the card from seed 0:
    prefill MODEL_BATCH x `text` tokens (and the stub inputs), fill the
    decode state, MODEL_STEPS greedy decode steps (one more under the
    profiler); a warm prefill's wall, one more prefill under the profiler.
    Finite logits, the reference's cache layout; ssd_chunk launched once
    per Mamba2 layer in each prefill. Returns the figures."""
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.models import model as M
    from repro_torch.models.module import count_params
    ssd = ssd_ops.ssd_intra_chunk
    n_mamba = cfg.n_layers if cfg.family == "hybrid" else 0
    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n = count_params(params)
    torch.cuda.reset_peak_memory_stats(dev)
    batch = family_batch(torch, dev, cfg, text)
    ctx = text + (cfg.vlm_patches if cfg.family == "vlm" else 0)
    at = ssd.launches
    out = run_model(torch, M, params, cfg, batch, [cfg] * (MODEL_STEPS + 1),
                    dtype=torch.bfloat16, ops=M.KERNELS, profile_last=True)
    before = ssd.launches
    t0 = time.perf_counter()
    M.prefill(params, cfg, batch)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    if ssd.launches - before != n_mamba:
        fail(f"{label} {cfg.name}: a prefill launched ssd_chunk "
             f"{ssd.launches - before} times, want {n_mamba} (one per "
             "Mamba2 layer)")
    _, pf_busy, pf_top = profiled(torch, lambda: M.prefill(params, cfg,
                                                           batch))
    if ssd.launches - at != 3 * n_mamba:
        fail(f"{label} {cfg.name}: three prefills launched ssd_chunk "
             f"{ssd.launches - at} times, want {3 * n_mamba}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    _finite(torch, out["prefill"], f"{label} {cfg.name} prefill logits")
    for i, lg in enumerate(out["decode"]):
        _finite(torch, lg, f"{label} {cfg.name} decode step {i} logits")
    if tuple(out["prefill"].shape) != (MODEL_BATCH, 1, cfg.vocab):
        fail(f"{label} {cfg.name} prefill logits {tuple(out['prefill'].shape)}")
    got = shapes(out["caches"])
    want = prefill_cache_shapes(cfg, MODEL_BATCH, ctx, text)
    if got != want:
        fail(f"{label} {cfg.name} caches {got}, want {want}")
    dp = out["profile"]
    res = {"params": n, "init_s": init_s, "prefill_s": out["prefill_s"],
           "warm_s": warm_s, "prefill_busy_ms": pf_busy,
           "prefill_top_ms": pf_top, "decode_s": out["decode_s"],
           "decode_busy_ms": dp["busy_ms"], "decode_top_ms": dp["top_ms"],
           "peak_gib": peak, "caches": got,
           "state": shapes(out["state"]),
           "ssd_per_prefill": n_mamba}
    log(f"[families] {label} {cfg.name}: {cfg.n_layers} layers"
        + (f" (+ {cfg.n_enc_layers} encoder)" if cfg.n_enc_layers else "")
        + f", {n} parameters in bf16 from seed 0 on the card in "
        f"{init_s:.2f} s; prefill {MODEL_BATCH} x {text} tokens"
        + (f" after {cfg.vlm_patches} patch embeddings"
           if cfg.family == "vlm" else "")
        + (f" over {cfg.enc_seq} frames" if cfg.family == "audio" else "")
        + f" {out['prefill_s']:.3f} s (warm {warm_s:.3f} s, device busy "
        f"{pf_busy:.1f} ms = {100 * pf_busy / 1e3 / warm_s:.1f}%), "
        f"{MODEL_STEPS} decode steps "
        + ", ".join(f"{w * 1e3:.1f}" for w in out["decode_s"])
        + f" ms (one step busy {dp['busy_ms']:.2f} ms = "
        f"{100 * dp['busy_ms'] / 1e3 / statistics.median(out['decode_s']):.1f}"
        f"% of the median); peak {peak:.2f} GiB; logits finite; "
        f"ssd_chunk {n_mamba} a prefill")
    log(f"[families] {label} {cfg.name} caches {got}; decode state "
        f"{res['state']}; top kernels ms: prefill {pf_top}, decode "
        f"{dp['top_ms']}")
    del params, out
    torch.cuda.empty_cache()
    return res


def decode_vs_forward(torch, dev, cfg, label: str):
    """f32, weights from seed 0: prefill the first S - 1 of S tokens into a
    cache of exactly S slots and decode token S - 1 (every slot written, so
    C.1's unwritten slots do not enter); its logits against the last
    position of forward over all S tokens. The hybrid's prefill length must
    be a multiple of its chunk (128): S - 1 = 512, and its forward scans
    S = 513 tokens in the largest chunk <= 128 that divides 513 (57): the
    chunk is the scan's block length, not a weight."""
    from repro_torch.models import model as M
    kind = "hybrid" if cfg.family == "hybrid" else "gqa"
    S, tol = DECODE_FORWARD_TOKENS[kind], DECODE_FORWARD_TOL[kind]
    whole = cfg
    if kind == "hybrid":
        chunk = max(q for q in range(1, 129) if S % q == 0)
        whole = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk=chunk))
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=torch.float32)
    tokens = _prompt(torch, dev, cfg.vocab, S)
    want = M.forward(params, whole, {"tokens": tokens})[0][:, S - 1]
    _, caches = M.prefill(params, cfg, {"tokens": tokens[:, :S - 1]})
    state = M.fill_decode_state(cfg, M.init_decode_state(
        cfg, MODEL_BATCH, S, dtype=torch.float32, device=dev), caches)
    got = M.decode_step(params, cfg, state, tokens[:, S - 1:],
                        torch.full((MODEL_BATCH, 1), S - 1, device=dev),
                        S - 1)[0][:, 0]
    err = _compare(torch, f"{label} {cfg.name} decode vs forward", got, want,
                   (tol, tol))
    log(f"[families] {label} {cfg.name} ({cfg.n_layers} layers, f32): "
        f"prefill {S - 1} tokens into {S} slots, decode token {S - 1}: "
        f"max|err| against forward over {S} tokens"
        + (f" (chunk {whole.ssm.chunk})" if kind == "hybrid" else "")
        + f" {err:.3e} (atol {tol:g}, rtol {tol:g})")
    del params
    torch.cuda.empty_cache()
    return err


def run_families(torch, dev, zamba2, counted):
    """Phase 5d. Every counter is zeroed before each part and read after:
    ssd_chunk once per Mamba2 layer in each prefill of (a) and (b), nothing
    else in either; no kernel at all in (c) (the GQA families run einsums,
    as the reference does). Returns (results, launches by part)."""
    from repro_torch import configs as TC
    from repro_torch.models import model as M
    from repro_torch.models.module import count_params

    def only_ssd(part, n, want):
        if n["ssd_chunk"] != want or any(v for k, v in n.items()
                                         if k != "ssd_chunk"):
            fail(f"(5d) {part} launched {n}, want ssd_chunk {want} times "
                 "and nothing else")
        return n

    res, by_part = {}, {}
    res["a"], n = counted(lambda: family_full_bf16(
        torch, dev, zamba2, MODEL_PROMPT, "(a)"))
    by_part["families_zamba2"] = only_ssd("(a)", n, 3 * zamba2.n_layers)
    cut = dataclasses.replace(zamba2, n_layers=zamba2.hybrid_group + 1)
    log(f"[families] (b) {cut.name} at full width in f32, depth cut from "
        f"{zamba2.n_layers} to {cut.n_layers} layers (one group of "
        f"{cut.hybrid_group} and 1 more, the shared block once; time), "
        f"prefill {MODEL_BATCH} x {VERIFY_PROMPT} tokens and {MODEL_STEPS} "
        "decode steps: kernels against plain versions")
    (errs, _, _, _), n = counted(lambda: model_verify(
        torch, dev, cut, MODEL_TOL["zamba2"], [cut] * MODEL_STEPS,
        "Zamba2 f32 cut", VERIFY_PROMPT))
    by_part["families_verify"] = only_ssd("(b)", n, cut.n_layers)
    res["b"] = errs
    log(f"[families] (b) max|err| kernels vs plain: prefill logits "
        f"{errs['prefill']:.3e}, caches (SSM states, conv tails, shared "
        f"K/V) {errs['caches']:.3e}, decode logits {errs['decode']:.3e}, "
        f"decode state {errs['state']:.3e} (atol "
        f"{MODEL_TOL['zamba2'][0]:g}, rtol {MODEL_TOL['zamba2'][1]:g}); "
        f"ssd_chunk {n['ssd_chunk']} launches (one prefill)")
    res["c"] = {}
    gqa = {k: 0 for k in n}
    for arch, keep, why in FAMILY_RUNS:
        full = TC.get_config(arch)
        cfg = full if keep is None else dataclasses.replace(full,
                                                            n_layers=keep)
        if keep is not None:
            gib = 2 * count_params(M.init_model(full, device="meta")) / 2**30
            log(f"[families] (c) {full.name}: depth cut from "
                f"{full.n_layers} to {keep} layers ({why}; all "
                f"{full.n_layers}: {gib:.0f} GiB in bf16)")
        text = {"vlm": VLM_TEXT, "audio": AUDIO_TOKENS}.get(cfg.family,
                                                           MODEL_PROMPT)
        res["c"][arch], n = counted(lambda: family_full_bf16(
            torch, dev, cfg, text, "(c)"))
        res["c"][arch]["cut"] = keep
        if any(n.values()):
            fail(f"(5d) (c) {arch} launched kernels: {n}")
        gqa = {k: gqa[k] + v for k, v in n.items()}
    by_part["families_gqa"] = gqa
    qwen = dataclasses.replace(TC.get_config("qwen3-32b"), n_layers=2)
    res["d"], n = counted(lambda: {
        "qwen3-32b": decode_vs_forward(torch, dev, qwen, "(d)"),
        "zamba2-7b": decode_vs_forward(torch, dev, cut, "(d)")})
    by_part["families_decode_forward"] = only_ssd("(d)", n,
                                                  2 * cut.n_layers)
    return res, by_part


# ---------------------------------------------------------------------------
# 5e. distribution: the sharded train step on the card, the dry run
# ---------------------------------------------------------------------------

DIST_BATCH, DIST_SEQ, DIST_STEPS = 4, 128, 3   # (a): 4 x 128 tokens, 3 steps
# (a) the world-1 mesh's steps against the same steps unsharded: the same
# arithmetic up to DTensor's redistributions (no-ops on one card) and the
# vocab-parallel cross-entropy's sum order; AdamW turns a gradient's last
# bits into parameter steps of up to lr where a gradient is near zero
DIST_LOSS_RTOL, DIST_PARAM_RTOL = 1e-5, 1e-4
CM_TOL = 2e-5                                  # the collective matmul
# seconds, each subprocess: (a), (b), the sharded serve's (c1), (c2),
# (c4), (c5), the sharded train step's (d) and (e) and the training
# substrate's (f); (c3) runs in
# (c2)'s process, which gets both parts' seconds
DIST_TIMEOUT = {"a": 300, "b": 900, "c1": 600, "c2": 600, "c3": 600,
                "c4": 600, "c5": 600, "d": 600, "e": 600, "f": 600}
DRYRUN_ARCH = "deepseek-v2-236b"
# (b)'s further cells, each `python -m repro_torch.launch.dryrun` in a
# subprocess of its own, at full depth, run beside the 236B one: GQA heads
# that do not divide the 16-wide model axis (qwen3-32b's 8 KV heads) in a
# train step, and the Mamba2 recurrence over a state whose 112 heads do
# not divide the 32-wide (pod x data) axis
DRYRUN_CELLS = (("qwen3-32b", "train_4k", False),
                ("zamba2-7b", "long_500k", True))
DRYRUN_CELL_TIMEOUT = 600                      # seconds, each cell


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_part_a(torch, device="cuda"):
    """Phase 5e (a), in a process of its own (one default process group): a
    world-1 NCCL group on a (1, 1) ("data", "model") mesh on the card. The
    V2-Lite smoke config in f32 (weights drawn on the card from seed 0),
    n_micro 2: DIST_STEPS train steps with param_shardings, sp_policy and
    ep_axis "model" against the same steps unsharded (losses, every
    parameter, the MoE routes of the first batch's microbatches); the
    compressed all-reduce (int32 payload, error feedback exact: mean + new
    error = gradient); the collective matmul, overlapped = barrier = dense;
    the sharded parameters saved as DTensors and restored into plain
    tensors, bit for bit. Prints one "DIST-A {json}" line. device "cpu"
    (python3 chip_smoke.py --dist-part a cpu) rehearses it on a gloo group
    on the host."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import collective_matmul as CM
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.module import trainable
    from repro_torch.optim import compress
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import TrainConfig, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device == "cuda"
    dev = torch.device("cuda", 0) if card else torch.device("cpu")
    if card:
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if card else (lambda d=None: None)
    dist.init_process_group("nccl" if card else "gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = get_smoke_config("deepseek-v2-lite")
    zero, read = _launch_counters()
    zero()
    g = torch.Generator(device=dev).manual_seed(1)
    batches = [{k: torch.randint(0, cfg.vocab, (DIST_BATCH, DIST_SEQ),
                                 generator=g, device=dev, dtype=torch.int32)
                for k in ("tokens", "targets")} for _ in range(DIST_STEPS)]
    half = DIST_BATCH // 2
    micro = [{k: v[i * half:(i + 1) * half] for k, v in batches[0].items()}
             for i in range(2)]
    ocfg = AdamWConfig()

    def fresh():
        return trainable(M.init_model(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
            dtype=torch.float32))

    def steps(params, opt, step_fn, wrap):
        losses, walls = [], []
        for b in batches:
            sync(dev)
            t = time.perf_counter()
            params, opt, mets = step_fn(params, opt, wrap(b))
            loss = mets["loss"]
            loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                         else loss)
            walls.append(time.perf_counter() - t)
            losses.append(loss)
        return params, losses, walls

    plain = fresh()
    routes0 = []
    for mb in micro:
        M.loss_fn(plain, cfg, mb, routes=routes0)
    plain, losses0, walls0 = steps(
        plain, adamw_init(plain, ocfg),
        make_train_step(cfg, ocfg, TrainConfig(n_micro=2)), lambda b: b)

    params = fresh()
    shard = SH.param_shardings(params, mesh)
    SH.shard_params(params, shard)
    bs = SH.batch_sharding(mesh)
    wrap = lambda b: {k: SH.distribute(v, mesh, bs.spec)
                      for k, v in b.items()}
    with POL.use_policy(POL.sp_policy(mesh)), implicit_replication():
        routes1 = []
        for mb in micro:
            M.loss_fn(params, cfg, wrap(mb), routes=routes1)
        routes1 = [r.full_tensor() for r in routes1]
        params, losses1, walls1 = steps(
            params, adamw_init(params, ocfg),
            make_train_step(cfg, ocfg, TrainConfig(n_micro=2,
                                                   ep_axis="model"),
                            param_shardings=shard), wrap)
    whole = [p.detach().full_tensor() for p in params.parameters()]
    param_rel = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(whole, plain.parameters()))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses1, losses0))
    routes_equal = len(routes1) == len(routes0) > 0 and all(
        torch.equal(a, b) for a, b in zip(routes1, routes0))
    launches = {k: sum(by_card.values()) for k, by_card in read().items()}

    # the checkpoint: saved from the DTensors, restored into plain tensors
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d)
        cm.save(1, params, blocking=True)
        back = cm.restore(1, fresh())
    ckpt_equal = all(torch.equal(a, b) for a, b in
                     zip(whole, back.parameters()))

    # the compressed all-reduce: int32 payload, error feedback exact
    grp = mesh.get_group("data")
    gr = torch.randn(4096, generator=g, device=dev)
    seen = []
    real = dist.all_reduce

    def spy(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        seen.append((t.dtype, op))
        return real(t, op=op, group=group, async_op=async_op)

    dist.all_reduce = spy
    (mean,), (err,) = compress.compressed_psum_with_feedback(
        [gr], [torch.zeros_like(gr)], grp)
    dist.all_reduce = real
    feedback_err = float((mean + err - gr).abs().max() / gr.abs().max())
    payload = [str(d) for d, op in seen if op == dist.ReduceOp.SUM]

    # the collective matmul at a TP layer's width
    x = torch.randn(256, 2048, generator=g, device=dev)
    w = torch.randn(2048, 1408, generator=g, device=dev)
    dense = x @ w
    cm_err = {fn.__name__: float((fn(x, w, grp) - dense).abs().max()
                                 / dense.abs().max())
              for fn in (CM.allgather_matmul_overlapped,
                         CM.allgather_matmul_barrier)}
    dist.destroy_process_group()
    print("DIST-A " + json.dumps({
        "losses": losses1, "unsharded_losses": losses0,
        "loss_rel": loss_rel, "param_rel": param_rel,
        "routes": len(routes1), "routes_equal": routes_equal,
        "walls_s": walls1, "unsharded_walls_s": walls0,
        "launches": launches, "ckpt_equal": ckpt_equal,
        "feedback_rel": feedback_err, "payload": payload,
        "cm_rel": cm_err}), flush=True)


def run_subprocess_part(part, argv, timeout=None):
    """Run argv (a part of phase 5e) in a subprocess, in a session of its
    own, with its timeout (None: DIST_TIMEOUT[part]); echo its output; fail
    on a non-zero exit or a timeout, after which the session's processes
    (a part's ranks) are killed."""
    timeout = timeout or DIST_TIMEOUT[part]
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"(5e) ({part}) did not end within {timeout} s")
    wall = time.perf_counter() - t0
    sys.stdout.write(out)
    if proc.returncode != 0:
        fail(f"(5e) ({part}) exited {proc.returncode}: "
             f"{err.strip()[-3000:]}")
    return out, wall


def run_distribution(torch, smi_line):
    """Phase 5e. (a) the sharded train step on the card (dist_part_a, in a
    subprocess); (b) the full config's dry run through the launcher, python
    -m repro_torch.launch.train --arch deepseek-v2-236b (no --smoke): the
    production mesh (16, 16) over a fake group, on meta tensors, on the
    host. Returns (walls, launches of (a)'s train steps)."""
    out, a_wall = run_subprocess_part(
        "a", [sys.executable, os.path.abspath(__file__), "--dist-part", "a"])
    found = [line for line in out.splitlines() if line.startswith("DIST-A ")]
    if not found:
        fail("(5e) (a) printed no result")
    r = json.loads(found[-1][len("DIST-A "):])
    log(f"[dist] (a) world-1 NCCL group, (1, 1) (data, model) mesh: the "
        f"V2-Lite smoke config in f32, n_micro 2, param_shardings + "
        f"sp_policy + ep_axis model, {DIST_STEPS} steps of {DIST_BATCH} x "
        f"{DIST_SEQ} tokens against the same steps unsharded: losses "
        + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(
            r["losses"], r["unsharded_losses"]))
        + f" (max rel {r['loss_rel']:.3e}, rtol {DIST_LOSS_RTOL:g}); "
        f"parameters max|diff|/max {r['param_rel']:.3e} (within "
        f"{DIST_PARAM_RTOL:g}); {r['routes']} MoE routes equal "
        f"{r['routes_equal']}; step walls sharded "
        + ", ".join(f"{w * 1e3:.1f}" for w in r["walls_s"])
        + " ms, unsharded "
        + ", ".join(f"{w * 1e3:.1f}" for w in r["unsharded_walls_s"])
        + f" ms; kernel launches in the steps {r['launches']}; {smi_line}")
    log(f"[dist] (a) checkpoint saved from DTensors, restored into plain "
        f"tensors bit for bit: {r['ckpt_equal']}; compressed all-reduce: "
        f"payload {r['payload']}, |mean + error - grad|/max "
        f"{r['feedback_rel']:.3e}; collective matmul (256 x 2048 @ 2048 x "
        f"1408 f32) vs dense, max|err|/max: {r['cm_rel']} (tol {CM_TOL:g})"
        f"; (a) wall {a_wall:.1f} s; {smi_line}")
    if r["loss_rel"] > DIST_LOSS_RTOL or r["param_rel"] > DIST_PARAM_RTOL \
            or not r["routes_equal"]:
        fail("(5e) (a) the sharded steps differ from the unsharded ones")
    if not r["ckpt_equal"]:
        fail("(5e) (a) the restored checkpoint differs")
    if r["payload"] != ["torch.int32"] or r["feedback_rel"] > 1e-6:
        fail(f"(5e) (a) compressed all-reduce: payload {r['payload']}, "
             f"feedback {r['feedback_rel']}")
    if max(r["cm_rel"].values()) > CM_TOL:
        fail(f"(5e) (a) collective matmul errs {r['cm_rel']}")
    if any(r["launches"].values()):
        fail(f"(5e) (a) the train steps launched kernels: {r['launches']}")

    rec_dir = os.path.join(ROOT, "build", "dryrun_torch")
    rec_path = os.path.join(rec_dir, "deepseek_v2_236b__train_4k__pod1.json")
    cells = []                      # (name, argv, Popen, start) of the cells
    for arch, shape, multi_pod in DRYRUN_CELLS:
        name = (f"{arch.replace('-', '_')}__{shape}__"
                f"{'pod2' if multi_pod else 'pod1'}")
        if os.path.exists(os.path.join(rec_dir, f"{name}.json")):
            os.remove(os.path.join(rec_dir, f"{name}.json"))
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape, "--force"] + \
            (["--multi-pod"] if multi_pod else [])
        log(f"[dist] (b) {' '.join(argv[1:])}: at full depth over a fake "
            f"group, on meta tensors, beside the {DRYRUN_ARCH} run")
        cells.append((name, argv, subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC + os.pathsep +
                               os.environ.get("PYTHONPATH", ""))),
            time.perf_counter()))
    if os.path.exists(rec_path):
        os.remove(rec_path)
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            DRYRUN_ARCH]
    log(f"[dist] (b) {' '.join(argv[1:])} (no --smoke): the full config's "
        "train_4k on the (16, 16) mesh over a fake group, on meta tensors")
    try:
        _, b_wall = run_subprocess_part("b", argv)
        with open(rec_path) as fh:
            rec = json.load(fh)
        if not rec.get("ok"):
            fail(f"(5e) (b) the dry run's record is not ok: "
                 f"{rec.get('error')}")
        log_dry_record(rec, b_wall, smi_line)
        extra = {name: wait_dry_cell(name, argv, proc, t0, rec_dir,
                                     smi_line)
                 for name, argv, proc, t0 in cells}
    finally:                        # no cell outlives a failure
        for *_, proc, _ in cells:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"a_s": a_wall, "b_s": b_wall, "record": rec,
            "cells": extra}, r["launches"]


def wait_dry_cell(name, argv, proc, t0, rec_dir, smi_line):
    """Wait for one of (b)'s further dry-run cells (within
    DRYRUN_CELL_TIMEOUT of its start), print its record, fail unless it
    is ok."""
    try:
        out, err = proc.communicate(timeout=max(
            1.0, DRYRUN_CELL_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        fail(f"(5e) (b) {name} did not end within {DRYRUN_CELL_TIMEOUT} s")
    wall = time.perf_counter() - t0
    sys.stdout.write(out)
    path = os.path.join(rec_dir, f"{name}.json")
    cell = {}
    if os.path.exists(path):
        with open(path) as fh:
            cell = json.load(fh)
    if proc.returncode != 0 or not cell.get("ok"):
        fail(f"(5e) (b) {' '.join(argv[1:])} is not ok (exit "
             f"{proc.returncode}): {cell.get('error')} "
             f"{err.strip()[-2000:]}")
    log_dry_record(cell, wall, smi_line)
    return {"wall_s": wall, "ok": cell["ok"], "fits": cell["memory"]["fits"],
            "dominant": cell["roofline"]["dominant"]}


def log_dry_record(rec, wall, smi_line):
    """One dry-run record of phase 5e (b) on a line of its own."""
    mem, col, roof = rec["memory"], rec["collectives"], rec["roofline"]
    gib = lambda b: b / 2**30
    log(f"[dist] (b) {rec['arch']} {rec['shape']} on {rec['mesh']} "
        f"({rec['n_devices']} devices, {rec['n_params']} parameters, "
        f"{rec['n_layers']} layers, depth cut {rec['depth_cut']}, n_micro "
        f"{rec.get('n_micro', 1)}, ops {rec['ops'].split(' ')[0]}): per "
        f"device argument bytes {mem['argument_bytes']} "
        f"({gib(mem['argument_bytes']):.2f} GiB), peak temporary "
        f"{mem['peak_temp_bytes']} ({gib(mem['peak_temp_bytes']):.2f} GiB), "
        f"together "
        f"{gib(mem['device_bytes']):.2f} GiB against "
        f"{gib(mem['hbm_bytes']):.0f} GiB (fits {mem['fits']}); FLOPs "
        f"{rec['flops']:.6e}; traffic bytes {rec['traffic_bytes']:.6e}; "
        f"collectives {col['counts']}, result bytes "
        f"{col['result_bytes']:.6e}, wire bytes {col['wire_bytes']:.6e}; "
        f"roofline on one H100: compute {roof['compute_s']:.4f} s, memory "
        f"{roof['memory_s']:.4f} s, collective {roof['collective_s']:.4f} s "
        f"({roof['rates']['collective_fabric']} at "
        f"{roof['rates']['collective_Bps']:.3g} B/s), dominant "
        f"{roof['dominant']}; dry-run wall {wall:.1f} s on the host "
        f"(build {rec['t_build_s']} s, analyse {rec['t_analyse_s']} s); "
        f"ok {rec['ok']}; {smi_line}")


# ---------------------------------------------------------------------------
# 5e (c1), (c2). the sharded serving form over NCCL, one process per card
# ---------------------------------------------------------------------------

SERVE_SLOTS = 4096      # the decode cache: the prompt's 2048 slots, then
                        # the decode steps write 2048-2059
# (c1)'s selection decode steps after its MODEL_STEPS dense ones, on the
# same caches: the top SEL_K of the 4096 slots' mean-head scores (2060
# written; the unwritten ones score 0 exactly, so they tie)
SEL_STEPS, SEL_K = 4, 512
# a selection flip (the chosen sets of the sharded and the unsharded run
# differ in a layer) passes only where the unsharded run's k-th and (k +
# 1)-th scores are within SEL_NEAR_TIE relative, at most MAX_FLIPS times a
# run; it also holds the run in f64 with PLAIN ops
SEL_NEAR_TIE = 1e-5
# (c3): long_500k's decode (configs.SHAPES, launch/dryrun.py): one row,
# LONG_SLOTS slots, selection_k LONG_K; LONG_STEPS steps at the last slots;
# the latent cache drawn N(0, 1) on the card, LONG_BLOCK slots a seeded
# draw (seed, layer, block), so that each card draws only its own rows
LONG_SLOTS, LONG_K, LONG_STEPS, LONG_BLOCK = 524288, 2048, 4, 4096
# (c5), ROADMAP C.7's check: (c3)'s decode in f32 with V2-Lite at full
# width cut to C5_LAYERS of its 27 layers (~27 GB of f32 weights and a
# 14.5 GB cache for the unsharded run on one card; 27 layers would need
# ~94 GB), the sharded run pinned to the unsharded run's routes and not
C5_LAYERS = 12
# the kernels of the sharded serve, by part: each launched on every card
SERVE_PATH = {"c1": ("flash_prefill", "mla_decode", "softmax_merge",
                     "sparse_select"),
              "c2": ("flash_prefill_bf16", "mla_decode", "softmax_merge",
                     "sparse_select"),
              "c5": ("sparse_select", "softmax_merge")}
# (c1), the sharded steps against the same steps unsharded: the same ops on
# the same f32 values, a head's attention and a shard's rows summed in
# another order, the decode's softmax merged across the shards: the model
# phase's limit (tests/test_torch_model.py's)
SERVE_TOL = (1e-4, 1e-4)
# (c1)'s routes: a flip is let pass only at a near-tie, the token's router
# margin (its k-th less its (k + 1)-th router probability, the unsharded
# run's) below NEAR_TIE, and at most MAX_FLIPS of them in a comparison;
# the error limits hold whatever flips, and a flip also holds the
# comparison in f64 with PLAIN ops
NEAR_TIE, MAX_FLIPS = 1e-3, 4


def serve_meshes(n: int):
    """(c1)'s ("data", "model") meshes over n cards, each with its batch
    rows: (1, n), and (2, n / 2) where n is even and at least 4, both with
    MODEL_BATCH rows, and then (2, n / 2) with one row (its cache's
    sequence over both mesh dims); (1, 1) on one card."""
    if n >= 4 and n % 2 == 0:
        return [((1, n), MODEL_BATCH), ((2, n // 2), MODEL_BATCH),
                ((2, n // 2), 1)]
    return [((1, n), MODEL_BATCH)]


def _row_sets(n_data: int, batch: int = MODEL_BATCH):
    """The batch rows each of n_data data shards holds."""
    return [slice(i * batch // n_data, (i + 1) * batch // n_data)
            for i in range(n_data)]


def _launch_counters():
    """(zero, read) for this process's kernel launch counters, by the names
    of KERNELS, each also by card."""
    from repro_torch.kernels.delta_rotate import ops as rot_ops
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.mla_decode import ops as mla_ops
    from repro_torch.kernels.softmax_merge import ops as merge_ops
    from repro_torch.kernels.sparse_select import ops as sel_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    wrappers = {"mla_decode": mla_ops.mla_decode,
                "softmax_merge": merge_ops.softmax_merge,
                "delta_rotate": rot_ops.delta_rotate,
                "sparse_select": sel_ops.sparse_select,
                "ssd_chunk": ssd_ops.ssd_intra_chunk}
    fp = fp_ops.flash_prefill

    def counters():
        out = {k: w.launches_by_card for k, w in wrappers.items()}
        out["flash_prefill"] = fp.launches_by_card["float32"]
        out["flash_prefill_bf16"] = fp.launches_by_card["bfloat16"]
        return out

    def zero():
        for w in list(wrappers.values()) + [fp]:
            w.launches = 0
        for k in fp.launches_by_dtype:
            fp.launches_by_dtype[k] = 0
        for c in counters().values():
            c.clear()

    def read():
        return {k: {int(card): n for card, n in c.items()}
                for k, c in counters().items()}
    return zero, read


def _whole(torch, x):
    """A result tree with every DTensor leaf gathered whole (a collective:
    every rank calls it)."""
    if isinstance(x, dict):
        return {k: _whole(torch, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_whole(torch, v) for v in x)
    return x.full_tensor() if hasattr(x, "full_tensor") else x


class MergeTimer:
    """Wraps models.model's local_seq_partials, while active, to time the
    cross-card merge of each call: CUDA events on the current stream after
    the shard's attention and after the merge, so their interval holds the
    packing, the all-gather over the sequence's ranks (waiting for the
    slowest) and the softmax_merge kernel."""

    def __init__(self, torch, M):
        self.torch, self.M, self.real = torch, M, M.local_seq_partials
        self.calls = []

    def __enter__(self):
        self.M.local_seq_partials = self
        return self

    def __exit__(self, *exc):
        self.M.local_seq_partials = self.real

    def __call__(self, attend, merge, q, cache):
        ev = {}

        def mark(fn, key):
            def run(*a):
                out = fn(*a)
                ev[key] = self.torch.cuda.Event(enable_timing=True)
                ev[key].record()
                return out
            return run
        out = self.real(mark(attend, "attend"), mark(merge, "merge"), q,
                        cache)
        self.calls.append((ev["attend"], ev["merge"]))
        return out

    def per_step(self, n_steps):
        """Each of n_steps decode steps' merge ms (a step's calls are its
        layers', in order; read after a synchronize)."""
        ms = [a.elapsed_time(b) for a, b in self.calls]
        if not ms or len(ms) % n_steps:
            fail(f"(5e) {len(ms)} merges timed over {n_steps} decode steps")
        k = len(ms) // n_steps
        return [sum(ms[i * k:(i + 1) * k]) for i in range(n_steps)]


# the Ops field of a kernel of KERNELS where its name differs
OPS_FIELD = {"ssd_chunk": "ssd_intra_chunk"}


def first_calls(torch, ops):
    """(ops whose flash_prefill, mla_decode, softmax_merge, sparse_select
    and ssd_intra_chunk keep a copy of the arguments of their first call in
    this process, by the name of KERNELS, and pass every call on; that
    record)."""
    seen = {}
    names = {f: n for n, f in OPS_FIELD.items()}

    def keep(field, fn):
        def call(*args, **kw):
            name = names.get(field, field) + (
                "_bf16" if field == "flash_prefill"
                and args[0].dtype == torch.bfloat16 else "")
            if name not in seen:
                seen[name] = (tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in args), dict(kw))
            return fn(*args, **kw)
        return call
    return dataclasses.replace(ops, **{
        f: keep(f, getattr(ops, f))
        for f in ("flash_prefill", "mla_decode", "softmax_merge",
                  "sparse_select", "ssd_intra_chunk")}), seen


def hold_first_calls(torch, M, seen):
    """Each call first_calls kept, run again through its kernel wrapper and
    through its plain version on the same inputs: {name: [argument shapes,
    max|err| over the output's leaves, within TOL] and, for sparse_select,
    the call's kb (the chosen rows each batch row attends)}. softmax_merge's
    leaves are held at TOL's 1e-6 relative to the leaf's largest
    magnitude where it exceeds 1 (check_softmax_merge holds l so)."""
    out = {}
    for name, (args, kw) in sorted(seen.items()):
        field = OPS_FIELD.get(name, name.removesuffix("_bf16"))
        got = leaves(getattr(M.KERNELS, field)(*args, **kw))
        want = leaves(getattr(M.PLAIN, field)(*args, **kw))
        torch.cuda.synchronize()
        atol, rtol = TOL[name]
        errs, ok = [], True
        for g, w in zip(got, want):
            g, w = g.float(), w.float()
            errs.append(max_err(torch, g, w))
            if field == "softmax_merge":
                ok &= errs[-1] <= atol * max(1.0, float(w.abs().max()))
            else:
                ok &= within(torch, g, w, atol, rtol)
        out[name] = [[list(a.shape) for a in args if torch.is_tensor(a)],
                     max(errs), bool(ok and len(got) == len(want))]
        if field == "sparse_select" and torch.is_tensor(args[3]):
            out[name].append(args[3].tolist())
    return out


def laid_out(tree, shardings):
    """A tree (dicts, tuples) of whole tensors distributed leaf by leaf as
    the same tree of NamedShardings says."""
    from repro_torch.distributed import sharding as SH
    if isinstance(tree, dict):
        return {k: laid_out(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(laid_out(v, sh) for v, sh in zip(tree, shardings))
    return SH.distribute(tree, shardings.mesh, shardings.spec)


def serve_sharded(torch, M, params, cfg, mesh, tokens, feed, *, dtype, ops,
                  routes=None, step_cfgs=None, whole_params=None):
    """The sharded serving form through the entry points, on mesh with the
    dry run's placements (the batch as train_batch_shardings, the decode
    state of SERVE_SLOTS slots as decode_state_shardings: the latent
    cache's sequence over `model`, or over both mesh dims for one row;
    each step's token and position as decode_input_shardings; sp_policy,
    and without whole_params sp_policy(...).for_batch(B): one row the data
    dims do not split keeps its batch whole): prefill tokens (B, S) twice
    (the second for the warm wall), fill the state with the first's
    caches, then one decode_step per row of feed (steps, B, 1) at slots S,
    S + 1, ..., step i with step_cfgs[i] (None: cfg). With whole_params
    (the same weights unsharded) the prefill runs unsharded on every rank
    and its caches enter the state whole, the form (c1) runs its one row
    in. Returns the results (DTensors;
    "kept_state" a copy of the state after the steps with cfg, where
    others follow) and the walls, each ending in a synchronize."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import input_specs as IS
    B, S = tokens.shape
    dev = tokens.device
    step_cfgs = step_cfgs or [cfg] * feed.shape[0]
    sync = lambda: torch.cuda.synchronize(dev)
    out = {"decode": [], "decode_s": [], "kept_state": None}
    pol = POL.sp_policy(mesh)
    with POL.use_policy(pol if whole_params else pol.for_batch(B)), \
            implicit_replication(), torch.no_grad():
        if whole_params is None:
            tk = SH.distribute(tokens, mesh, SH.fit_spec(
                IS.train_batch_shardings({"tokens": tokens}, mesh)[
                    "tokens"].spec, tokens.shape, mesh))
            prefill = lambda **kw: M.prefill(params, cfg, {"tokens": tk},
                                             ops=ops, **kw)
        else:
            def prefill(**kw):
                with POL.use_policy(None):
                    lg, cs = M.prefill(whole_params, cfg, {"tokens": tokens},
                                       ops=ops, **kw)
                return lg, {k: SH.distribute(v, mesh, ())
                            for k, v in cs.items()}
        sync()
        t0 = time.perf_counter()
        logits, caches = prefill(routes=routes)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        prefill()
        sync()
        out["warm_prefill_s"] = time.perf_counter() - t0
        shard = IS.decode_state_shardings(
            cfg, ShapeSpec("serve", SERVE_SLOTS, B, "decode"), mesh)
        state = M.fill_decode_state(cfg, laid_out(M.init_decode_state(
            cfg, B, SERVE_SLOTS, dtype=dtype, device=dev), shard), caches)
        tok_sh, pos_sh, _ = IS.decode_input_shardings(mesh, B)
        for i in range(feed.shape[0]):
            if step_cfgs[i] is not cfg and out["kept_state"] is None:
                out["kept_state"] = clone_tree(state)
            tok = SH.distribute(feed[i], mesh, tok_sh.spec)
            pos = SH.distribute(torch.full((B, 1), S + i, device=dev), mesh,
                                pos_sh.spec)
            sync()
            t0 = time.perf_counter()
            lg, state = M.decode_step(params, step_cfgs[i], state, tok, pos,
                                      S + i, ops=ops, routes=routes)
            sync()
            out["decode_s"].append(time.perf_counter() - t0)
            out["decode"].append(lg)
    out.update(prefill=logits, caches=caches, state=state)
    return out


def serve_unsharded(torch, M, cfg, tokens, n_data, *, dtype, ops, feed=None,
                    routes=None, margins=False, step_cfgs=None):
    """The same prefill and steps unsharded on this card, the batch as n_data
    data shards dispatch it (each shard's rows on their own: the
    expert-parallel MoE takes each data shard's tokens at that shard's
    capacity), greedy or fed feed (steps, B, 1), step i with step_cfgs[i]
    (None: MODEL_STEPS with cfg); every result joined over the batch, the
    routes call by call (and with margins, each call's router margins,
    "margins"); where other configs follow cfg's steps, "kept_state" the
    state after cfg's."""
    import contextlib
    dev = tokens.device
    step_cfgs = step_cfgs or [cfg] * MODEL_STEPS
    keep = next((i for i, c in enumerate(step_cfgs) if c is not cfg), None)
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=dtype)
    runs, per_run, per_margins = [], [], []
    for rows in _row_sets(n_data, tokens.shape[0]):
        rr = []
        rec = RouterMargins(torch) if margins else contextlib.nullcontext()
        with rec:
            runs.append(run_model(
                torch, M, params, cfg, {"tokens": tokens[rows]}, step_cfgs,
                dtype=dtype, ops=ops, routes=rr,
                feed=None if feed is None else [f[rows] for f in feed],
                slots=SERVE_SLOTS, keep_state_at=keep))
        per_run.append(rr)
        per_margins.append(rec.margins if margins else None)
    del params
    torch.cuda.empty_cache()
    cat = lambda xs, d=0: torch.cat(xs, dim=d)
    # one run's trees as they are (the hybrid's nest tuples and its group
    # states hold the batch at dim 2); several runs' MLA caches joined
    batch1 = lambda key: runs[0][key] if len(runs) == 1 else {
        k: cat([r[key][k] for r in runs], 1) for k in runs[0][key]}
    out = {"prefill": cat([r["prefill"] for r in runs]),
           "decode": [cat([r["decode"][i] for r in runs])
                      for i in range(len(step_cfgs))],
           "fed": torch.stack([cat([r["fed"][i] for r in runs])
                               for i in range(len(step_cfgs))]),
           "caches": batch1("caches"), "state": batch1("state"),
           "kept_state": batch1("kept_state") if keep is not None else None,
           "prefill_s": [r["prefill_s"] for r in runs],
           "decode_s": [w for r in runs for w in r["decode_s"]]}
    if routes is not None:
        routes.extend(cat([rr[i] for rr in per_run])
                      for i in range(len(per_run[0])))
    if margins:
        out["margins"] = [cat([m[i] for m in per_margins])
                          for i in range(len(per_margins[0]))]
    return out


class RouterMargins:
    """Records, while active, each MoE call's router margin per token: the
    gap between its k-th and (k + 1)-th router probabilities (a flip of
    the expert set needs the two to swap)."""

    def __init__(self, torch):
        from repro_torch.models import moe as MOE
        self.torch, self.MOE, self.real = torch, MOE, MOE._router
        self.margins = []

    def __enter__(self):
        def record(p, cfg, x, idx=None):
            out = self.real(p, cfg, x, idx)
            top = self.torch.topk(out[2], cfg.top_k + 1, dim=-1).values
            self.margins.append(top[:, -2] - top[:, -1])
            return out
        self.MOE._router = record
        return self

    def __exit__(self, *exc):
        self.MOE._router = self.real


def route_flips(torch, got, want, margins=None):
    """[(call, token, router margin or None)] where two runs' MoE routes
    choose different expert sets (the order inside the top k moves only
    the order of the MoE's sum; a different number of calls: one entry,
    call -1)."""
    if len(got) != len(want):
        return [(-1, -1, None)]
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        differ = (a.sort(-1).values != b.sort(-1).values).any(-1)
        for t in differ.nonzero().flatten().tolist():
            m = float(margins[i][t]) if margins and i < len(margins) \
                else None
            out.append((i, t, m))
    return out


def held_errors(torch, got, want, tol):
    """{what: max|err|} of prefill logits, the MODEL_STEPS dense decode
    steps' logits, every cache and state leaf (the state after the dense
    steps), and where selection steps follow, their logits ("select") and
    the state after them ("select_state"); the names of those beyond tol
    (atol, rtol)."""
    n = MODEL_STEPS
    dense = lambda r: r["kept_state"] if r.get("kept_state") else r["state"]
    pairs = {"prefill": [(got["prefill"], want["prefill"])],
             "decode": list(zip(got["decode"][:n], want["decode"][:n])),
             "caches": list(zip(leaves(got["caches"]),
                                leaves(want["caches"]))),
             "state": list(zip(leaves(dense(got)), leaves(dense(want))))}
    if len(want["decode"]) > n:
        pairs["select"] = list(zip(got["decode"][n:], want["decode"][n:]))
        pairs["select_state"] = list(zip(leaves(got["state"]),
                                         leaves(want["state"])))
    errs, bad = {}, []
    for what, ps in pairs.items():
        if not ps or any(a.shape != b.shape for a, b in ps):
            bad.append(f"{what} (layout)")
            continue
        errs[what] = max(max_err(torch, a.float(), b.float()) for a, b in ps)
        if not all(within(torch, a.double(), b.double(), *tol) for a, b in ps):
            bad.append(what)
    return errs, bad


class ChosenIds:
    """Records, while active, each call of sharding.global_top_k (one a
    layer of a selection step): this rank's first row offset, its row
    count, the chosen global ids; for a call on one whole cache each row's
    gap between its k-th and (k + 1)-th scores, relative to the k-th; with
    keep_scores, the scores this rank passed."""

    def __init__(self, torch, keep_scores=False):
        from repro_torch.distributed import sharding as SH
        self.torch, self.SH, self.real = torch, SH, SH.global_top_k
        self.keep_scores, self.calls = keep_scores, []

    def __enter__(self):
        def record(scores, k, mesh=None, seq_dims=(), off=0):
            ids = self.real(scores, k, mesh, seq_dims, off)
            entry = {"off": off, "n": scores.shape[-1], "ids": ids}
            if not seq_dims and scores.shape[-1] > k:
                top = self.torch.topk(scores.double(), k + 1, dim=-1).values
                entry["gap"] = (top[:, -2] - top[:, -1]) / \
                    top[:, -2].abs().clamp_min(1e-300)
            if self.keep_scores:
                entry["scores"] = scores.clone()
            self.calls.append(entry)
            return ids
        self.SH.global_top_k = record
        return self

    def __exit__(self, *exc):
        self.SH.global_top_k = self.real

    def portable(self):
        """The calls as (offset, rows, ids on the host) for
        all_gather_object."""
        return [(c["off"], c["n"], c["ids"].cpu()) for c in self.calls]


class PinnedChosen(ChosenIds):
    """ChosenIds whose wrapper, while active, returns the next of `ids`
    (another run's chosen global ids, one (B, k) a call, in call order)
    in place of the selection it ran and recorded: the sharded run still
    scores, gathers and chooses (its own ids kept in `calls`, held against
    the other run's), but attends the other run's rows, so that a near-tie
    its own choice flips does not carry into the layers after it, as
    pinned MoE routes keep a router's near-tie from doing."""

    def __init__(self, torch, ids):
        super().__init__(torch)
        self.ids = iter(ids)

    def __enter__(self):
        super().__enter__()
        record = self.SH.global_top_k

        def pinned(*a, **kw):
            record(*a, **kw)
            return next(self.ids)
        self.SH.global_top_k = pinned
        return self


def chosen_whole(torch, by_rank, batch):
    """Each recorded call's chosen ids over the whole batch from every
    rank's record ((data coordinate, ChosenIds.portable())), the ranks of
    one data shard checked equal and a split batch joined in data order;
    and each call's kb (the chosen ids a rank holds) by rank, the least
    over the rows. None where the ranks disagree."""
    n_calls = {len(c) for _, c in by_rank}
    if len(n_calls) != 1:
        return None, None
    whole, kb = [], []
    for i in range(n_calls.pop()):
        by_data, held = {}, []
        for data, calls in by_rank:
            off, n, ids = calls[i]
            if data in by_data and not torch.equal(by_data[data], ids):
                return None, None
            by_data[data] = ids
            held.append(int(((ids >= off) & (ids < off + n)).sum(-1).min()))
        parts = [by_data[d] for d in sorted(by_data)]
        if parts[0].shape[0] == batch:
            if not all(torch.equal(p, parts[0]) for p in parts):
                return None, None
            whole.append(parts[0])
        else:
            whole.append(torch.cat(parts))
        kb.append(held)
    return whole, kb


def unsharded_chosen(torch, calls, n_sets):
    """An unsharded run's calls (ChosenIds.calls, its row sets one after
    another) as (ids, gaps) a call over the whole batch."""
    per = len(calls) // n_sets
    cat = lambda key, i: torch.cat([calls[s * per + i][key].cpu()
                                    for s in range(n_sets)])
    return [(cat("ids", i), cat("gap", i)) for i in range(per)]


def selection_flips(torch, got, want):
    """[(call, row, the unsharded gap)] where the chosen sets differ (a
    different number of calls: one entry, call -1)."""
    if got is None or len(got) != len(want):
        return [(-1, -1, None)]
    out = []
    for i, (a, (b, gap)) in enumerate(zip(got, want)):
        diff = (a.sort(-1).values != b.sort(-1).values).any(-1)
        out += [(i, r, float(gap[r])) for r in diff.nonzero().flatten()
                .tolist()]
    return out


def _sharded_params(torch, M, cfg, mesh, dev, dtype):
    from repro_torch.distributed import sharding as SH
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=dtype)
    return SH.shard_params(params, SH.param_shardings(params, mesh))


def serve_f32_mesh(torch, dev, cfg, shape, batch=MODEL_BATCH):
    """(c1) on one mesh, `batch` rows (1: one row, its cache's sequence
    over every mesh dim, its prefill unsharded on each rank): the
    unsharded steps (rank 0's card, KERNELS, the router margins and the
    chosen sets recorded), then the sharded ones with KERNELS (counted,
    each kernel's first call on each card kept and held against its plain
    version, the chosen sets recorded) and with PLAIN, fed the unsharded
    run's greedy tokens: MODEL_STEPS dense steps, then SEL_STEPS with
    selection_k SEL_K; rank 0 holds the sharded KERNELS run against both.
    After a route or selection flip, the comparison is also held in f64
    with PLAIN ops on both sides."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    rank = dist.get_rank()
    mesh = make_mesh(shape, ("data", "model"))
    tokens = _prompt(torch, dev, cfg.vocab, MODEL_PROMPT)[:batch]
    n_data = shape[0] if batch > 1 else 1
    step_cfgs = [cfg] * MODEL_STEPS + \
        [dataclasses.replace(cfg, selection_k=SEL_K)] * SEL_STEPS
    feed = torch.zeros((len(step_cfgs), batch, 1), dtype=torch.long,
                       device=dev)
    ref, ref_routes = None, []
    if rank == 0:
        with ChosenIds(torch) as ref_ids:
            ref = serve_unsharded(torch, M, cfg, tokens, n_data,
                                  dtype=torch.float32, ops=M.KERNELS,
                                  routes=ref_routes, margins=True,
                                  step_cfgs=step_cfgs)
        feed.copy_(ref["fed"])
    dist.broadcast(feed, 0)
    params = _sharded_params(torch, M, cfg, mesh, dev, torch.float32)
    whole = None if batch > 1 else M.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=torch.float32)
    ops, seen = first_calls(torch, M.KERNELS)
    zero, read = _launch_counters()
    zero()
    torch.cuda.reset_peak_memory_stats(dev)
    rk, rp = [], []
    with ChosenIds(torch) as got_ids:
        kern = serve_sharded(torch, M, params, cfg, mesh, tokens, feed,
                             dtype=torch.float32, ops=ops, routes=rk,
                             step_cfgs=step_cfgs, whole_params=whole)
    torch.cuda.synchronize(dev)
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    held = hold_first_calls(torch, M, seen)
    del seen
    plain = serve_sharded(torch, M, params, cfg, mesh, tokens, feed,
                          dtype=torch.float32, ops=M.PLAIN, routes=rp,
                          step_cfgs=step_cfgs, whole_params=whole)
    walls = {k: kern[k] for k in ("prefill_s", "warm_prefill_s",
                                  "decode_s")}
    kern, plain = _whole(torch, kern), _whole(torch, plain)
    rk, rp = _whole(torch, rk), _whole(torch, rp)
    ids_by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(ids_by_rank, (mesh.get_coordinate()[0],
                                         got_ids.portable()))
    res = {"mesh": list(shape), "batch": batch, "walls": walls}
    if rank == 0:
        res["unsharded_walls"] = {"prefill_s": ref["prefill_s"],
                                  "decode_s": ref["decode_s"]}
        res["routes"] = sum(int(r.numel()) for r in rk)
        for name, want, want_routes, tol in (
                ("unsharded", ref, ref_routes, SERVE_TOL),
                ("plain", plain, rp, MODEL_TOL["v2_lite"])):
            errs, bad = held_errors(torch, kern, want, tol)
            res[name] = {"errs": errs, "beyond": bad,
                         "flips": route_flips(torch, rk, want_routes,
                                              ref["margins"])}
        chosen, kb = chosen_whole(torch, ids_by_rank, batch)
        res["chosen_calls"] = len(ref_ids.calls)
        res["chosen_flips"] = selection_flips(torch, chosen, unsharded_chosen(
            torch, ref_ids.calls, len(_row_sets(n_data, batch))))
        res["kb"] = kb
    del kern, plain
    flipped = [any(res[k]["flips"] for k in ("unsharded", "plain"))
               or bool(res["chosen_flips"]) if rank == 0 else None]
    dist.broadcast_object_list(flipped, 0)
    if flipped[0]:
        res["f64"] = serve_f64_mesh(torch, dev, cfg, mesh, shape, tokens,
                                    feed, step_cfgs, batch)
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, {"launches": launches, "peak_gib": peak,
                                     "held": held})
    for key in ("launches", "peak_gib", "held"):
        res[key] = [r[key] for r in by_rank]
    del params, whole
    torch.cuda.empty_cache()
    return res


def serve_f64_mesh(torch, dev, cfg, mesh, shape, tokens, feed, step_cfgs,
                   batch):
    """(c1)'s comparison again after a route or selection flip: the sharded
    and the unsharded steps in f64 with PLAIN ops, the same tokens fed;
    rank 0's errors, route flips and selection flips."""
    import torch.distributed as dist
    from repro_torch.models import model as M
    ref, ref_routes = None, []
    n_data = shape[0] if batch > 1 else 1
    if dist.get_rank() == 0:
        with ChosenIds(torch) as ref_ids:
            ref = serve_unsharded(torch, M, cfg, tokens, n_data,
                                  dtype=torch.float64, ops=M.PLAIN,
                                  feed=list(feed), routes=ref_routes,
                                  step_cfgs=step_cfgs)
    params = _sharded_params(torch, M, cfg, mesh, dev, torch.float64)
    whole = None if batch > 1 else M.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=torch.float64)
    rs = []
    with ChosenIds(torch) as got_ids:
        got = _whole(torch, serve_sharded(
            torch, M, params, cfg, mesh, tokens, feed, dtype=torch.float64,
            ops=M.PLAIN, routes=rs, step_cfgs=step_cfgs, whole_params=whole))
    rs = _whole(torch, rs)
    ids_by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(ids_by_rank, (mesh.get_coordinate()[0],
                                         got_ids.portable()))
    del params, whole
    torch.cuda.empty_cache()
    if dist.get_rank() != 0:
        return None
    errs, bad = held_errors(torch, got, ref, SERVE_TOL)
    chosen, _ = chosen_whole(torch, ids_by_rank, batch)
    return {"errs": errs, "beyond": bad,
            "flips": route_flips(torch, rs, ref_routes),
            "chosen_flips": selection_flips(torch, chosen, unsharded_chosen(
                torch, ref_ids.calls, len(_row_sets(n_data, batch))))}


def serve_bf16(torch, dev, cfg, shape):
    """(c2): V2-Lite as published in bf16 on a (1, n) mesh with KERNELS,
    fed the greedy tokens of the same steps unsharded on card 0 (run as
    phase 5b (a) runs them, on the same weights): each kernel's first call
    on each card held against its plain version at the shapes the shard
    gives it; rank 0 compares the last-token logits, the top-1 tokens and
    the routes; every card's launches, peak memory; the walls and the
    cross-card merge's share of a decode step."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    rank = dist.get_rank()
    mesh = make_mesh(shape, ("data", "model"))
    tokens = _prompt(torch, dev, cfg.vocab, MODEL_PROMPT)
    feed = torch.zeros((MODEL_STEPS, MODEL_BATCH, 1), dtype=torch.long,
                       device=dev)
    ref, ref_routes, ref_peak = None, [], None
    if rank == 0:
        torch.cuda.reset_peak_memory_stats(dev)
        ref = serve_unsharded(torch, M, cfg, tokens, 1,
                              dtype=torch.bfloat16, ops=M.KERNELS,
                              routes=ref_routes)
        ref_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        feed.copy_(ref["fed"])
    dist.broadcast(feed, 0)
    t0 = time.perf_counter()
    params = _sharded_params(torch, M, cfg, mesh, dev, torch.bfloat16)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    ops, seen = first_calls(torch, M.KERNELS)
    zero, read = _launch_counters()
    zero()
    torch.cuda.reset_peak_memory_stats(dev)
    rk = []
    with MergeTimer(torch, M) as timer:
        kern = serve_sharded(torch, M, params, cfg, mesh, tokens, feed,
                             dtype=torch.bfloat16, ops=ops, routes=rk)
    torch.cuda.synchronize(dev)
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    merge_ms = timer.per_step(MODEL_STEPS)
    held = hold_first_calls(torch, M, seen)
    del seen
    lg = _whole(torch, [kern["prefill"]] + kern["decode"])
    rk = _whole(torch, rk)
    caches = _whole(torch, kern["caches"])
    walls = {k: kern[k] for k in ("prefill_s", "warm_prefill_s",
                                  "decode_s")}
    del kern
    torch.cuda.empty_cache()
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, {"launches": launches, "peak_gib": peak,
                                     "merge_ms": merge_ms, "held": held})
    if rank != 0:
        return None, params
    want = [ref["prefill"]] + ref["decode"]
    top1 = [[bool(a) for a in (g.argmax(-1) == w.argmax(-1)).flatten()]
            for g, w in zip(lg, want)]
    same = sum(int((a == b).all(-1).sum()) for a, b in zip(rk, ref_routes)) \
        if len(rk) == len(ref_routes) else 0
    share = [m / (w * 1e3) for m, w in zip(merge_ms, walls["decode_s"])]
    out = {"mesh": list(shape), "layers": cfg.n_layers, "init_s": init_s,
           "parting": _parting(torch, cfg, caches, rk, ref["caches"],
                               ref_routes),
           "last_token_max_abs_diff": max_err(torch, lg[0].float(),
                                              want[0].float()),
           "decode_max_abs_diff": max(max_err(torch, g.float(), w.float())
                                      for g, w in zip(lg[1:], want[1:])),
           "top1_by_row": top1, "routes_equal": same,
           "routes": sum(int(r.shape[0]) for r in ref_routes),
           "walls": walls,
           "unsharded_walls": {"prefill_s": ref["prefill_s"],
                               "decode_s": ref["decode_s"]},
           "unsharded_peak_gib": ref_peak,
           "merge_share_card0": share}
    for key in ("launches", "peak_gib", "merge_ms", "held"):
        out[key] = [r[key] for r in by_rank]
    return out, params


# ---------------------------------------------------------------------------
# 5e (c4). the GQA and Mamba2/Zamba2 families' sharded serve over NCCL
# ---------------------------------------------------------------------------

# (c4a), (c4b): the sharded steps against the same steps unsharded and
# against the sharded PLAIN ops, f32: 5d (b)'s Zamba2 limit for both
FAMILY_TOL = MODEL_TOL["zamba2"]
# the kernels of each (c4) part: each launched on every card (the GQA
# family runs no kernel but the merge)
FAMILY_PATH = {"a": ("ssd_chunk", "softmax_merge"),
               "b": ("softmax_merge",),
               "c": ("ssd_chunk", "softmax_merge")}


def serve_family_f32(torch, dev, cfg, shape, batch=MODEL_BATCH):
    """(c4a) or (c4b) on one mesh, `batch` rows (1: one row, its K/V cache's
    sequence over every mesh dim, its prefill sharded with the batch whole):
    the unsharded steps on rank 0's card with KERNELS, then the sharded ones
    with KERNELS (counted; each kernel's first call on each card kept and
    held against its plain version) and with PLAIN, both fed the unsharded
    run's greedy tokens: prefill MODEL_BATCH x MODEL_PROMPT into SERVE_SLOTS
    slots, MODEL_STEPS decode steps. Rank 0 holds the KERNELS run against
    both at FAMILY_TOL."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    rank = dist.get_rank()
    mesh = make_mesh(shape, ("data", "model"))
    tokens = _prompt(torch, dev, cfg.vocab, MODEL_PROMPT)[:batch]
    feed = torch.zeros((MODEL_STEPS, batch, 1), dtype=torch.long,
                       device=dev)
    ref = None
    if rank == 0:
        ref = serve_unsharded(torch, M, cfg, tokens, 1, dtype=torch.float32,
                              ops=M.KERNELS)
        feed.copy_(ref["fed"])
    dist.broadcast(feed, 0)
    params = _sharded_params(torch, M, cfg, mesh, dev, torch.float32)
    ops, seen = first_calls(torch, M.KERNELS)
    zero, read = _launch_counters()
    zero()
    torch.cuda.reset_peak_memory_stats(dev)
    kern = serve_sharded(torch, M, params, cfg, mesh, tokens, feed,
                         dtype=torch.float32, ops=ops)
    torch.cuda.synchronize(dev)
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    held = hold_first_calls(torch, M, seen)
    del seen
    plain = serve_sharded(torch, M, params, cfg, mesh, tokens, feed,
                          dtype=torch.float32, ops=M.PLAIN)
    walls = {k: kern[k] for k in ("prefill_s", "warm_prefill_s",
                                  "decode_s")}
    kern, plain = _whole(torch, kern), _whole(torch, plain)
    res = {"mesh": list(shape), "batch": batch, "layers": cfg.n_layers,
           "name": cfg.name, "walls": walls}
    if rank == 0:
        res["unsharded_walls"] = {"prefill_s": ref["prefill_s"],
                                  "decode_s": ref["decode_s"]}
        for name, want in (("unsharded", ref), ("plain", plain)):
            errs, bad = held_errors(torch, kern, want, FAMILY_TOL)
            res[name] = {"errs": errs, "beyond": bad}
    del kern, plain, ref
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, {"launches": launches, "peak_gib": peak,
                                     "held": held})
    for key in ("launches", "peak_gib", "held"):
        res[key] = [r[key] for r in by_rank]
    del params
    torch.cuda.empty_cache()
    return res


def serve_family_bf16(torch, dev, cfg, shape):
    """(c4c): cfg as published in bf16 on a (1, n) mesh with KERNELS, fed
    the greedy tokens of the same steps unsharded on card 0: each kernel's
    first call on each card held against its plain version at the shapes
    the shard gives it; rank 0 compares the last-token and decode logits
    and the top-1 tokens; every card's launches and peak memory; the walls
    and the cross-card merge's share of a decode step."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    rank = dist.get_rank()
    mesh = make_mesh(shape, ("data", "model"))
    tokens = _prompt(torch, dev, cfg.vocab, MODEL_PROMPT)
    feed = torch.zeros((MODEL_STEPS, MODEL_BATCH, 1), dtype=torch.long,
                       device=dev)
    ref, ref_peak = None, None
    if rank == 0:
        torch.cuda.reset_peak_memory_stats(dev)
        ref = serve_unsharded(torch, M, cfg, tokens, 1,
                              dtype=torch.bfloat16, ops=M.KERNELS)
        ref_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        feed.copy_(ref["fed"])
    dist.broadcast(feed, 0)
    t0 = time.perf_counter()
    params = _sharded_params(torch, M, cfg, mesh, dev, torch.bfloat16)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    ops, seen = first_calls(torch, M.KERNELS)
    zero, read = _launch_counters()
    zero()
    torch.cuda.reset_peak_memory_stats(dev)
    with MergeTimer(torch, M) as timer:
        kern = serve_sharded(torch, M, params, cfg, mesh, tokens, feed,
                             dtype=torch.bfloat16, ops=ops)
    torch.cuda.synchronize(dev)
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    merge_ms = timer.per_step(MODEL_STEPS)
    held = hold_first_calls(torch, M, seen)
    del seen
    lg = _whole(torch, [kern["prefill"]] + kern["decode"])
    walls = {k: kern[k] for k in ("prefill_s", "warm_prefill_s",
                                  "decode_s")}
    del kern
    del params
    torch.cuda.empty_cache()
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, {"launches": launches, "peak_gib": peak,
                                     "merge_ms": merge_ms, "held": held})
    if rank != 0:
        return None
    want = [ref["prefill"]] + ref["decode"]
    top1 = [[bool(a) for a in (g.argmax(-1) == w.argmax(-1)).flatten()]
            for g, w in zip(lg, want)]
    out = {"mesh": list(shape), "layers": cfg.n_layers, "name": cfg.name,
           "init_s": init_s,
           "last_token_max_abs_diff": max_err(torch, lg[0].float(),
                                              want[0].float()),
           "decode_max_abs_diff": [max_err(torch, g.float(), w.float())
                                   for g, w in zip(lg[1:], want[1:])],
           "top1_by_row": top1, "walls": walls,
           "unsharded_walls": {"prefill_s": ref["prefill_s"],
                               "decode_s": ref["decode_s"]},
           "unsharded_peak_gib": ref_peak,
           "merge_share_card0": [m / (w * 1e3) for m, w in zip(
               by_rank[0]["merge_ms"], walls["decode_s"])]}
    for key in ("launches", "peak_gib", "merge_ms", "held"):
        out[key] = [r[key] for r in by_rank]
    return out


def serve_families(torch, dev, world):
    """(c4) in one process group of `world` cards: (a) Zamba2-7B at full
    width cut to hybrid_group + 1 layers in f32 on every mesh of
    serve_meshes(world); on two cards or more, (b) qwen3-32b at full width
    cut to 8 of its 64 layers in f32 and (c) Zamba2-7B as published in
    bf16, each on (1, world)."""
    from repro_torch.configs import qwen3_32b, zamba2_7b
    zamba2 = zamba2_7b.config()
    cut = dataclasses.replace(zamba2, n_layers=zamba2.hybrid_group + 1)
    out = {"a": [serve_family_f32(torch, dev, cut, shape, batch)
                 for shape, batch in serve_meshes(world)]}
    if world >= 2:
        qwen = dataclasses.replace(qwen3_32b.config(), n_layers=8)
        out["b"] = serve_family_f32(torch, dev, qwen, (1, world))
        out["c"] = serve_family_bf16(torch, dev, zamba2, (1, world))
    return out


def _parting(torch, cfg, caches, routes, ref_caches, ref_routes):
    """Where two runs part, layer by layer: each layer's prefill cache
    entries' max|diff|, and each MoE layer's share of prefill tokens whose
    top-k routes are all equal (the first MoE calls are the prefill's)."""
    n_moe = cfg.n_layers - cfg.first_k_dense
    return {"cache_max_abs_diff": [
                max_err(torch, a.float(), b.float())
                for key in ("dense_blocks", "blocks")
                for a, b in zip(caches[key], ref_caches[key])],
            "routes_equal_share": [
                float((a == b).all(-1).float().mean())
                for a, b in zip(routes[:n_moe], ref_routes[:n_moe])]}


def long_cache(torch, cfg, state, off, seed=0):
    """Fill the latent caches of a long_500k decode state in place, local
    tensors {key: (L, B, n, D)} holding slots off .. off + n of LONG_SLOTS:
    N(0, 1) draws made on the card, LONG_BLOCK slots a generator seeded by
    (seed, the model's layer, the block), cast to the cache's dtype. Each
    card draws only its own rows; the same slots get the same values on
    any card and in any split."""
    first = {"dense_blocks": 0, "blocks": cfg.first_k_dense}
    for key, t in state.items():
        B, n, D = t.shape[1:]
        for li in range(t.shape[0]):
            for j in range(off // LONG_BLOCK, (off + n) // LONG_BLOCK):
                g = torch.Generator(device=t.device).manual_seed(
                    (seed * 1000 + first[key] + li) * 1000 + j)
                lo = j * LONG_BLOCK - off
                t[li, :, lo:lo + LONG_BLOCK].copy_(torch.randn(
                    (B, LONG_BLOCK, D), generator=g, device=t.device))


class SelectTimer:
    """Wraps models.model's local_seq_selected, while active, to time each
    call's parts with CUDA events on the current stream: from its start to
    the local attend (the scores, the shard's top k and the candidates'
    all-gather: "select"), the attend (sparse_select: "attend") and the
    merge (packing, the partials' all-gather, softmax_merge: "merge")."""

    def __init__(self, torch, M):
        self.torch, self.M, self.real = torch, M, M.local_seq_selected
        self.calls = []

    def __enter__(self):
        self.M.local_seq_selected = self
        return self

    def __exit__(self, *exc):
        self.M.local_seq_selected = self.real

    def __call__(self, select, merge, q, qi, cache, k):
        ev = {key: self.torch.cuda.Event(enable_timing=True)
              for key in ("start", "select", "attend", "merge")}
        ev["start"].record()

        def attend(*a):
            ev["select"].record()
            out = select(*a)
            ev["attend"].record()
            return out

        def joined(*a):
            out = merge(*a)
            ev["merge"].record()
            return out
        out = self.real(attend, joined, q, qi, cache, k)
        self.calls.append(ev)
        return out

    def per_step(self, n_steps):
        """{part: ms a decode step} summed over the step's layers (read
        after a synchronize)."""
        k = len(self.calls) // n_steps
        span = {"select": ("start", "select"), "attend": ("select", "attend"),
                "merge": ("attend", "merge")}
        return {part: [sum(e[a].elapsed_time(e[b])
                           for e in self.calls[i * k:(i + 1) * k])
                       for i in range(n_steps)]
                for part, (a, b) in span.items()}


def written_entries(torch, state, widx):
    """Every layer's latent cache entry at slot widx, (L, B, D) in layer
    order, whole on every rank: on a state sharded over the sequence the
    rank that holds slot widx gives its rows and the others zeros, joined
    by one all-reduce (exact: each element is one value plus zeros; a
    collective, every rank calls it)."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    parts, sharded = [], False
    for key in ("dense_blocks", "blocks"):
        t = state.get(key)
        if t is None:
            continue
        if not SH.is_dtensor(t):
            parts.append(t[:, :, widx].clone())
            continue
        sharded = True
        _, off, n = SH._seq_shard(t, 2)
        local = t.to_local()
        parts.append(local[:, :, widx - off].clone() if off <= widx < off + n
                     else torch.zeros_like(local[:, :, 0]))
    out = torch.cat(parts)
    if sharded:
        dist.all_reduce(out)
    return out


def long_unsharded(torch, M, cfg, dev, first, ops, feed=None, *, dtype,
                   pinned=None):
    """(c3)'s or (c5)'s steps unsharded on this card with ops, the weights
    and the cache in dtype, greedy from token first (1, 1) or fed feed's
    tokens, step i's MoE layers pinned to pinned[i] where given: logits,
    the tokens fed, the walls, every layer's ChosenIds record a step
    ("calls", with its scores) and its chosen ids, each step's routes (one
    (1, k) a MoE layer) and written entries (written_entries), each MoE
    call's router margin, the peak memory."""
    torch.cuda.reset_peak_memory_stats(dev)
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=dtype)
    state = M.init_decode_state(cfg, 1, LONG_SLOTS, dtype=dtype, device=dev)
    long_cache(torch, cfg, state, 0)
    out = {"logits": [], "fed": [], "decode_s": [], "routes": [],
           "entries": []}
    tok = first
    with ChosenIds(torch, keep_scores=True) as rec, \
            RouterMargins(torch) as rm, torch.no_grad():
        for i in range(LONG_STEPS):
            widx = LONG_SLOTS - LONG_STEPS + i
            tok = tok if feed is None else feed[i]
            routes = []
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            lg, state = M.decode_step(
                params, cfg, state, tok, torch.full((1, 1), widx, device=dev),
                widx, ops=ops, routes=routes,
                pinned=None if pinned is None else pinned[i])
            torch.cuda.synchronize(dev)
            out["decode_s"].append(time.perf_counter() - t0)
            out["logits"].append(lg)
            out["fed"].append(tok)
            out["routes"].append(routes)
            out["entries"].append(written_entries(torch, state, widx))
            tok = lg.argmax(-1)
    out.update(calls=rec.calls, ids=[c["ids"] for c in rec.calls],
               margins=rm.margins)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del params, state
    torch.cuda.empty_cache()
    return out


def long_state(torch, M, cfg, mesh, dev, dtype):
    """(c3)'s or (c5)'s decode state in dtype on mesh, laid out by
    decode_state_shardings at long_500k (one row: the sequence over the
    mesh), each card's rows drawn on the card (long_cache) into its local
    tensors."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import input_specs as IS
    shard = IS.decode_state_shardings(
        cfg, ShapeSpec("long_500k", LONG_SLOTS, 1, "decode"), mesh)
    state = {}
    for key, spec in M.init_decode_state(cfg, 1, LONG_SLOTS,
                                         device="meta").items():
        pl = SH.placements(shard[key].spec, mesh)
        shape = list(spec.shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                shape[p.dim] //= mesh.shape[i]
        local = torch.empty(shape, dtype=dtype, device=dev)
        state[key] = DTensor.from_local(local, mesh, pl, run_check=False)
        _, off, _ = SH._seq_shard(state[key], 2)
        long_cache(torch, cfg, {key: local}, off)
    return state


def long_sharded(torch, M, cfg, mesh, dev, params, feed, ops, *, dtype,
                 pinned=None, chosen=None):
    """(c3)'s or (c5)'s sharded steps on mesh: the state drawn anew
    (long_state), LONG_STEPS decode steps at the last slots fed feed's
    tokens under sp_policy, step i's MoE layers pinned to pinned[i] where
    given, and with chosen (another run's chosen ids, one a layer call)
    every selection attending those rows (PinnedChosen). Returns, on every
    rank, the logits and each step's routes whole, each step's written
    entries (written_entries), every layer's ChosenIds record of the run's
    own choice (step 0's with this rank's scores), the step walls, a step's
    parts (SelectTimer) and the fill's wall."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import input_specs as IS
    t0 = time.perf_counter()
    state = long_state(torch, M, cfg, mesh, dev, dtype)
    torch.cuda.synchronize(dev)
    out = {"fill_s": time.perf_counter() - t0, "logits": [], "walls": [],
           "routes": [], "entries": []}
    tok_sh, pos_sh, _ = IS.decode_input_shardings(mesh, 1)
    with POL.use_policy(POL.sp_policy(mesh)), implicit_replication(), \
            torch.no_grad(), SelectTimer(torch, M) as timer, \
            (ChosenIds(torch) if chosen is None
             else PinnedChosen(torch, chosen)) as rec:
        for i in range(LONG_STEPS):
            rec.keep_scores = i == 0
            widx = LONG_SLOTS - LONG_STEPS + i
            tok = SH.distribute(feed[i], mesh, tok_sh.spec)
            pos = SH.distribute(torch.full((1, 1), widx, device=dev), mesh,
                                pos_sh.spec)
            routes = []
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            lg, state = M.decode_step(
                params, cfg, state, tok, pos, widx, ops=ops, routes=routes,
                pinned=None if pinned is None else pinned[i])
            torch.cuda.synchronize(dev)
            out["walls"].append(time.perf_counter() - t0)
            out["logits"].append(lg.full_tensor())
            out["routes"].append([r.full_tensor() for r in routes])
            out["entries"].append(written_entries(torch, state, widx))
    del state
    torch.cuda.empty_cache()
    out.update(calls=rec.calls, parts=timer.per_step(LONG_STEPS))
    return out


def _unsharded_choices(torch, cfg, dev, ref):
    """Rank 0's unsharded run's (ref; None elsewhere) MoE routes and chosen
    ids on every rank: (pinned, one list of (1, k) routes a step, as
    decode_step takes them; chosen, one (1, LONG_K) a layer call, as
    PinnedChosen takes them)."""
    import torch.distributed as dist
    n_moe = cfg.n_layers - cfg.first_k_dense
    routes = torch.zeros((LONG_STEPS, n_moe, 1, cfg.moe.top_k),
                         dtype=torch.long, device=dev)
    ids = torch.zeros((LONG_STEPS * cfg.n_layers, 1, LONG_K),
                      dtype=torch.long, device=dev)
    if ref is not None:
        routes.copy_(torch.stack([torch.stack(r) for r in ref["routes"]]))
        ids.copy_(torch.stack(ref["ids"]))
    dist.broadcast(routes, 0)
    dist.broadcast(ids, 0)
    return [list(step) for step in routes], list(ids)


def long_overlap(torch, calls, ref_ids):
    """The chosen sets' overlap with the unsharded run's, by step and
    layer: the share of each call's ids among the unsharded call's."""
    n_layers = len(ref_ids) // LONG_STEPS
    return [[float(torch.isin(calls[i * n_layers + li]["ids"],
                              ref_ids[i * n_layers + li]).float().mean())
             for li in range(n_layers)] for i in range(LONG_STEPS)]


def long_errors(torch, run, ref):
    """Logits max|err| by step, within SERVE_TOL by step, top-1 equal by
    step; the written entries' max|err| by step and layer."""
    lg = list(zip(run["logits"], ref["logits"]))
    return {"logits_max_abs_diff": [max_err(torch, g.float(), w.float())
                                    for g, w in lg],
            "logits_within": [within(torch, g.double(), w.double(),
                                     *SERVE_TOL) for g, w in lg],
            "top1_equal": [bool((g.argmax(-1) == w.argmax(-1)).all())
                           for g, w in lg],
            "entry_err_by_step_layer": [
                [max_err(torch, a.float(), b.float()) for a, b in zip(e, f)]
                for e, f in zip(run["entries"], ref["entries"])]}


def long_decode_bf16(torch, dev, cfg, shape, params):
    """(c3): long_500k's decode of V2-Lite as published in bf16 on a (1, n)
    mesh with KERNELS, on (c2)'s sharded parameters: one row, LONG_SLOTS
    slots drawn on the card (long_cache), selection_k LONG_K, LONG_STEPS
    steps at the last slots fed card 0's unsharded greedy tokens. Each
    kernel's first call on each card held against its plain version; the
    first step's chosen ids, every layer, against top_k_lowest_first over
    the all-gathered scores (exact); rank 0 reports the chosen sets'
    overlap with the unsharded run by layer, logits and top-1, walls, peak
    memory by card, the selection's and the merge's share of a step. C.7's
    bf16 split: the sharded steps again and the PLAIN control, both pinned
    to the unsharded KERNELS run's routes, and the sharded steps pinned to
    its routes and chosen sets (PinnedChosen), their overlaps, logits and
    written entries beside the unpinned ones."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = dataclasses.replace(cfg, selection_k=LONG_K)
    mesh = make_mesh(shape, ("data", "model"))
    feed = torch.zeros((LONG_STEPS, 1, 1), dtype=torch.long, device=dev)
    ref = None
    if rank == 0:
        first = torch.randint(0, cfg.vocab, (1, 1), device=dev,
                              generator=torch.Generator(
                                  device=dev).manual_seed(2))
        ref = long_unsharded(torch, M, cfg, dev, first, M.KERNELS,
                             dtype=torch.bfloat16)
        feed.copy_(torch.stack(ref["fed"]))
        # the control: the same steps unsharded through the PLAIN ops,
        # where the bf16 roundings differ from KERNELS' and the mesh does
        # not enter; then pinned to the KERNELS run's routes
        control = long_unsharded(torch, M, cfg, dev, first, M.PLAIN,
                                 feed=ref["fed"], dtype=torch.bfloat16)
        pinned_control = long_unsharded(torch, M, cfg, dev, first, M.PLAIN,
                                        feed=ref["fed"], dtype=torch.bfloat16,
                                        pinned=ref["routes"])
    dist.broadcast(feed, 0)
    pins, chosen = _unsharded_choices(torch, cfg, dev, ref)
    ops, seen = first_calls(torch, M.KERNELS)
    zero, read = _launch_counters()
    zero()
    torch.cuda.reset_peak_memory_stats(dev)
    run = long_sharded(torch, M, cfg, mesh, dev, params, feed, ops,
                       dtype=torch.bfloat16)
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    held = hold_first_calls(torch, M, seen)
    del seen
    # the first step's chosen ids against the whole score vector
    calls = run["calls"]
    n_layers = len(calls) // LONG_STEPS
    offs = [None] * world
    dist.all_gather_object(offs, [c["off"] for c in calls[:n_layers]])
    exact = []
    for li, c in enumerate(calls[:n_layers]):
        got = [torch.empty_like(c["scores"]) for _ in range(world)]
        dist.all_gather(got, c["scores"].contiguous())
        whole = torch.empty((1, LONG_SLOTS), dtype=c["scores"].dtype,
                            device=dev)
        for r, part in enumerate(got):
            whole[:, offs[r][li]:offs[r][li] + part.shape[-1]] = part
        exact.append(bool(torch.equal(
            SH.top_k_lowest_first(whole, LONG_K), c["ids"])))
        del got, whole
        c.pop("scores")
    kb = [int(((c["ids"] >= c["off"]) & (c["ids"] < c["off"] + c["n"]))
              .sum()) for c in calls]
    pinned = long_sharded(torch, M, cfg, mesh, dev, params, feed, M.KERNELS,
                          dtype=torch.bfloat16, pinned=pins)
    pinned_all = long_sharded(torch, M, cfg, mesh, dev, params, feed,
                              M.KERNELS, dtype=torch.bfloat16, pinned=pins,
                              chosen=chosen)
    parts = run["parts"]
    by_rank = [None] * world
    dist.all_gather_object(by_rank, {
        "launches": launches, "peak_gib": peak, "held": held,
        "exact": exact, "kb_first_step": kb[:n_layers],
        "select_ms": parts["select"], "attend_ms": parts["attend"],
        "merge_ms": parts["merge"]})
    if rank != 0:
        return None
    errs = long_errors(torch, run, ref)
    out = {"mesh": list(shape), "layers": cfg.n_layers,
           "fill_s": run["fill_s"],
           "overlap_by_step_layer": long_overlap(torch, calls, ref["ids"]),
           "control_overlap_by_step_layer": long_overlap(
               torch, control["calls"], ref["ids"]),
           "control_logits_max_abs_diff": long_errors(
               torch, control, ref)["logits_max_abs_diff"],
           "logits_max_abs_diff": errs["logits_max_abs_diff"],
           "top1_equal": errs["top1_equal"],
           "entry_err_by_step_layer": errs["entry_err_by_step_layer"],
           "pinned": {"overlap_by_step_layer": long_overlap(
                          torch, pinned["calls"], ref["ids"]),
                      "routes_pinned": route_flips(
                          torch, sum(pinned["routes"], []),
                          sum(ref["routes"], [])) == [],
                      **long_errors(torch, pinned, ref)},
           "pinned_control": {"overlap_by_step_layer": long_overlap(
                                  torch, pinned_control["calls"], ref["ids"]),
                              **long_errors(torch, pinned_control, ref)},
           "pinned_all": {"overlap_by_step_layer": long_overlap(
                              torch, pinned_all["calls"], ref["ids"]),
                          **long_errors(torch, pinned_all, ref)},
           "walls": run["walls"], "unsharded_walls": ref["decode_s"],
           "unsharded_peak_gib": ref["peak_gib"]}
    for key in ("launches", "peak_gib", "held", "exact", "kb_first_step",
                "select_ms", "attend_ms", "merge_ms"):
        out[key] = [r[key] for r in by_rank]
    return out


def time_first_calls(torch, M, seen):
    """sparse_select's and softmax_merge's first calls in this process
    (first_calls' record) timed through its kernel wrapper and its plain version (CUDA
    events behind a spin, time_ms), beside its bound from the call's inputs
    (sparse_select's rows the kb it attends): {name: {"shapes", "ms",
    "host_ms", "plain_ms", "bound_ms", "bound_by"}}."""
    out = {}
    for name in ("sparse_select", "softmax_merge"):
        args, kw = seen[name]
        kern = lambda: getattr(M.KERNELS, name)(*args, **kw)
        plain = lambda: getattr(M.PLAIN, name)(*args, **kw)
        ms, host_ms = time_ms(torch, kern, 100)
        plain_ms, _ = time_ms(torch, plain, PLAIN_ITERS)
        if name == "sparse_select":
            q, ckv, ids, kb = args[:4]
            B, R, D = q.shape
            d_v, item = kw["d_v"], q.element_size()
            rows = ids.numel() if kb is None else int(kb.sum())
            nbytes = (item * (B * R * D + rows * D) + 4 * B * R * (d_v + 2)
                      + ids.element_size() * ids.numel() + 4 * B)
            flops = 2.0 * R * rows * (D + d_v)
        else:
            o = args[0]
            n_m, d_v = o.shape[0], o.shape[-1]
            n = o[0].numel() // d_v
            nbytes = 4 * (n_m * n * (d_v + 2) + n * (d_v + 2))
            flops = float(n_m * n * (3 * d_v + 6))
        b_ms, b_by = bound(nbytes, flops)
        out[name] = {"shapes": [list(a.shape) for a in args
                                if torch.is_tensor(a)],
                     "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by}
    return out


def chosen_differences(torch, calls, ref_calls):
    """[(step, layer, the unsharded k-th/(k+1)-th gap, [(id, its unsharded
    score less the k-th, relative to the k-th)])] where a call's chosen
    set differs from the unsharded call's (whose ChosenIds record kept its
    scores)."""
    n_layers = len(ref_calls) // LONG_STEPS
    out = []
    for c, (got, want) in enumerate(zip(calls, ref_calls)):
        a, b = got["ids"][0], want["ids"][0]
        diff = torch.cat([a[~torch.isin(a, b)], b[~torch.isin(b, a)]])
        if not diff.numel():
            continue
        s = want["scores"][0].double()
        kth = torch.topk(s, LONG_K).values[-1]
        rel = (s[diff] - kth) / kth.abs().clamp_min(1e-300)
        out.append((c // n_layers, c % n_layers, float(want["gap"][0]),
                    [(int(i), float(r)) for i, r in zip(diff, rel)]))
    return out


def long_decode_f32(torch, dev, cfg, shape):
    """(c5), C.7's check: (c3)'s long_500k decode in f32 (cfg: V2-Lite at
    full width cut in depth) on a (1, n) mesh with KERNELS, against card
    0's unsharded KERNELS run (its routes, router margins, every layer's
    chosen ids and scores, the entries it writes recorded), fed its greedy
    tokens, three times: pinned to the unsharded routes and chosen sets
    (PinnedChosen: each layer's own choice recorded and held, the
    unsharded rows attended; counted, each kernel's first call on each
    card held against its plain version at TOL, then timed at the shard's
    shapes), pinned to the routes alone, and unpinned. Rank 0 reports each
    run by step and layer: the chosen sets' overlap and each differing id's
    distance from the unsharded k-th score, the written entries' max|err|,
    the routes (an unpinned flip with its router margin), logits max|err|,
    within SERVE_TOL, top-1; the peak memory by card."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = dataclasses.replace(cfg, selection_k=LONG_K)
    mesh = make_mesh(shape, ("data", "model"))
    feed = torch.zeros((LONG_STEPS, 1, 1), dtype=torch.long, device=dev)
    ref = None
    if rank == 0:
        first = torch.randint(0, cfg.vocab, (1, 1), device=dev,
                              generator=torch.Generator(
                                  device=dev).manual_seed(2))
        ref = long_unsharded(torch, M, cfg, dev, first, M.KERNELS,
                             dtype=torch.float32)
        feed.copy_(torch.stack(ref["fed"]))
    dist.broadcast(feed, 0)
    pins, chosen = _unsharded_choices(torch, cfg, dev, ref)
    t0 = time.perf_counter()
    params = _sharded_params(torch, M, cfg, mesh, dev, torch.float32)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(int(math.prod(p.shape)) for p in params.parameters())
    ops, seen = first_calls(torch, M.KERNELS)
    zero, read = _launch_counters()
    zero()
    torch.cuda.reset_peak_memory_stats(dev)
    pinned = long_sharded(torch, M, cfg, mesh, dev, params, feed, ops,
                          dtype=torch.float32, pinned=pins, chosen=chosen)
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    held = hold_first_calls(torch, M, seen)
    timed = time_first_calls(torch, M, seen)
    del seen
    routes_only = long_sharded(torch, M, cfg, mesh, dev, params, feed,
                               M.KERNELS, dtype=torch.float32, pinned=pins)
    free = long_sharded(torch, M, cfg, mesh, dev, params, feed, M.KERNELS,
                        dtype=torch.float32)
    by_rank = [None] * world
    dist.all_gather_object(by_rank, {
        "launches": launches, "peak_gib": peak, "held": held,
        "timed": timed})
    del params
    torch.cuda.empty_cache()
    if rank != 0:
        return None
    ref_routes = sum(ref["routes"], [])

    def report(run):
        flips = route_flips(torch, sum(run["routes"], []), ref_routes,
                            ref["margins"])
        return {"overlap_by_step_layer": long_overlap(torch, run["calls"],
                                                      ref["ids"]),
                "chosen_flips": chosen_differences(torch, run["calls"],
                                                   ref["calls"]),
                "route_flips": flips, "walls": run["walls"],
                **long_errors(torch, run, ref)}
    out = {"mesh": list(shape), "layers": cfg.n_layers, "params": n_params,
           "init_s": init_s, "fill_s": pinned["fill_s"],
           "routes": len(ref_routes), "pinned": report(pinned),
           "routes_pinned": report(routes_only), "unpinned": report(free),
           "unsharded_walls": ref["decode_s"],
           "unsharded_peak_gib": ref["peak_gib"]}
    for key in ("launches", "peak_gib", "held", "timed"):
        out[key] = [r[key] for r in by_rank]
    return out


# ---------------------------------------------------------------------------
# 5e (d). the sharded train step across cards, held against card 0's
# unsharded step on the same pinned routes
# ---------------------------------------------------------------------------

# V2-Lite at full width cut to D_LAYERS (1 dense + 3 MoE) in f32 and to
# D_F64_LAYERS (1 dense + 1 MoE) in f64; D_STEPS steps of D_BATCH x D_SEQ
# tokens with AdamWConfig(), the sharded steps at D_MICRO microbatches
D_LAYERS, D_F64_LAYERS = 4, 2
D_BATCH, D_SEQ, D_STEPS, D_MICRO = 4, 512, 3, 2
# (data, model) mesh -> its unsharded twin's n_micro: the EP form
# dispatches each data shard with its own capacity, so on (2, 2) sharded
# microbatch i holds the rows of unsharded microbatches 2i and 2i + 1
D_MESHES = {(2, 2): 4, (1, 4): 2}
D_CARDS = 4
# the first step's gradients against the unsharded run's, each leaf's
# max|diff| over its max: in f64 the fault detector (a reordering is
# ~1e-16 relative, a sharding fault shows at >= 1e-6), in f32 the limit of
# the port's f32 gradients against the JAX package (tests/test_torch_train.py)
D_GRAD_RTOL = {"f32": 1e-4, "f64": 1e-9}
# the parameters after one sharded step against adamw_update applied
# unsharded to the sharded run's own first-step gradients: the optimizer's
# rtol (tests/test_torch_optim_data_ckpt.py), and 1e-6 of a step (lr) for
# an element the step takes near zero (the global norm sums in another
# order: an ulp of the clip scale, an ulp of the element's step)
ADAMW_RTOL = 1e-6


def _host(t):
    """A copy of t on the host (a copy on the CPU too: the step updates
    its parameters in place)."""
    return t.detach().to("cpu", copy=True)


def _train_params(torch, M, cfg, dev, dtype):
    """cfg's weights drawn on dev in f32 from seed 0, then every leaf in
    dtype (the router too: f64 end to end, as 5c (e)), taking
    gradients."""
    from repro_torch.models.module import trainable
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=torch.float32)
    return trainable(params.to(dtype))


def _sharded_train_params(torch, cfg, mesh, dev, dtype):
    """The weights of _train_params laid out on mesh leaf by leaf as they
    are drawn (sharding.init_sharded: bit for bit _train_params' tree
    sharded, and no card ever holds the whole model); in bf16 the
    published dtype instead, init_model's own (the router in f32)."""
    from repro_torch.distributed.sharding import init_sharded
    from repro_torch.models.module import trainable
    gen = torch.Generator(device=dev).manual_seed(0)
    if dtype == torch.bfloat16:
        return trainable(init_sharded(cfg, mesh, gen, device=dev,
                                      dtype=dtype))
    return trainable(init_sharded(cfg, mesh, gen, device=dev,
                                  dtype=torch.float32, cast=dtype))


def _train_cfgs(dtype, n_micro, **kw):
    """(AdamWConfig(), the TrainConfig of (d)'s and (e)'s steps: gradients
    accumulated in the parameters' dtype)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainConfig
    return AdamWConfig(), TrainConfig(n_micro=n_micro, accum_dtype=dtype,
                                      **kw)


def _train_batches(torch, dev, vocab, n):
    """n batches of D_BATCH x D_SEQ tokens and targets from seed 1."""
    g = torch.Generator(device=dev).manual_seed(1)
    return [{k: torch.randint(0, vocab, (D_BATCH, D_SEQ), generator=g,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "targets")} for _ in range(n)]


def _leaf_diff(torch, dev, got, want):
    """(|got - want| on dev, max|want| or 1 where want is all zeros)."""
    want = want.to(dev)
    return (got.to(dev) - want).abs(), float(want.abs().max()) or 1.0


def _leaf_rel(torch, dev, got, want) -> float:
    """max|got - want| over max|want| (over 1 where want is all zeros)."""
    diff, scale = _leaf_diff(torch, dev, got, want)
    return float(diff.max()) / scale


def train_twin(torch, M, cfg, dev, batches, n_micro, dtype, margins=False):
    """(d)'s unsharded twin on card 0: D_STEPS steps of cfg from seed 0 in
    dtype at n_micro, each recording its routes through the step's hook;
    with margins, the router margins of the first batch's microbatches
    (a forward without gradients before the first step). Returns the
    routes (each step's lists), losses, walls (host clock ending in a
    synchronize), the first batch's gradients (loss_and_grads) and the
    parameters after the last step (on the host), the peak memory."""
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import loss_and_grads, make_train_step
    torch.cuda.reset_peak_memory_stats(dev)
    params = _train_params(torch, M, cfg, dev, dtype)
    ocfg, tcfg = _train_cfgs(dtype, n_micro)
    out = {"routes": [], "losses": [], "walls": []}
    if margins:
        rows = D_BATCH // n_micro
        with torch.no_grad(), RouterMargins(torch) as rm:
            for i in range(n_micro):
                M.loss_fn(params, cfg, {k: v[i * rows:(i + 1) * rows]
                                        for k, v in batches[0].items()})
        out["margins"] = rm.margins
    _, grads = loss_and_grads(params, cfg, batches[0], tcfg)
    out["grads"] = [_host(g) for g in grads]
    del grads
    opt = adamw_init(params, ocfg)
    step = make_train_step(cfg, ocfg, tcfg)
    for b in batches:
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out["routes"].append([])
        params, opt, mets = step(params, opt, b, routes=out["routes"][-1])
        out["losses"].append(float(mets["loss"]))
        torch.cuda.synchronize(dev)
        out["walls"].append(time.perf_counter() - t)
    out["after"] = [_host(p) for p in params.parameters()]
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del params, opt, step
    return out


def _joined(torch, lists, k):
    """Lists of per-layer tensors, one a microbatch, joined k at a time
    layer by layer: those of a step whose microbatch holds k of these
    microbatches' rows."""
    return [[torch.cat([lists[i * k + h][j] for h in range(k)])
             for j in range(len(lists[0]))]
            for i in range(len(lists) // k)]


def _twin_routes(torch, cfg, dev, twin, n_twin):
    """Rank 0's twin routes (twin; None elsewhere) on every rank, each
    step's lists joined for the sharded microbatches (D_MICRO a step)."""
    import torch.distributed as dist
    n_moe = cfg.n_layers - cfg.first_k_dense
    flat = torch.zeros((D_STEPS, n_twin, n_moe, D_BATCH // n_twin * D_SEQ,
                        cfg.moe.top_k), dtype=torch.long, device=dev)
    if twin is not None:
        flat.copy_(torch.stack([torch.stack([torch.stack(lst) for lst in r])
                                for r in twin["routes"]]))
    dist.broadcast(flat, 0)
    return [_joined(torch, [list(mb) for mb in step], n_twin // D_MICRO)
            for step in flat]


class Spread:
    """Leaves of one run against another's: the worst leaf's max|diff| /
    max and its name, and the elements beyond DIST_PARAM_RTOL x their
    leaf's max over all leaves."""

    def __init__(self):
        self.rel, self.leaf, self.over = 0.0, None, 0

    def add(self, torch, dev, name, got, want):
        diff, scale = _leaf_diff(torch, dev, got, want)
        self.over += int((diff > DIST_PARAM_RTOL * scale).sum())
        if float(diff.max()) / scale >= self.rel:
            self.rel, self.leaf = float(diff.max()) / scale, name


def profiled_step(torch, fn):
    """fn() (one train step) under torch.profiler on this rank: its wall
    (host clock ending in a synchronize), the device-busy ms (the union of
    the device events' intervals; None where the profiler saw none) and
    the NCCL kernels by kind, [count, device ms]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans, nccl = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        if "nccl" in e.name.lower():
            m = re.search(r"AllGather|ReduceScatter|AllReduce|Broadcast|"
                          r"SendRecv|AllToAll|Reduce", e.name)
            c = nccl.setdefault(m.group(0) if m else e.name[:40], [0, 0.0])
            c[0] += 1
            c[1] += (b - a) / 1e3
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return {"wall_ms": wall * 1e3,
            "busy_ms": busy / 1e3 if spans else None,
            "busy_share": busy / 1e3 / (wall * 1e3) if spans else None,
            "nccl": {k: [n, round(ms, 3)] for k, (n, ms) in nccl.items()}}


def train_sharded(torch, M, cfg, mesh, dev, params, batches, *, n_micro,
                  pinned=None, first=None, last=None, profile=False):
    """Trains params (laid out on mesh, updated in place) one step a batch
    of batches: param_shardings, sp_policy, ep_axis "model", n_micro
    microbatches, AdamWConfig(), pinned to `pinned` (each step's lists) or
    not, each step recording its routes through the step's hook. The
    first step runs as train_step does (loss_and_grads, then adamw_update
    with the model's decay mask), so that first(names, grads, params),
    called on every rank after it (a gather is a collective), sees the
    gradients that AdamW took and the parameters it made of them;
    last(names, params) is called after the last step. With profile, one
    more step (the first batch, unpinned) under the profiler. Returns this
    rank's {"losses", "walls" (host clock ending in a synchronize; first's
    time not in them), "routes" (each step's lists whole, on the host),
    "peak_gib" (max_memory_allocated in a step, the memory before it
    included), "profile"}."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.optim.adamw import adamw_init, adamw_update, decay_mask
    from repro_torch.train.step import loss_and_grads, make_train_step
    shard = SH.param_shardings(params, mesh)
    ocfg, tcfg = _train_cfgs(params.embed.table.dtype, n_micro,
                             ep_axis="model")
    opt = adamw_init(params, ocfg)
    step = make_train_step(cfg, ocfg, tcfg, param_shardings=shard)
    decay = decay_mask(params)
    bs = SH.batch_sharding(mesh)
    place = lambda b: {k: SH.distribute(v, mesh, bs.spec)
                       for k, v in b.items()}
    names = [k for k, _ in params.named_parameters()]
    out = {"losses": [], "walls": [], "routes": [], "peak_gib": 0.0,
           "profile": None}
    with POL.use_policy(POL.sp_policy(mesh)), implicit_replication():
        for i, b in enumerate(batches):
            pin = None if pinned is None else pinned[i]
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            routes = []
            if i == 0 and first is not None:
                loss, grads = loss_and_grads(params, cfg, place(b), tcfg,
                                             shard, routes=routes,
                                             pinned=pin)
                params, opt, mets = adamw_update(params, grads, opt, ocfg,
                                                 decay=decay)
                mets["loss"] = loss
            else:
                params, opt, mets = step(params, opt, place(b),
                                         routes=routes, pinned=pin)
            out["losses"].append(float(mets["loss"].full_tensor()))
            torch.cuda.synchronize(dev)
            out["walls"].append(time.perf_counter() - t)
            out["peak_gib"] = max(out["peak_gib"], torch.cuda.
                                  max_memory_allocated(dev) / 2**30)
            out["routes"].append([[r.full_tensor().cpu() for r in lst]
                                  for lst in routes])
            if i == 0 and first is not None:
                first(names, grads, params)
                del grads
        if last is not None:
            last(names, params)
        if profile:
            out["profile"] = profiled_step(
                torch, lambda: step(params, opt, place(batches[0])))
    del opt, step
    torch.cuda.empty_cache()
    return out


def _flat(lists):
    return [t for lst in lists for t in lst]


class TwinHolds:
    """(d)'s first and last callbacks of train_sharded on every rank;
    rank 0 (twin: the unsharded run; None elsewhere) holds the sharded run
    against it: the first step's gradients, each leaf's max|diff| / max
    against the twin's ("grad_worst": the three worst (rel, leaf)); the
    parameters after that step against AdamW's image of those gradients
    (adamw_update applied unsharded on this card from the same weights:
    the elements beyond ADAMW_RTOL x (|image| + lr), the worst such ratio
    and its leaf); the parameters after the last step against the twin's
    (Spread)."""

    def __init__(self, torch, M, cfg, dev, dtype, twin):
        self.torch, self.M, self.cfg, self.dev = torch, M, cfg, dev
        self.dtype, self.twin, self.rep = dtype, twin, {}

    def first(self, names, grads, params):
        from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                             adamw_update, decay_mask)
        torch, dev, twin = self.torch, self.dev, self.twin
        host, rel = [], []
        for name, g, want in zip(names, grads, twin["grads"] if twin
                                 else [None] * len(names)):
            whole = g.full_tensor()       # a collective: every rank
            if twin is not None:
                host.append(_host(whole))
                rel.append((_leaf_rel(torch, dev, whole, want), name))
            del whole
        if twin is not None:
            self.rep["grad_worst"] = sorted(rel, reverse=True)[:3]
            image = _train_params(torch, self.M, self.cfg, dev, self.dtype)
            ocfg = AdamWConfig()
            adamw_update(image, [h.to(dev) for h in host],
                         adamw_init(image, ocfg), ocfg,
                         decay=decay_mask(image))
            del host
            image = list(image.parameters())
        worst, leaf, over, lr = 0.0, None, 0, AdamWConfig().lr
        for k, p in enumerate(params.parameters()):
            whole = p.detach().full_tensor()
            if twin is not None:
                want = image[k].detach()
                ratio = (whole - want).abs() / (want.abs() + lr)
                over += int((ratio > ADAMW_RTOL).sum())
                if float(ratio.max()) >= worst:
                    worst, leaf = float(ratio.max()), names[k]
                image[k] = None
            del whole
        if twin is not None:
            self.rep["one_step"] = {"rel": worst, "leaf": leaf,
                                    "over": over}
        torch.cuda.empty_cache()

    def last(self, names, params):
        after = Spread()
        for k, p in enumerate(params.parameters()):
            whole = p.detach().full_tensor()
            if self.twin is not None:
                after.add(self.torch, self.dev, names[k], whole,
                          self.twin["after"][k])
            del whole
        self.rep["after"] = vars(after)


def dist_train(torch, dev, world):
    """(d) in one rank of a NCCL group of D_CARDS: on each mesh of
    D_MESHES, card 0 runs the unsharded twin (train_twin; the other ranks
    wait), frees it and broadcasts its routes; then every rank runs the
    sharded steps pinned to them (held through TwinHolds, then one more
    step under the profiler), and in f32 also unpinned; first with V2-Lite
    at full width cut to D_LAYERS in f32, then to D_F64_LAYERS in f64, the
    sharded weights drawn leaf by leaf. The launch counters are zeroed
    before and read after. Returns rank 0's report (None elsewhere)."""
    import torch.distributed as dist
    from repro_torch.configs import deepseek_v2_lite
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.module import count_params
    rank = dist.get_rank()
    full = deepseek_v2_lite.config()
    cuts = {"f32": (dataclasses.replace(full, n_layers=D_LAYERS),
                    torch.float32),
            "f64": (dataclasses.replace(full, n_layers=D_F64_LAYERS),
                    torch.float64)}
    batches = _train_batches(torch, dev, full.vocab, D_STEPS)
    zero, read = _launch_counters()
    zero()
    runs, mine = [], []
    for shape, n_twin in D_MESHES.items():
        mesh = make_mesh(shape, ("data", "model"))
        run = {"mesh": list(shape), "twin_micro": n_twin}
        for prec, (cfg, dtype) in cuts.items():
            twin = None
            if rank == 0:
                twin = train_twin(torch, M, cfg, dev, batches, n_twin, dtype,
                                  margins=prec == "f32")
                torch.cuda.empty_cache()
            pinned = _twin_routes(torch, cfg, dev, twin, n_twin)
            holds = TwinHolds(torch, M, cfg, dev, dtype, twin)
            params = _sharded_train_params(torch, cfg, mesh, dev, dtype)
            rec = train_sharded(torch, M, cfg, mesh, dev, params, batches,
                                n_micro=D_MICRO, pinned=pinned,
                                first=holds.first, last=holds.last,
                                profile=prec == "f32")
            del params
            mine.append({"mesh": list(shape), "prec": prec,
                         "peak_gib": rec["peak_gib"],
                         "profile": rec["profile"]})
            free = None
            if prec == "f32":
                free_holds = TwinHolds(torch, M, cfg, dev, dtype, twin)
                params = _sharded_train_params(torch, cfg, mesh, dev, dtype)
                free = train_sharded(torch, M, cfg, mesh, dev, params,
                                     batches, n_micro=D_MICRO,
                                     last=free_holds.last)
                del params
            if twin is not None:
                want = [[t.cpu() for t in _flat(s)] for s in pinned]
                rep = dict(holds.rep, losses=rec["losses"],
                           walls=rec["walls"])
                rep["routes_pinned"] = all(
                    torch.equal(a, b) for got, w in
                    zip(rec["routes"], want)
                    for a, b in zip(_flat(got), w))
                run[prec] = {"unsharded": {k: twin[k] for k in (
                    "losses", "walls", "peak_gib")}, "pinned": rep}
                if free is not None:
                    n_moe = cfg.n_layers - cfg.first_k_dense
                    margins = [t.cpu() for t in _flat(_joined(
                        torch, [twin["margins"][i * n_moe:(i + 1) * n_moe]
                                for i in range(n_twin)], n_twin // D_MICRO))]
                    got = [_flat(s) for s in free["routes"]]
                    run[prec]["unpinned"] = {
                        "losses": free["losses"], "walls": free["walls"],
                        "after": free_holds.rep["after"],
                        "route_flips": route_flips(torch, got[0], want[0],
                                                   margins),
                        "flips_by_step": [len(route_flips(torch, a, b))
                                          for a, b in zip(got, want)]}
                run[prec]["layers"] = cfg.n_layers
                run[prec]["params"] = count_params(M.init_model(
                    cfg, device="meta"))
            del twin, pinned
            torch.cuda.empty_cache()
        runs.append(run)
    launches = read()
    by_rank = [None] * world
    dist.all_gather_object(by_rank, {"launches": launches, "runs": mine})
    if rank != 0:
        return None
    return {"runs": runs, "by_rank": by_rank}


def _ms(walls):
    return ", ".join(f"{w * 1e3:.1f}" for w in walls)


def _profile_line(profs):
    return "; ".join(
        f"cuda:{i} wall {q['wall_ms']:.1f} ms, busy "
        + ("not measured (no device events)" if q["busy_ms"] is None else
           f"{q['busy_ms']:.1f} ms ({100 * q['busy_share']:.1f}%)")
        + f", NCCL kernels [count, device ms] {q['nccl']}"
        for i, q in enumerate(profs))


def _first_flips(flips):
    """route_flips' list in brief: {"first": the flips of the first MoE
    call that has any, "by_call": {call: tokens whose sets differ}, "rows":
    the batch rows they lie in}."""
    by_call = {}
    for call, _, _ in flips:
        by_call[call] = by_call.get(call, 0) + 1
    return {"first": [f for f in flips if f[0] == flips[0][0]] if flips
            else [], "by_call": by_call,
            "rows": sorted({t // D_SEQ for _, t, _ in flips})}


def _flip_rule(flips):
    """Whether route flips pass (c1)'s rule: each at a near-tie (router
    margin below NEAR_TIE), at most MAX_FLIPS of them."""
    ties = [t for t in flips if t[2] is not None and t[2] < NEAR_TIE]
    return len(ties) == len(flips) and len(ties) <= MAX_FLIPS


def log_dist_train(r, wall, smi_line):
    """(d)'s lines, a mesh and precision each; fail unless, pinned to the
    twin's routes, every step's loss is within DIST_LOSS_RTOL and the
    routes each sharded step records are the pinned ones; the first
    step's gradients are within D_GRAD_RTOL x each leaf's max of the
    twin's; the parameters after that step are within ADAMW_RTOL of
    AdamW's image of those gradients; in f64 every parameter after
    D_STEPS steps is within DIST_PARAM_RTOL x its leaf's max (in f32
    printed: AdamW's step lr g / (|g| + eps) turns the last bits of a
    gradient near eps into a good part of lr, PERF.md section 2); unless
    the unpinned f32 run's first step chose the twin's expert sets but for
    at most MAX_FLIPS near-ties (router margin below NEAR_TIE); and unless
    no kernel was launched on any card."""
    launched = {k: n for x in r["by_rank"] for k, c in x["launches"].items()
                for n in c.values() if n}
    f32, f64 = r["runs"][0]["f32"], r["runs"][0]["f64"]
    log(f"[dist] (d) the sharded train step across {D_CARDS} cards: "
        f"V2-Lite at full width cut to {f32['layers']} layers "
        f"({f32['params']} parameters) in f32 and to {f64['layers']} "
        f"({f64['params']}) in f64, weights from seed 0 drawn on each card "
        f"and laid out leaf by leaf, {D_STEPS} steps of {D_BATCH} x "
        f"{D_SEQ} tokens, AdamWConfig(), gradients accumulated in the "
        f"parameters' dtype, TF32 off; on each (data, model) NCCL mesh "
        f"param_shardings, sp_policy, ep_axis model, n_micro {D_MICRO}, "
        f"against card 0's unsharded step with the same microbatch rows; "
        f"kernels launched in the steps {launched or 'none'}; part wall "
        f"{wall:.1f} s; {smi_line}")
    mine = {(tuple(x["mesh"]), x["prec"]): [] for x in r["by_rank"][0]
            ["runs"]}
    for x in r["by_rank"]:
        for y in x["runs"]:
            mine[(tuple(y["mesh"]), y["prec"])].append(y)
    bad = []
    for run in r["runs"]:
        shape = tuple(run["mesh"])
        for prec in ("f32", "f64"):
            x = run[prec]
            p, u = x["pinned"], x["unsharded"]
            rel = [abs(a - b) / abs(b) for a, b in zip(p["losses"],
                                                       u["losses"])]
            one, after = p["one_step"], p["after"]
            grad_rel = p["grad_worst"][0][0]
            ranks = mine[(shape, prec)]
            head = (f"[dist] (d) {shape} {prec}, {x['layers']} layers, "
                    f"sharded n_micro {D_MICRO} against unsharded n_micro "
                    f"{run['twin_micro']}")
            log(f"{head}, pinned to the unsharded routes: losses "
                + ", ".join(f"{a:.9f}/{b:.9f}" for a, b in zip(
                    p["losses"], u["losses"]))
                + f" (rel {max(rel):.3e}, rtol {DIST_LOSS_RTOL:g}); routes "
                f"recorded = pinned {p['routes_pinned']}; first step's "
                f"gradients, worst leaves (max|diff| / max, leaf) "
                f"{p['grad_worst']}, limit {D_GRAD_RTOL[prec]:g} x max; "
                f"after one step against adamw_update of the sharded run's "
                f"own first-step gradients (unsharded, card 0): worst "
                f"|diff| / (|image| + lr) {one['rel']:.3e} ({one['leaf']}), "
                f"{one['over']} elements beyond {ADAMW_RTOL:g}; {smi_line}")
            held = ("held" if prec == "f64" else
                    "printed, not a limit (PERF.md section 2)")
            log(f"{head}, pinned: after {D_STEPS} steps against the "
                f"unsharded run worst leaf {after['leaf']} "
                f"{after['rel']:.3e} of its max, {after['over']} elements "
                f"beyond {DIST_PARAM_RTOL:g} x max, {held}; step walls "
                f"sharded {_ms(p['walls'][:1])} ms first (loss_and_grads "
                f"and adamw_update), then {_ms(p['walls'][1:])} ms; "
                f"unsharded {_ms(u['walls'][:1])} ms first, then "
                f"{_ms(u['walls'][1:])} ms; max_memory_allocated GiB by "
                f"card {[round(y['peak_gib'], 2) for y in ranks]}, "
                f"unsharded on card 0 {u['peak_gib']:.2f}; {smi_line}")
            if max(rel) > DIST_LOSS_RTOL:
                bad.append(f"{shape} {prec} losses rel {max(rel):.3e}")
            if not p["routes_pinned"]:
                bad.append(f"{shape} {prec} routes not the pinned ones")
            if grad_rel > D_GRAD_RTOL[prec]:
                bad.append(f"{shape} {prec} first-step gradients "
                           f"{p['grad_worst']}")
            if one["over"]:
                bad.append(f"{shape} {prec} one step against AdamW's image "
                           f"{one['rel']:.3e} ({one['leaf']}), "
                           f"{one['over']} elements over")
            if prec == "f64" and (after["over"]
                                  or after["rel"] > DIST_PARAM_RTOL):
                bad.append(f"{shape} f64 parameters after {D_STEPS} steps "
                           f"{after['rel']:.3e} ({after['leaf']}), "
                           f"{after['over']} elements over")
            profs = [y["profile"] for y in ranks if y["profile"]]
            if profs:
                log(f"{head}: one more sharded step under the profiler, by "
                    f"card: {_profile_line(profs)}; {smi_line}")
            if "unpinned" not in x:
                continue
            f = x["unpinned"]
            log(f"{head}, unpinned: first step's expert sets "
                + ("equal" if not f["route_flips"] else
                   f"differ at (call, token, router margin) "
                   f"{f['route_flips']}")
                + f"; tokens whose sets differ by step {f['flips_by_step']}"
                f" (later steps follow the flips); losses " + ", ".join(
                    f"{a:.9f}/{b:.9f}" for a, b in zip(f["losses"],
                                                       u["losses"]))
                + f"; after {D_STEPS} steps worst leaf "
                f"{f['after']['leaf']} {f['after']['rel']:.3e} of its max, "
                f"{f['after']['over']} elements beyond {DIST_PARAM_RTOL:g};"
                f" step walls {_ms(f['walls'])} ms; {smi_line}")
            if not _flip_rule(f["route_flips"]):
                bad.append(f"{shape} unpinned: first-step expert sets differ "
                           f"beyond {MAX_FLIPS} near-ties (margin < "
                           f"{NEAR_TIE:g}): {f['route_flips']}")
    if launched:
        bad.append(f"kernels launched in the train steps: {launched}")
    if bad:
        fail("(5e) (d) " + "; ".join(bad))


# ---------------------------------------------------------------------------
# 5e (e). V2-Lite as published trained across four cards: the f32 step on
# (2, 2) held against (1, 4), and the published dtype on (1, 4)
# ---------------------------------------------------------------------------

# (e1): f32 at E_F32_LAYERS of V2-Lite's 27 layers, D_STEPS steps of (d)'s
# batches; (1, 4) at n_micro 2, (2, 2) at n_micro 1, so that each capacity
# group of the expert-parallel MoE holds the same rows on both meshes (a
# data shard's rows, or a microbatch's where the data axis is 1): the
# EP form drops the pairs past each group's capacity
E_F32_LAYERS = 27
E_MICRO = {(1, 4): 2, (2, 2): 1}
# (e2): the published dtype (bf16 weights and gradients, f32 moments) at
# 27 layers on (1, 4), E_BF16_STEPS steps on the first batch repeated
E_BF16_STEPS = 6
# (e1)'s gradients held elementwise (D_GRAD_RTOL["f32"] x each leaf's max):
# the embedding (which is also the head), the final norm and every leaf
# of layers 0, 1 and the last (V2-Lite's first layer is dense)
E_HELD_LEAVES = ("embed.", "final_norm.", "dense_blocks.0.", "blocks.0.",
                 f"blocks.{E_F32_LAYERS - 2}.")
# (e1)'s global and per-leaf gradient norms, relative
E_NORM_RTOL = 1e-4


def state_bytes(params, n_micro, accum_dtype):
    """This card's reckoned training state, from its local shards:
    (weights + gradients (the parameters' dtypes) + AdamW's two f32
    moments, the f32 accumulators where n_micro > 1) in bytes."""
    base = acc = 0
    for p in params.parameters():
        n = p.to_local().numel()
        base += n * (2 * p.element_size() + 8)
        acc += n * accum_dtype.itemsize if n_micro > 1 else 0
    return base, acc


def forward_routes(torch, M, cfg, params, mesh, batch, n_micro,
                   margins=False):
    """A forward without gradients of batch's n_micro microbatches on mesh
    (sp_policy, the EP MoE), as the first step's forward computes them:
    (one list of whole (T, k) routes a microbatch, on the host; with
    margins, each MoE call's router margins (RouterMargins) on this
    rank)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    rows = D_BATCH // n_micro
    spec = SH.batch_sharding(mesh).spec
    out = []
    pol = POL.sp_policy(mesh).for_batch(rows)
    with torch.no_grad(), POL.use_policy(pol), implicit_replication(), \
            RouterMargins(torch) as rm:
        for i in range(n_micro):
            routes = []
            M.loss_fn(params, cfg, {k: SH.distribute(
                v[i * rows:(i + 1) * rows], mesh, spec)
                for k, v in batch.items()}, routes=routes, ep_axis="model")
            out.append([r.full_tensor().cpu() for r in routes])
    return out, ([m.cpu() for m in rm.margins] if margins else None)


class GradProbe:
    """(e1)'s first callback of train_sharded: the global gradient norm
    and each leaf's (every rank), and the leaves whose names start with
    one of E_HELD_LEAVES gathered whole: kept on the host on rank 0 or,
    given ref (the other mesh's probe), held there against ref's, each
    leaf's max|diff| / max."""

    def __init__(self, torch, dev, ref=None):
        self.torch, self.dev, self.ref = torch, dev, ref
        self.norms, self.kept, self.rel = {}, {}, {}
        self.global_norm = None

    def __call__(self, names, grads, params):
        import torch.distributed as dist
        from repro_torch.optim.adamw import global_norm
        rank0 = dist.get_rank() == 0
        self.global_norm = float(global_norm(grads).full_tensor())
        for name, g in zip(names, grads):
            self.norms[name] = float(global_norm([g]).full_tensor())
            if not name.startswith(E_HELD_LEAVES):
                continue
            whole = g.full_tensor()
            if rank0 and self.ref is None:
                self.kept[name] = _host(whole)
            elif rank0:
                self.rel[name] = _leaf_rel(self.torch, self.dev, whole,
                                           self.ref.kept[name])
            del whole
        self.torch.cuda.empty_cache()


def _finite_shards(torch, params) -> bool:
    """Whether every local shard of params is finite on this rank."""
    return all(bool(torch.isfinite(p.detach().to_local()).all())
               for p in params.parameters())


def dist_train_full(torch, dev, world):
    """(e) in one rank of a NCCL group of D_CARDS. (e1) V2-Lite at full
    width and E_F32_LAYERS layers in f32: on (1, 4) (its routes recorded,
    the first batch's router margins from a forward without gradients),
    then on (2, 2) pinned to those routes (after an unpinned forward of
    the first batch, whose routes are compared), D_STEPS steps each
    (GradProbe on the first); (e2) V2-Lite as published in bf16 weights
    with f32 moments on (1, 4), E_BF16_STEPS steps on the first batch.
    Each run's weights from seed 0, drawn and laid out leaf by leaf
    (_sharded_train_params); one more step under the profiler; the launch
    counters zeroed before and read after. Returns rank 0's report (None
    elsewhere)."""
    import torch.distributed as dist
    from repro_torch.configs import deepseek_v2_lite
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.module import count_params
    rank = dist.get_rank()
    full = deepseek_v2_lite.config()
    cut = dataclasses.replace(full, n_layers=E_F32_LAYERS)
    batches = _train_batches(torch, dev, full.vocab, D_STEPS)
    meshes = {s: make_mesh(s, ("data", "model")) for s in E_MICRO}
    zero, read = _launch_counters()
    zero()
    mine = {}

    def run(key, shape, cfg, dtype, steps, **kw):
        t = time.perf_counter()
        params = _sharded_train_params(torch, cfg, meshes[shape], dev, dtype)
        init_s = time.perf_counter() - t
        n_micro = kw.pop("n_micro", E_MICRO[shape])
        before = kw.pop("before", None)
        pre = before(params) if before else None
        rec = train_sharded(torch, M, cfg, meshes[shape], dev, params, steps,
                            n_micro=n_micro, profile=True, **kw)
        base, acc = state_bytes(params, n_micro, torch.float32)
        rec.update(init_s=init_s, state_gib=base / 2**30,
                   accum_gib=acc / 2**30, finite=_finite_shards(torch,
                                                                params))
        del params
        torch.cuda.empty_cache()
        mine[key] = {k: rec[k] for k in ("walls", "peak_gib", "profile",
                                         "init_s", "state_gib", "accum_gib",
                                         "finite")}
        return rec, pre

    # (e1) on (1, 4)
    probe14 = GradProbe(torch, dev)
    r14, (fwd14, margins) = run(
        "e1 (1, 4)", (1, 4), cut, torch.float32, batches, first=probe14,
        before=lambda p: forward_routes(torch, M, cut, p, meshes[(1, 4)],
                                        batches[0], E_MICRO[(1, 4)],
                                        margins=True))
    k = E_MICRO[(1, 4)] // E_MICRO[(2, 2)]
    pinned = [_joined(torch, step, k) for step in r14["routes"]]
    # (e1) on (2, 2), pinned to them
    probe22 = GradProbe(torch, dev, ref=probe14)
    r22, (fwd22, _) = run(
        "e1 (2, 2)", (2, 2), cut, torch.float32, batches, first=probe22,
        pinned=pinned,
        before=lambda p: forward_routes(torch, M, cut, p, meshes[(2, 2)],
                                        batches[0], E_MICRO[(2, 2)]))
    probe14.kept.clear()
    # (e2) the published dtype on (1, 4)
    r2, _ = run("e2", (1, 4), full, torch.bfloat16,
                [batches[0]] * E_BF16_STEPS, n_micro=1)
    launches = read()
    by_rank = [None] * world
    dist.all_gather_object(by_rank, {"launches": launches, "runs": mine})
    if rank != 0:
        return None
    n_moe = cut.n_layers - cut.first_k_dense
    margins = _flat(_joined(torch, [margins[i * n_moe:(i + 1) * n_moe]
                                    for i in range(E_MICRO[(1, 4)])], k))
    want = [_flat(s) for s in pinned]
    rel = lambda a, b: abs(a - b) / abs(b) if b else abs(a)
    e1 = {
        "layers": cut.n_layers,
        "params": count_params(M.init_model(cut, device="meta")),
        "losses": {"(1, 4)": r14["losses"], "(2, 2)": r22["losses"]},
        "routes_pinned": all(torch.equal(a, b) for got, w in zip(
            r22["routes"], want) for a, b in zip(_flat(got), w)),
        "forward_is_first_step": all(torch.equal(a, b) for a, b in zip(
            _flat(fwd14), _flat(r14["routes"][0]))),
        "route_flips": _first_flips(route_flips(torch, _flat(fwd22), want[0],
                                                margins)),
        "global_norm": [probe22.global_norm, probe14.global_norm],
        "norm_worst": sorted(((rel(probe22.norms[n], v), n) for n, v in
                              probe14.norms.items()), reverse=True)[:3],
        "grad_worst": sorted(((r, n) for n, r in probe22.rel.items()),
                             reverse=True)[:3],
        "grad_leaves": len(probe22.rel)}
    e2 = {"layers": full.n_layers,
          "params": count_params(M.init_model(full, device="meta")),
          "losses": r2["losses"]}
    return {"e1": e1, "e2": e2, "by_rank": by_rank}


def log_dist_train_full(r, wall, smi_line):
    """(e)'s lines; fail unless in (e1) (2, 2)'s losses are within
    DIST_LOSS_RTOL of (1, 4)'s, the routes (2, 2) records are the pinned
    ones, the first step's global gradient norm and every leaf's are
    within E_NORM_RTOL and the held leaves' gradients within
    D_GRAD_RTOL["f32"] x their max, and the first MoE call in which the
    unpinned forward's expert sets differ from (1, 4)'s differs at no more
    than MAX_FLIPS near-ties (the later calls carry the change: PERF.md
    section 2); unless in (e2)
    every loss and every card's final parameters are finite and the last
    loss is below the first; and unless no kernel was launched."""
    launched = {k: n for x in r["by_rank"] for k, c in x["launches"].items()
                for n in c.values() if n}
    e1, e2 = r["e1"], r["e2"]
    by = {key: [x["runs"][key] for x in r["by_rank"]]
          for key in r["by_rank"][0]["runs"]}
    log(f"[dist] (e) V2-Lite trained across {D_CARDS} cards (a NCCL group "
        f"of its own), weights from seed 0 drawn and laid out leaf by leaf "
        f"on each card, {D_BATCH} x {D_SEQ} tokens a step (seed 1), "
        f"AdamWConfig(), TF32 off, param_shardings, sp_policy, ep_axis "
        f"model: (e1) f32 at full width and {e1['layers']} layers "
        f"({e1['params']} parameters), {D_STEPS} steps on (1, 4) at n_micro "
        f"{E_MICRO[(1, 4)]} and on (2, 2) at n_micro {E_MICRO[(2, 2)]} "
        f"(each EP capacity group the same rows); (e2) as published, "
        f"{e2['layers']} layers ({e2['params']} parameters) in bf16 "
        f"weights and gradients with f32 moments on (1, 4), "
        f"{E_BF16_STEPS} steps on one batch; kernels launched in the steps "
        f"{launched or 'none'}; part wall {wall:.1f} s; {smi_line}")
    l14, l22 = e1["losses"]["(1, 4)"], e1["losses"]["(2, 2)"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l22, l14))
    gn22, gn14 = e1["global_norm"]
    gn_rel = abs(gn22 - gn14) / gn14
    grad_rel = e1["grad_worst"][0][0]
    log(f"[dist] (e1) (2, 2) pinned to the routes (1, 4) recorded, "
        f"{e1['layers']} layers in f32: losses " + ", ".join(
            f"{a:.9f}/{b:.9f}" for a, b in zip(l22, l14))
        + f" (rel {loss_rel:.3e}, rtol {DIST_LOSS_RTOL:g}); routes recorded "
        f"= pinned {e1['routes_pinned']}; first step's global gradient norm "
        f"{gn22:.9g}/{gn14:.9g} (rel {gn_rel:.3e}, rtol {E_NORM_RTOL:g}), "
        f"worst leaf norms (rel, leaf) {e1['norm_worst']} (rtol "
        f"{E_NORM_RTOL:g}); the gradients of {e1['grad_leaves']} leaves (the "
        f"embedding and head, the final norm, layers 0, 1 and "
        f"{e1['layers'] - 1}), worst "
        f"(max|diff| / max, leaf) {e1['grad_worst']}, limit "
        f"{D_GRAD_RTOL['f32']:g} x max; (1, 4)'s forward without gradients "
        f"chose its first step's routes {e1['forward_is_first_step']}; "
        f"{smi_line}")
    flips = e1["route_flips"]
    first = flips["first"]
    log(f"[dist] (e1) (2, 2) unpinned: the first batch's expert sets (a "
        f"forward without gradients from the same weights) against (1, 4)'s "
        f"first step " + ("equal" if not first else
                          f"first differ at (call, token, router margin) "
                          f"{first}; tokens whose sets differ by MoE call "
                          f"{flips['by_call']} in rows {flips['rows']}")
        + f" (let pass: at most {MAX_FLIPS} in the first call that differs, "
        f"each at a margin below {NEAR_TIE:g}; the later calls follow: a "
        f"token whose experts change moves its row's later tokens through "
        f"attention); {smi_line}")
    for key in ("e1 (1, 4)", "e1 (2, 2)", "e2"):
        ys = by[key]
        log(f"[dist] ({key}) by card: step walls ms "
            + "; ".join(f"cuda:{i} {_ms(y['walls'])}"
                        for i, y in enumerate(ys))
            + f"; weights drawn and laid out in "
            f"{[round(y['init_s'], 1) for y in ys]} s; max_memory_allocated "
            f"GiB {[round(y['peak_gib'], 2) for y in ys]} against the "
            f"reckoned state of the card's local shards (weights + gradients"
            f" + f32 moments) {[round(y['state_gib'], 2) for y in ys]} GiB"
            + (f" + f32 accumulators {[round(y['accum_gib'], 2) for y in ys]}"
               f" GiB" if any(y["accum_gib"] for y in ys) else "")
            + f"; one more step under the profiler: "
            f"{_profile_line([y['profile'] for y in ys])}; {smi_line}")
    finite = [y["finite"] for y in by["e2"]]
    loss_ok = all(math.isfinite(x) for x in e2["losses"])
    log(f"[dist] (e2) losses " + ", ".join(f"{x:.6f}" for x in e2["losses"])
        + f" (reported; held: finite {loss_ok}, last below first "
        f"{e2['losses'][-1] < e2['losses'][0]}); final parameters finite by "
        f"card {finite}; {smi_line}")
    bad = []
    if loss_rel > DIST_LOSS_RTOL:
        bad.append(f"(e1) losses rel {loss_rel:.3e}")
    if not e1["routes_pinned"]:
        bad.append("(e1) routes not the pinned ones")
    if gn_rel > E_NORM_RTOL or e1["norm_worst"][0][0] > E_NORM_RTOL:
        bad.append(f"(e1) gradient norms {gn_rel:.3e}, {e1['norm_worst']}")
    if grad_rel > D_GRAD_RTOL["f32"]:
        bad.append(f"(e1) gradients {e1['grad_worst']}")
    if not _flip_rule(first):
        bad.append(f"(e1) unpinned expert sets first differ beyond "
                   f"{MAX_FLIPS} near-ties (margin < {NEAR_TIE:g}): {first}")
    finite_by = {k: [y["finite"] for y in v] for k, v in by.items()}
    if not (loss_ok and all(all(v) for v in finite_by.values())):
        bad.append(f"(e) not finite: losses {e2['losses']}, parameters by "
                   f"card {finite_by}")
    if not e2["losses"][-1] < e2["losses"][0]:
        bad.append(f"(e2) the last loss is not below the first: "
                   f"{e2['losses']}")
    if launched:
        bad.append(f"kernels launched in the train steps: {launched}")
    if bad:
        fail("(5e) (e) " + "; ".join(bad))


# (f): the training substrate across D_CARDS cards. V2-Lite at full width
# cut to F_LAYERS (1 dense + 1 MoE) in f32, D_BATCH x D_SEQ tokens a step
# from a SyntheticPipeline (seed 1) at V2-Lite's vocab. (f1) train_loop on
# (1, 4) at E_MICRO's n_micro, F_STEPS steps, a snapshot every
# F_CKPT_EVERY, a fault on every rank at F_FAULT_AT, against the same loop
# unbroken; (f2) a new job on (2, 2) with weights from F_ELASTIC_SEED warm-
# starts from (f1)'s snapshots up to F_FROM; (f3) the compressed
# all-reduce on a 4-rank "pod" group; (f4) the collective matmul on a
# 4-rank "tp" ring; (f5) one step's collectives against step_costs'
# count
F_LAYERS = D_F64_LAYERS
F_STEPS, F_CKPT_EVERY, F_FAULT_AT, F_FROM = 6, 2, 3, 4
F_ELASTIC_SEED = 7
F_KEEP = 2             # snapshots kept a directory (10.5 GB each)
# (f3): the reference's toy regression (tests/test_torch_distributed.py)
F_DP_STEPS, F_DP_LOSS, F_DP_W = 300, 1e-3, 0.05
F_TIME_ITERS = 3       # timed calls of the gradient-sized reductions
# (f4): x is D_BATCH x D_SEQ tokens x d_model, w (d_model, n) over the ring
F_CM_COLS = {"expert up": 4 * 1408, "dense mlp": 10944}
F_CM_REPS = 20
# (f5): counts by kind equal, result bytes by kind within this share
F_BYTES_RTOL = 0.01
# the profiler's NCCL kernel kinds (profiled_step), by collective
F_KERNEL_KIND = {"all_gather_into_tensor": "AllGather",
                 "reduce_scatter_tensor": "ReduceScatter",
                 "all_reduce": "AllReduce", "all_to_all_single": "SendRecv"}


def _rss_bytes() -> int:
    """This process's resident set size, from /proc/self/status."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_ckpt(directory, keep):
    """A CheckpointManager that notes each save's host RSS growth (this
    rank, just after save() returns: the host copies it keeps for the
    write) and gather wall, each write's wall (save() returning to the
    rename; its _gc runs last in the write) and each restore's wall."""
    from repro_torch.checkpoint.manager import CheckpointManager

    class Timed(CheckpointManager):
        def __init__(self):
            super().__init__(directory, keep=keep)
            self.saves, self.restores = [], []

        def save(self, step, tree, blocking=False):
            self.wait()
            rss, t = _rss_bytes(), time.perf_counter()
            super().save(step, tree, blocking)
            now = time.perf_counter()
            self.saves.append({"step": step, "gather_s": now - t,
                               "rss_growth": _rss_bytes() - rss,
                               "returned": now})

        def _gc(self):
            if self.saves:
                self.saves[-1]["write_s"] = (time.perf_counter()
                                             - self.saves[-1]["returned"])
            super()._gc()

        def restore(self, step, target_tree, shardings=None):
            t = time.perf_counter()
            out = super().restore(step, target_tree, shardings)
            self.restores.append({"step": step,
                                  "wall_s": time.perf_counter() - t})
            return out

    return Timed()


def _loop_step(torch, cfg, mesh, params, n_micro, routes, losses,
               pinned=None, first=None):
    """A sharded train step as train_loop calls it (params, opt, batch):
    the batch laid out with batch_sharding, then train_step
    (param_shardings, ep_axis "model", AdamWConfig()) under sp_policy and
    implicit_replication. Keyed by i, the optimizer's step count before
    the step: routes[i] gets its routes (whole, on the host), losses[i]
    its loss (whole) and wall (host clock ending in a synchronize);
    pinned[i], where given, pins it; first(params, opt) runs once, before
    the first step."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.train.step import make_train_step
    ocfg, tcfg = _train_cfgs(torch.float32, n_micro, ep_axis="model")
    step = make_train_step(cfg, ocfg, tcfg,
                           param_shardings=SH.param_shardings(params, mesh))
    spec = SH.batch_sharding(mesh).spec
    dev = params.embed.table.to_local().device
    pending = [first]

    def train_step(params, opt, batch):
        i = int(opt["step"])
        if pending[0] is not None:
            pending.pop()(params, opt)
            pending.append(None)
        _sync(torch, dev)
        t = time.perf_counter()
        own = []
        with POL.use_policy(POL.sp_policy(mesh)), implicit_replication():
            placed = {k: SH.distribute(v, mesh, spec)
                      for k, v in batch.items()}
            out = step(params, opt, placed, routes=own,
                       pinned=None if pinned is None else pinned[i])
        loss = float(out[2]["loss"].full_tensor())
        _sync(torch, dev)
        losses[i] = (loss, time.perf_counter() - t)
        routes[i] = [[r.full_tensor().cpu() for r in lst] for lst in own]
        return out
    return train_step


def _loop_tree(params, opt):
    return {"params": params, "opt": opt}


def _same_state(torch, dev, a, b) -> dict:
    """Two runs' trees ({"params", "opt"}) gathered leaf by leaf (a
    collective): on rank 0 the leaves that differ in any bit, and the
    leaf count."""
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import _flatten
    la, lb = _flatten(a), _flatten(b)
    differ = []
    for i, (x, y) in enumerate(zip(la, lb)):
        wx, wy = _whole_leaf(x), _whole_leaf(y)
        if dist.get_rank() == 0 and not torch.equal(wx, wy.to(wx.device)):
            differ.append(i)
        del wx, wy
    return {"leaves": len(la), "differ": differ}


def _whole_leaf(t):
    from torch.distributed.tensor import DTensor
    t = t.detach()
    return t.full_tensor() if isinstance(t, DTensor) else t


def _snapshot_equal(torch, tree, path) -> dict:
    """tree's leaves gathered (a collective) against a snapshot's on disk,
    bit for bit, on rank 0: {"leaves", "differ"}."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import _DTYPES, _flatten
    leaves = _flatten(tree)
    differ = []
    man = json.loads((path / "manifest.json").read_text())
    data = np.load(path / "leaves.npz") if dist.get_rank() == 0 else None
    for i, t in enumerate(leaves):
        whole = _whole_leaf(t)
        if data is not None:
            want = torch.from_numpy(data[f"leaf_{i}"]).view(
                _DTYPES[man["dtypes"][i]]).reshape(man["shapes"][i])
            if whole.dtype != want.dtype or not torch.equal(
                    whole.cpu(), want):
                differ.append(i)
        del whole
    if data is not None:
        data.close()
    return {"leaves": len(leaves), "differ": differ}


def _placed_as(params, opt, shard, mesh) -> bool:
    """Whether every parameter and moment lies on mesh with its
    param_shardings placements."""
    names = [k for k, _ in params.named_parameters()]
    ps = list(params.parameters())
    return all(
        t.device_mesh == mesh
        and tuple(t.placements) == tuple(shard[n].placements)
        for n, p, m, v in zip(names, ps, opt["m"], opt["v"])
        for t in (p, m, v))


def _after_spread(torch, dev, params, ref) -> dict:
    """params against ref (another run's, any mesh), leaf by leaf gathered
    (a collective): Spread's worst leaf and the elements beyond
    DIST_PARAM_RTOL x their leaf's max (rank 0)."""
    import torch.distributed as dist
    spread = Spread()
    for (name, p), q in zip(params.named_parameters(), ref.parameters()):
        a, b = _whole_leaf(p), _whole_leaf(q)
        if dist.get_rank() == 0:
            spread.add(torch, dev, name, a, b)
        del a, b
    return vars(spread)


def elastic_loop(torch, dev, world, cfg, root):
    """(f1) and (f2) in one rank, their snapshots under root. Returns
    this rank's report (rank 0's holds the comparisons)."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.loop import LoopConfig, train_loop
    rank = dist.get_rank()
    pipe = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=D_SEQ,
                                        global_batch=D_BATCH, seed=1),
                             device=dev)
    mesh14 = make_mesh((1, 4), ("data", "model"))
    loop_cfg = LoopConfig(total_steps=F_STEPS, ckpt_every=F_CKPT_EVERY,
                          log_every=1)
    out = {}

    def f1(name, fault_hook=None):
        params = _sharded_train_params(torch, cfg, mesh14, dev,
                                       torch.float32)
        opt = adamw_init(params, AdamWConfig())
        routes, losses = {}, {}
        step = _loop_step(torch, cfg, mesh14, params, E_MICRO[(1, 4)],
                          routes, losses)
        ckpt = _timed_ckpt(root / name, F_KEEP)
        t = time.perf_counter()
        params, opt, log_ = train_loop(step, params, opt, pipe, ckpt,
                                       loop_cfg, fault_hook=fault_hook)
        wall = time.perf_counter() - t
        out[name] = {"log": [{k: v for k, v in e.items() if k != "t"}
                             for e in log_],
                     "wall_s": wall, "saves": ckpt.saves,
                     "restores": ckpt.restores,
                     "step_walls": {i: w for i, (_, w) in losses.items()},
                     "whole_losses": {i: x for i, (x, _) in losses.items()},
                     "on_disk": ckpt.all_steps()}
        return params, opt, routes

    p_u, o_u, routes_u = f1("unbroken")
    fired = []

    def fault(step):
        if step == F_FAULT_AT and not fired:
            fired.append(step)
            raise RuntimeError(f"induced fault at step {step}")

    p_b, o_b, _ = f1("broken", fault)
    out["replay"] = _same_state(torch, dev, _loop_tree(p_u, o_u),
                                _loop_tree(p_b, o_b))
    del p_b, o_b
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (f2): a directory holding the broken run's snapshots up to F_FROM
    elastic = root / "elastic"
    if rank == 0:
        elastic.mkdir()
        for s in out["broken"]["on_disk"]:
            if s <= F_FROM:
                src, dst = root / "broken" / f"step_{s:08d}", \
                    elastic / f"step_{s:08d}"
                dst.mkdir()
                for f in src.iterdir():       # hard links: no copy
                    os.link(f, dst / f.name)
    dist.barrier()
    mesh22 = make_mesh((2, 2), ("data", "model"))
    gen = torch.Generator(device=dev).manual_seed(F_ELASTIC_SEED)
    params = SH.init_sharded(cfg, mesh22, gen, device=dev,
                             dtype=torch.float32)
    from repro_torch.models.module import trainable
    params = trainable(params)
    shard22 = SH.param_shardings(params, mesh22)
    opt = adamw_init(params, AdamWConfig())
    k = E_MICRO[(1, 4)] // E_MICRO[(2, 2)]
    pinned = {i: [[t.to(dev) for t in lst] for lst in _joined(torch, r, k)]
              for i, r in routes_u.items()}
    routes_e, losses_e, held = {}, {}, {}

    def first(params, opt):
        held["placed"] = _placed_as(params, opt, shard22, mesh22)
        held["restored"] = _snapshot_equal(
            torch, _loop_tree(params, opt),
            root / "unbroken" / f"step_{F_FROM:08d}")

    step = _loop_step(torch, cfg, mesh22, params, E_MICRO[(2, 2)],
                      routes_e, losses_e, pinned=pinned, first=first)
    ckpt = _timed_ckpt(elastic, F_KEEP)
    t = time.perf_counter()
    params, opt, log_e = train_loop(
        step, params, opt, pipe, ckpt,
        LoopConfig(total_steps=F_STEPS, ckpt_every=F_STEPS + 1,
                   log_every=1))
    out["elastic"] = {
        "log": [{k: v for k, v in e.items() if k != "t"} for e in log_e],
        "wall_s": time.perf_counter() - t, "restores": ckpt.restores,
        "step_walls": {i: w for i, (_, w) in losses_e.items()},
        "routes_pinned": all(
            torch.equal(a, b.cpu()) for i, r in routes_e.items()
            for a, b in zip(_flat(r), _flat(pinned[i]))),
        "routes_steps": sorted(routes_e), **held,
        "after": _after_spread(torch, dev, params, p_u)}
    del params, opt, p_u, o_u
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def compressed_toy(torch, dev, group):
    """(f3) the reference's toy regression, F_DP_STEPS steps of compressed
    and of full-precision DP over group (8 rows a rank): {"loss": {mode:
    final loss}, "w_diff", "payload_ok" (every SUM an int32 payload of
    int8 values), "scale_max_f32" (every MAX an f32 scalar)}."""
    import torch.distributed as dist
    from repro_torch.optim import compress
    n, r = dist.get_world_size(group), dist.get_rank(group)
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn(8 * n, 16, generator=g, device=dev)
    y = X @ torch.randn(16, 1, generator=g, device=dev)
    xb, yb = X[r * 8:(r + 1) * 8], y[r * 8:(r + 1) * 8]
    seen, real = [], dist.all_reduce

    def spy(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        seen.append((t.dtype, op, t.numel(),
                     None if t.is_floating_point() else
                     int(t.abs().max())))
        return real(t, op=op, group=group, async_op=async_op)

    loss = lambda w, xx, yy: torch.mean(torch.square(xx @ w - yy))
    ws, losses = {}, {}
    for mode in (False, True):
        w, e = torch.zeros(16, 1, device=dev), torch.zeros(16, 1, device=dev)
        dist.all_reduce = spy if mode else real
        try:
            for _ in range(F_DP_STEPS):
                wg = w.clone().requires_grad_(True)
                (gr,) = torch.autograd.grad(loss(wg, xb, yb), wg)
                if mode:
                    (gr,), (e,) = compress.compressed_psum_with_feedback(
                        [gr], [e], group)
                else:
                    dist.all_reduce(gr, group=group)
                    gr = gr / n
                w = w - 0.05 * gr
        finally:
            dist.all_reduce = real
        ws[mode], losses[mode] = w, float(loss(w, X, y))
    sums = [s for s in seen if s[1] == dist.ReduceOp.SUM]
    maxes = [s for s in seen if s[1] == dist.ReduceOp.MAX]
    return {"loss": {"compressed": losses[True], "full": losses[False]},
            "w_diff": float((ws[True] - ws[False]).abs().max()),
            "payload_ok": len(sums) == F_DP_STEPS and all(
                d == torch.int32 and m <= 127 for d, _, _, m in sums),
            "scale_max_f32": len(maxes) == F_DP_STEPS and all(
                d == torch.float32 and k == 1 for d, _, k, _ in maxes)}


def compressed_at_size(torch, dev, group, shapes):
    """(f3) at a gradient's size: one f32 tensor a shape drawn from seed
    (rank), compressed once with zero error (the whole list). Held on
    rank 0, bit for bit: the mean against sum_r q_r * s / n from the
    gathered int8 q's (q and s recomputed on each rank as compress does,
    s from the gathered max|g|); on each rank the new error against
    g - q * s. The compressed call's and a plain f32 all_reduce's device
    ms over the same leaves (time_ms: CUDA events behind a spin) and
    bytes as the flight recorder logged them."""
    import torch.distributed as dist
    from repro_torch.distributed import flight
    from repro_torch.optim import compress
    n, r = dist.get_world_size(group), dist.get_rank(group)
    gen = torch.Generator(device=dev).manual_seed(r)
    grads = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    zeros = [torch.zeros_like(x) for x in grads]
    mark = flight.last_id()
    means, errs = compress.compressed_psum_with_feedback(grads, zeros, group)
    _sync(torch, dev)
    comp_log = flight.by_kind(flight.since(mark))
    mean_bad = err_bad = 0
    for g, mean, err in zip(grads, means, errs):
        amax = torch.max(torch.abs(g)).reshape(1)
        every = torch.empty(n, device=dev)
        dist.all_gather_into_tensor(every, amax, group=group)
        s = every.max() / 127.0 + 1e-12
        q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
        err_bad += int(not torch.equal(err, g - q.to(torch.float32) * s))
        qs = torch.empty(n * q.numel(), dtype=torch.int8, device=dev)
        dist.all_gather_into_tensor(qs, q.reshape(-1), group=group)
        want = (qs.view(n, -1).to(torch.int32).sum(0).to(torch.float32)
                * s / n).view(q.shape)
        mean_bad += int(not torch.equal(mean, want))
        del qs, want, q
    del means, errs
    plain = [x.clone() for x in grads]
    mark = flight.last_id()
    for x in plain:
        dist.all_reduce(x, group=group)
    _sync(torch, dev)
    plain_log = flight.by_kind(flight.since(mark))
    timing = {"compressed_ms": None, "plain_ms": None}
    if dev.type == "cuda":
        def comp():
            compress.compressed_psum_with_feedback(grads, zeros, group)

        def full():
            for x in plain:
                dist.all_reduce(x, group=group)
        timing = {"compressed_ms": time_ms(torch, comp, F_TIME_ITERS,
                                           warmup=1)[0],
                  "plain_ms": time_ms(torch, full, F_TIME_ITERS,
                                      warmup=1)[0]}
    bad = [None] * n
    dist.all_gather_object(bad, err_bad, group=group)
    del grads, zeros, plain
    return dict(timing, elements=sum(math.prod(s) for s in shapes),
                leaves=len(shapes), mean_differ=mean_bad, err_differ=bad,
                compressed_log=comp_log, plain_log=plain_log)


def collective_matmul_ring(torch, dev, group, d_model):
    """(f4) on group (the "tp" ring): for each width of F_CM_COLS, x (D_BATCH
    x D_SEQ, d_model) row-sharded and w (d_model, n) in column blocks,
    both forms against x @ w on this rank's rows (max|diff| / max), the
    passes each makes (a spy on batch_isend_irecv and
    all_gather_into_tensor), each one's wall (the median of F_CM_REPS,
    host clock ending in a synchronize) and, on the card, the share of the
    overlapped form's SendRecv kernel time that overlaps its GEMM
    kernels (torch.profiler)."""
    import torch.distributed as dist
    from repro_torch.distributed import collective_matmul as CM
    n, r = dist.get_world_size(group), dist.get_rank(group)
    rows = D_BATCH * D_SEQ // n
    calls = {"p2p": 0, "all_gather": 0}
    real_p2p, real_ag = dist.batch_isend_irecv, dist.all_gather_into_tensor

    def p2p(ops):
        calls["p2p"] += 1
        return real_p2p(ops)

    def ag(*a, **k):
        calls["all_gather"] += 1
        return real_ag(*a, **k)

    out = {}
    for name, cols in F_CM_COLS.items():
        g = torch.Generator(device=dev).manual_seed(2)
        x = torch.randn(D_BATCH * D_SEQ, d_model, generator=g, device=dev)
        w = torch.randn(d_model, cols, generator=g, device=dev)
        nb = cols // n
        xs, wb = x[r * rows:(r + 1) * rows], \
            w[:, r * nb:(r + 1) * nb].contiguous()
        want = xs @ w
        rec = {}
        for fn in (CM.allgather_matmul_overlapped,
                   CM.allgather_matmul_barrier):
            before = dict(calls)
            dist.batch_isend_irecv, dist.all_gather_into_tensor = p2p, ag
            try:
                got = fn(xs, wb, group)
            finally:
                dist.batch_isend_irecv = real_p2p
                dist.all_gather_into_tensor = real_ag
            walls = []
            for _ in range(F_CM_REPS):
                _sync(torch, dev)
                t = time.perf_counter()
                fn(xs, wb, group)
                _sync(torch, dev)
                walls.append(time.perf_counter() - t)
            rec[fn.__name__] = {
                "rel": float((got - want).abs().max() / want.abs().max()),
                "passes": {k: calls[k] - before[k] for k in calls},
                "wall_ms": statistics.median(walls) * 1e3}
        rec["overlap"] = (cm_overlap(torch, lambda: CM.
                                     allgather_matmul_overlapped(xs, wb,
                                                                 group))
                          if dev.type == "cuda" else None)
        out[name] = dict(rec, shape={"x": [D_BATCH * D_SEQ, d_model],
                                     "w": [d_model, cols]})
        del x, w, xs, wb, want, got
    return out


def cm_overlap(torch, fn):
    """fn() under torch.profiler: {"sendrecv_ms", "gemm_ms", "overlap_ms"
    (the SendRecv kernels' time inside the union of the GEMM kernels'),
    "share"}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    send, gemm = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        low = e.name.lower()
        if "sendrecv" in low:
            send.append(span)
        elif "nccl" not in low and re.search(r"gemm|xmma|cutlass", low):
            gemm.append(span)
    merged = []
    for a, b in sorted(gemm):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    inside = sum(max(0, min(b, d) - max(a, c)) for a, b in send
                 for c, d in merged)
    total = sum(b - a for a, b in send)
    return {"sendrecv_ms": total / 1e3,
            "gemm_ms": sum(b - a for a, b in merged) / 1e3,
            "overlap_ms": inside / 1e3,
            "share": inside / total if total else None,
            "kernels": {"sendrecv": len(send), "gemm": len(gemm)}}


def step_collectives(torch, dev, cfg, shape, batch):
    """(f5) one f32 train step of cfg on a shape mesh at E_MICRO[shape],
    after one warm step: the collectives the flight recorder logged in it
    (distributed.flight.by_kind) and, on the card, the same step under
    the profiler (profiled_step: wall, busy, NCCL kernels by kind)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import flight
    from repro_torch.distributed import policy as POL
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import make_train_step
    mesh = make_mesh(shape, ("data", "model"))
    params = _sharded_train_params(torch, cfg, mesh, dev, torch.float32)
    ocfg, tcfg = _train_cfgs(torch.float32, E_MICRO[shape], ep_axis="model")
    opt = adamw_init(params, ocfg)
    step = make_train_step(cfg, ocfg, tcfg,
                           param_shardings=SH.param_shardings(params, mesh))
    spec = SH.batch_sharding(mesh).spec
    rec = {}
    with POL.use_policy(POL.sp_policy(mesh)), implicit_replication():
        placed = {k: SH.distribute(v, mesh, spec) for k, v in batch.items()}
        step(params, opt, placed)
        _sync(torch, dev)
        mark = flight.last_id()
        run = lambda: step(params, opt, placed)
        if dev.type == "cuda":
            rec["profile"] = profiled_step(torch, run)
        else:
            run()
        rec["log"] = flight.by_kind(flight.since(mark))
    del params, opt, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def dist_elastic(torch, dev, world, cfg=None):
    """(f) in one rank of a group of D_CARDS (NCCL on the cards; gloo on
    the host when dev is the CPU, a rehearsal at a smaller cfg): (f1),
    (f2), (f3), (f4), (f5) in order, the launch counters zeroed before
    and read after. Returns rank 0's report (None elsewhere)."""
    import pathlib
    import shutil
    import torch.distributed as dist
    from repro_torch.configs import deepseek_v2_lite
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.module import count_params
    rank = dist.get_rank()
    cfg = cfg or dataclasses.replace(deepseek_v2_lite.config(),
                                     n_layers=F_LAYERS)
    zero, read = _launch_counters()
    zero()
    box = [tempfile.mkdtemp(prefix="chip_smoke_f_") if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    root = pathlib.Path(box[0])
    rep = {"layers": cfg.n_layers,
           "params": count_params(M.init_model(cfg, device="meta")),
           "root": str(root), "disk_free": shutil.disk_usage(root).free}
    try:
        t = time.perf_counter()
        rep["loop"] = elastic_loop(torch, dev, world, cfg, root)
        rep["loop_s"] = time.perf_counter() - t
        if rank == 0:
            rep["snapshot_bytes"] = sum(
                f.stat().st_size for f in
                (root / "unbroken" / f"step_{F_FROM:08d}").iterdir())
    finally:
        dist.barrier()
        if rank == 0:
            shutil.rmtree(root, ignore_errors=True)
    pod = make_mesh((world,), ("pod",)).get_group("pod")
    t = time.perf_counter()
    rep["toy"] = compressed_toy(torch, dev, pod)
    shapes = [tuple(p.shape) for p in M.init_model(cfg, device="meta")
              .parameters()]
    rep["at_size"] = compressed_at_size(torch, dev, pod, shapes)
    rep["compress_s"] = time.perf_counter() - t
    tp = make_mesh((world,), ("tp",)).get_group("tp")
    t = time.perf_counter()
    rep["cm"] = collective_matmul_ring(torch, dev, tp, cfg.d_model)
    rep["cm_s"] = time.perf_counter() - t
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    batch = SyntheticPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=D_SEQ, global_batch=D_BATCH, seed=1),
        device=dev).batch_at(0)
    t = time.perf_counter()
    rep["steps"] = {str(list(s)): step_collectives(torch, dev, cfg, s,
                                                   batch)
                    for s in E_MICRO}
    rep["steps_s"] = time.perf_counter() - t
    mine = {"launches": read(), "rss": [s["rss_growth"] for s in
                                        rep["loop"]["unbroken"]["saves"]],
            "steps": {k: v.get("profile") for k, v in rep["steps"].items()},
            "logs": {k: v["log"] for k, v in rep["steps"].items()}}
    by_rank = [None] * world
    dist.all_gather_object(by_rank, mine)
    if rank != 0:
        return None
    rep["by_rank"] = by_rank
    return rep


def meta_step_collectives(cfg, shape, n_micro):
    """step_costs' count of one f32 train step of cfg on a shape mesh at
    n_micro (launch.dryrun.build_step over its fake_group, D_BATCH x D_SEQ
    tokens): {kind: {"count", "result_bytes", "wire_bytes"}}."""
    import torch
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    with D.fake_group(math.prod(shape)):
        mesh = make_mesh(shape, ("data", "model"))
        step, _ = D.build_step("deepseek-v2-lite", "train", mesh,
                               n_micro=n_micro, cfg=cfg,
                               shape=ShapeSpec("5e (f5)", D_SEQ, D_BATCH,
                                               "train"),
                               dtype=torch.float32)
        costs = D.step_costs.measure(step.micro, step.n_micro, step.update)
    return costs.by_kind()


def _by_step(log_):
    """{step: (loss, grad_norm)} of a loop's log, the last entry a step."""
    return {e["step"]: (e["loss"], e["grad_norm"]) for e in log_
            if "event" not in e}


def _gb(n):
    return f"{n / 1e9:.2f} GB"


def log_dist_elastic(r, wall, smi_line):
    """(f)'s lines; fail unless every limit of (f1)-(f5) holds (see the
    constants above) and no kernel was launched."""
    bad = []
    launched = {k: n for x in r["by_rank"] for k, c in x["launches"].items()
                for n in c.values() if n}
    loop, snap = r["loop"], r["snapshot_bytes"]
    u, b, e = loop["unbroken"], loop["broken"], loop["elastic"]
    log(f"[dist] (f) the training substrate across {D_CARDS} cards (a NCCL "
        f"group of its own): V2-Lite at full width cut to {r['layers']} "
        f"layers ({r['params']} parameters) in f32, TF32 off, "
        f"AdamWConfig(), {D_BATCH} x {D_SEQ} tokens a step "
        f"(SyntheticPipeline, seed 1), param_shardings, sp_policy, ep_axis "
        f"model, weights drawn leaf by leaf (init_sharded); kernels "
        f"launched {launched or 'none'}; part wall {wall:.1f} s ((f1)+(f2) "
        f"{r['loop_s']:.1f} s, (f3) {r['compress_s']:.1f} s, (f4) "
        f"{r['cm_s']:.1f} s, (f5) {r['steps_s']:.1f} s); {smi_line}")
    # (f1)
    want, got = _by_step(u["log"]), _by_step(b["log"])
    events = [(x["event"], x["step"]) for x in b["log"] if "event" in x]
    rss = [x["rss"] for x in r["by_rank"]]
    log(f"[dist] (f1) train_loop on (1, 4) at n_micro {E_MICRO[(1, 4)]}, "
        f"{F_STEPS} steps, a snapshot every {F_CKPT_EVERY} (keep "
        f"{F_KEEP}), a fault on every rank at step {F_FAULT_AT}: events "
        f"{events}; losses (unbroken) " + ", ".join(
            f"{want[s][0]:.7f}" for s in sorted(want))
        + f"; replayed = unbroken: logs {got == want}, parameters and "
        f"moments {len(loop['replay']['differ'])} of "
        f"{loop['replay']['leaves']} leaves differ; on disk {b['on_disk']} "
        f"/ {u['on_disk']}; snapshot {_gb(snap)} ({_gb(r['disk_free'])} "
        f"free at the start); loop walls unbroken "
        f"{u['wall_s']:.1f} s, broken {b['wall_s']:.1f} s; step walls "
        f"(unbroken) " + _ms([u["step_walls"][s] for s in
                              sorted(u["step_walls"])]) + " ms; writes "
        + ", ".join(f"step {x['step']} gather {x['gather_s']:.2f} s write "
                    f"{x.get('write_s', float('nan')):.2f} s "
                    f"({snap / 1e9 / x['write_s']:.2f} GB/s)"
                    for x in u["saves"] + b["saves"] if x.get("write_s"))
        + "; restores " + ", ".join(
            f"step {x['step']} {x['wall_s']:.2f} s "
            f"({snap / 1e9 / x['wall_s']:.2f} GB/s)"
            for x in b["restores"] + e["restores"])
        + "; host RSS growth across a save, by rank (the unbroken run's "
        "saves): " + "; ".join(
            f"rank {i} " + ", ".join(_gb(x) for x in g)
            for i, g in enumerate(rss)) + f"; {smi_line}")
    if got != want:
        bad.append(f"(f1) the replayed log differs: {got} vs {want}")
    logged = {s: x[0] for run in (u, b) for s, x in _by_step(
        run["log"]).items() if x[0] != run["whole_losses"][str(s)]}
    if logged:        # the loop logs float() of the loss, a DTensor
        bad.append(f"(f1) logged losses are not the whole loss: {logged}")
    if loop["replay"]["differ"] or not loop["replay"]["leaves"]:
        bad.append(f"(f1) leaves differ after the replay: "
                   f"{loop['replay']}")
    if events != [("restored", F_FAULT_AT - F_FAULT_AT % F_CKPT_EVERY)]:
        bad.append(f"(f1) restore events {events}")
    if b["on_disk"] != u["on_disk"] or not u["on_disk"]:
        bad.append(f"(f1) snapshots on disk {b['on_disk']} vs "
                   f"{u['on_disk']}")
    kept = [max(g) for g in rss[1:]]
    if max(kept) > 0.05 * snap or rss[0][0] < 0.5 * snap:
        bad.append(f"(f1) host RSS growth across a save by rank {rss} "
                   f"(snapshot {snap} bytes): ranks 1-3 must keep no copy")
    # (f2)
    lu = {s: l for s, (l, _) in want.items()}
    le = _by_step(e["log"])
    rel = {s: abs(le[s][0] - lu[s]) / abs(lu[s]) for s in le}
    aft = e["after"]
    log(f"[dist] (f2) a new job on (2, 2) at n_micro {E_MICRO[(2, 2)]}, "
        f"weights from seed {F_ELASTIC_SEED}, warm-started by train_loop "
        f"from (f1)'s snapshots up to step {F_FROM}: restored state "
        f"{len(e['restored']['differ'])} of {e['restored']['leaves']} "
        f"leaves differ from the unbroken run's step {F_FROM} (bit for "
        f"bit), on param_shardings' (2, 2) placements {e['placed']}; steps "
        f"{sorted(le)} pinned to the unbroken routes, recorded = pinned "
        f"{e['routes_pinned']}; losses " + ", ".join(
            f"{le[s][0]:.7f} / {lu[s]:.7f} ({rel[s]:.3e})" for s in sorted(le))
        + f" (limit {DIST_LOSS_RTOL}); after step {F_STEPS - 1} against "
        f"the unbroken run: worst leaf {aft['rel']:.3e} ({aft['leaf']}), "
        f"{aft['over']} elements beyond {DIST_PARAM_RTOL} x their leaf's "
        f"max; restore {e['restores'][0]['wall_s']:.2f} s, step walls "
        + _ms([e["step_walls"][s] for s in sorted(e["step_walls"])])
        + f" ms; {smi_line}")
    if e["restored"]["differ"] or not e["placed"]:
        bad.append(f"(f2) restored state: {e['restored']}, placed "
                   f"{e['placed']}")
    if not e["routes_pinned"] or e["routes_steps"] != list(
            range(F_FROM, F_STEPS)):
        bad.append(f"(f2) routes pinned {e['routes_pinned']} at steps "
                   f"{e['routes_steps']}")
    if sorted(le) != list(range(F_FROM, F_STEPS)) or \
            max(rel.values()) > DIST_LOSS_RTOL:
        bad.append(f"(f2) losses {le} against {lu}")
    if aft["over"]:
        bad.append(f"(f2) {aft['over']} elements beyond {DIST_PARAM_RTOL} "
                   f"x their leaf's max after step {F_STEPS - 1}")
    # (f3)
    toy, big = r["toy"], r["at_size"]
    cb = sum(v["result_bytes"] for v in big["compressed_log"].values())
    pb = sum(v["result_bytes"] for v in big["plain_log"].values())
    fmt = lambda x: "not measured" if x is None else f"{x:.3f} ms"
    log(f"[dist] (f3) the compressed all-reduce on a {D_CARDS}-rank pod "
        f"group: toy regression, {F_DP_STEPS} steps, final loss compressed "
        f"{toy['loss']['compressed']:.3e} / full {toy['loss']['full']:.3e} "
        f"(limit {F_DP_LOSS}), |w_c - w_f| {toy['w_diff']:.3e} (limit "
        f"{F_DP_W}), SUM payload int32 of int8 values {toy['payload_ok']}, "
        f"scale an f32 MAX {toy['scale_max_f32']}; at a gradient's size "
        f"({big['leaves']} leaves, {big['elements']} f32 elements a rank, "
        f"seed = rank): mean = sum_r q_r s / {D_CARDS} bit for bit on "
        f"{big['leaves'] - big['mean_differ']} of {big['leaves']} leaves, "
        f"new error = g - q s on every rank but {big['err_differ']} "
        f"leaves; device ms compressed {fmt(big['compressed_ms'])}, plain "
        f"f32 all_reduce {fmt(big['plain_ms'])}; bytes as NCCL logged "
        f"them (flight recorder, results) compressed {cb} ("
        + ", ".join(f"{k} {v['count']} x {v['dtypes']}"
                    for k, v in big["compressed_log"].items())
        + f"), plain {pb}: ratio {cb / pb:.4f} against wire_bytes_ratio() "
        f"0.25; {smi_line}")
    if not (toy["loss"]["compressed"] < F_DP_LOSS
            and toy["loss"]["full"] < F_DP_LOSS
            and toy["w_diff"] < F_DP_W and toy["payload_ok"]
            and toy["scale_max_f32"]):
        bad.append(f"(f3) toy regression {toy}")
    if big["mean_differ"] or any(big["err_differ"]):
        bad.append(f"(f3) at size: mean differs on {big['mean_differ']} "
                   f"leaves, errors on {big['err_differ']}")
    # (f4)
    want_passes = {"allgather_matmul_overlapped": {"p2p": D_CARDS - 1,
                                                   "all_gather": 0},
                   "allgather_matmul_barrier": {"p2p": 0, "all_gather": 1}}
    for name, c in r["cm"].items():
        ov = c["overlap"]
        log(f"[dist] (f4) the collective matmul on a {D_CARDS}-rank tp "
            f"ring, {name}: x {c['shape']['x']} x w {c['shape']['w']} f32 "
            + "; ".join(f"{fn} max|diff|/max {c[fn]['rel']:.3e} (limit "
                        f"{CM_TOL}), passes {c[fn]['passes']}, wall "
                        f"{c[fn]['wall_ms']:.3f} ms (median of {F_CM_REPS})"
                        for fn in want_passes)
            + "; SendRecv time inside GEMM time "
            + ("not measured" if ov is None else
               f"{ov['overlap_ms']:.3f} of {ov['sendrecv_ms']:.3f} ms ("
               + ("n/a" if ov["share"] is None else
                  f"{100 * ov['share']:.1f}%")
               + f"; GEMM {ov['gemm_ms']:.3f} ms, kernels {ov['kernels']})")
            + f"; {smi_line}")
        for fn, p in want_passes.items():
            if c[fn]["rel"] > CM_TOL or c[fn]["passes"] != p:
                bad.append(f"(f4) {name} {fn}: {c[fn]}")
    # (f5)
    for shape_s, st in r["steps"].items():
        shape = tuple(json.loads(shape_s))
        n_micro = E_MICRO[shape]
        cfg = _f_cfg(r["layers"])
        dry = meta_step_collectives(cfg, shape, n_micro)
        card = st["log"]
        prof = [x["steps"][shape_s] for x in r["by_rank"]]
        rows = []
        for k in sorted(set(card) | set(dry)):
            c, m = card.get(k, {}), dry.get(k, {})
            ms = [p["nccl"].get(F_KERNEL_KIND.get(k), [0, 0.0])[1]
                  for p in prof if p]
            rate = (c.get("wire_bytes", 0) / (max(ms) / 1e3) / 1e9
                    if ms and max(ms) else None)
            rows.append(
                f"{k}: card {c.get('count', 0)} / meta "
                f"{m.get('count', 0):g}, result bytes "
                f"{c.get('result_bytes', 0)} / {m.get('result_bytes', 0):g}"
                f", card elements {c.get('elements', 0)} dtypes "
                f"{c.get('dtypes', {})} groups "
                f"{c.get('groups', {})}, ring wire "
                f"{c.get('wire_bytes', 0) / 1e9:.4f} GB over NCCL "
                + (f"{max(ms):.1f} ms (waits included): {rate:.2f} GB/s "
                   f"against 125" if rate else "ms not measured"))
            if c.get("count", 0) != m.get("count", 0) or abs(
                    c.get("result_bytes", 0) - m.get("result_bytes", 0)) \
                    > F_BYTES_RTOL * max(m.get("result_bytes", 0), 1):
                bad.append(f"(f5) {shape} {k}: card {c.get('count', 0)} "
                           f"collectives, {c.get('result_bytes', 0)} bytes; "
                           f"step_costs {m.get('count', 0):g}, "
                           f"{m.get('result_bytes', 0):g}")
        log(f"[dist] (f5) one f32 step on {shape} at n_micro {n_micro}, "
            f"its collectives as NCCL's flight recorder logged them (card) "
            f"against step_costs.measure of the same step on meta over "
            f"the dry run's fake group (meta): " + "; ".join(rows)
            + "; " + (_profile_line(prof) if all(prof) else
                      "the step's profile not measured") + f"; {smi_line}")
    if launched:
        bad.append(f"kernels launched in (f): {launched}")
    if bad:
        fail("(5e) (f) " + "; ".join(bad))


def _f_cfg(layers):
    from repro_torch.configs import deepseek_v2_lite
    return dataclasses.replace(deepseek_v2_lite.config(), n_layers=layers)


def dist_serve_rank(rank, world, port, part):
    """One rank of (c1), (c2), (c4), (c5), (d), (e) or (f)
    (torch.multiprocessing.spawn's
    target):
    card `rank`, a NCCL group of `world` ranks. Rank 0 prints the part's
    result as one "DIST-SERVE {json}" line."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from repro_torch.configs import deepseek_v2_lite
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    if part == "f":             # (f5) reads NCCL's flight recorder
        from repro_torch.distributed import flight
        flight.enable()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    v2_lite = deepseek_v2_lite.config()
    if part == "c1":
        cut = dataclasses.replace(v2_lite, n_layers=4)
        out = [serve_f32_mesh(torch, dev, cut, shape, batch)
               for shape, batch in serve_meshes(world)]
    elif part == "c4":
        out = serve_families(torch, dev, world)
    elif part == "c5":
        out = long_decode_f32(torch, dev, dataclasses.replace(
            v2_lite, n_layers=C5_LAYERS), (1, world))
    elif part == "d":
        out = dist_train(torch, dev, world)
    elif part == "e":
        out = dist_train_full(torch, dev, world)
    elif part == "f":
        out = dist_elastic(torch, dev, world)
    else:
        out, params = serve_bf16(torch, dev, v2_lite, (1, world))
        long = long_decode_bf16(torch, dev, v2_lite, (1, world), params)
        if rank == 0:
            out["long"] = long
        del params
    if rank == 0:
        print("DIST-SERVE " + json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def dist_serve_part(part: str) -> None:
    """(c1), (c2), (c4) or (c5) in this process: one rank per visible card,
    spawned; (d), (e) and (f) on the first D_CARDS cards, (e)'s ranks with
    the caching allocator's expandable segments (its f32 steps peak at ~73
    GiB a card); a rank that fails fails the part."""
    import torch
    import torch.multiprocessing as mp
    n = torch.cuda.device_count()
    if part in ("d", "e", "f"):
        if n < D_CARDS:
            fail(f"(5e) ({part}) needs {D_CARDS} CUDA cards, {n} visible")
        n = D_CARDS
    if part == "e":
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    if n < 1:
        fail(f"(5e) ({part}) needs a CUDA card")
    mp.spawn(dist_serve_rank, args=(n, _free_port(), part), nprocs=n,
             join=True)


def _serve_result(part, out):
    found = [line for line in out.splitlines()
             if line.startswith("DIST-SERVE ")]
    if not found:
        fail(f"(5e) ({part}) printed no result")
    return json.loads(found[-1][len("DIST-SERVE "):])


def _launch_totals(by_rank):
    """{kernel: launches summed over the ranks}, {kernel: {card: n}}."""
    total, cards = {k: 0 for k in KERNELS}, {k: {} for k in KERNELS}
    for launches in by_rank:
        for k, per_card in launches.items():
            for card, n in per_card.items():
                total[k] += n
                cards[k][int(card)] = cards[k].get(int(card), 0) + n
    return total, cards


def _on_every_card(part, cards, n_cards):
    path = SERVE_PATH[part] if part in SERVE_PATH else FAMILY_PATH[part[2:]]
    missing = [f"{k} on cuda:{c}" for k in path
               for c in range(n_cards) if cards[k].get(c, 0) <= 0]
    if missing:
        fail(f"(5e) ({part}) not launched: {missing}")


def dist_part_f() -> int:
    """python3 chip_smoke.py --dist-part f: (f) alone, its ranks in a
    subprocess (--dist-part f-ranks) with DIST_TIMEOUT["f"], then its
    lines and limits; exits 2 without a card, as main does."""
    import torch
    if torch.cuda.device_count() < D_CARDS:
        print(f"[chip_smoke] FAIL: (5e) (f) needs {D_CARDS} CUDA cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    smi_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    out, wall = run_subprocess_part(
        "f", [sys.executable, os.path.abspath(__file__), "--dist-part",
              "f-ranks"])
    log_dist_elastic(_serve_result("f", out), wall, smi_line)
    print(smi_line)
    return 0


def run_dist_serve(torch, smi_line):
    """(c1) on every visible card's meshes and, on two cards or more, (c2)
    and, in its process group, (c3); then (c4), (a) on every visible card's
    meshes and, on two cards or more, (b) and (c); then, on two cards or
    more, (c5); then, on D_CARDS cards or more, the sharded train step
    (d), V2-Lite as published trained (e) and the training substrate (f);
    each part a process group of its own in a subprocess with its
    timeout. Returns ({part: result}, launches by kernel, by kernel and
    card), the launches those of the sharded KERNELS runs alone ((d), (e)
    and (f) launch none)."""
    n_cards = torch.cuda.device_count()
    parts = ["c1"] + (["c2"] if n_cards >= 2 else []) + ["c4"] + (
        ["c5"] if n_cards >= 2 else []) + (
        ["d", "e", "f"] if n_cards >= D_CARDS else [])
    results, total, cards = {}, {k: 0 for k in KERNELS}, \
        {k: {} for k in KERNELS}
    for part in parts:
        # (f)'s ranks alone: --dist-part f would log and hold it itself
        ranks = part + "-ranks" if part == "f" else part
        out, wall = run_subprocess_part(
            part, [sys.executable, os.path.abspath(__file__), "--dist-part",
                   ranks], DIST_TIMEOUT[part] + (DIST_TIMEOUT["c3"]
                                                if part == "c2" else 0))
        r = _serve_result(part, out)
        results[part] = {"result": r, "wall_s": wall}
        if part in ("d", "e", "f"):
            {"d": log_dist_train, "e": log_dist_train_full,
             "f": log_dist_elastic}[part](r, wall, smi_line)
            continue
        # each c1 mesh launches its kernels on every card; (c2) and (c3)
        # together (sparse_select runs in (c3) alone); each (c4) run its
        # part's
        if part == "c1":
            runs = [(part, x) for x in r]
        elif part == "c5":
            runs = [(part, r)]
        elif part == "c2":
            runs = [(part, {"launches": r["launches"]
                            + r["long"]["launches"]})]
        else:
            runs = [(f"c4{k}", x) for k in ("a", "b", "c") if k in r
                    for x in (r[k] if k == "a" else [r[k]])]
        for label, run in runs:
            t, c = _launch_totals(run["launches"])
            _on_every_card(label, c, n_cards)
            for k in KERNELS:
                total[k] += t[k]
                for card, n in c[k].items():
                    cards[k][card] = cards[k].get(card, 0) + n
        if part == "c1":
            log_serve_f32(r, wall, n_cards, smi_line)
        elif part == "c2":
            log_serve_bf16(r, wall, n_cards, smi_line)
            log_long(r["long"], smi_line)
        elif part == "c5":
            log_long_f32(r, wall, smi_line)
        else:
            log_families(r, wall, n_cards, smi_line)
    if n_cards == 1:
        log(f"[dist] (c1) on (1, 4), (2, 2) and one row on (2, 2), (c2), "
            f"(c3) and (c5) did not run: 1 card visible; on four cards "
            f"python3 chip_smoke.py --dist-only runs them; {smi_line}")
        log(f"[dist] (c4a) on (1, 4), (2, 2) and one row on (2, 2), (c4b) "
            f"and (c4c) did not run: 1 card visible; on four cards python3 "
            f"chip_smoke.py --dist-only runs them; {smi_line}")
    if n_cards < D_CARDS:
        log(f"[dist] (d) the sharded train step on (2, 2) and (1, 4), "
            f"(e) V2-Lite as published trained on four cards and (f) the "
            f"training substrate across four cards did not run: "
            f"{n_cards} card(s) visible, {D_CARDS} needed; on four cards "
            f"python3 chip_smoke.py --dist-only runs them; {smi_line}")
    return results, total, cards


def _fmt_walls(w):
    pre = w["prefill_s"]
    return ("prefill " + ", ".join(f"{p * 1e3:.1f}" for p in (
        pre if isinstance(pre, list) else [pre])) + " ms"
            + (f" (warm {w['warm_prefill_s'] * 1e3:.1f})"
               if "warm_prefill_s" in w else "")
            + ", decode steps " + ", ".join(f"{s * 1e3:.1f}"
                                            for s in w["decode_s"]) + " ms")


def _log_held(part, shape, held, smi_line):
    """Log each card's held first calls (hold_first_calls'); fail where one
    is beyond its TOL."""
    log(f"[dist] ({part}) {shape}: each kernel's first call on each card, "
        f"again through the kernel against its plain version on the same "
        f"inputs ([argument shapes, max|err|, within TOL]) by card "
        f"{held}; TOL {TOL}; {smi_line}")
    bad = [f"{k} on cuda:{c}" for c, h in enumerate(held)
           for k, v in h.items() if not v[2]]
    if bad:
        fail(f"(5e) ({part}) {shape}: beyond TOL against the plain "
             f"versions: {bad}")


def log_serve_f32(runs, wall, n_cards, smi_line):
    """(c1)'s lines, a mesh each; fail unless each mesh is within its
    limits against both runs, its routes equal but for at most MAX_FLIPS
    near-ties (router margin below NEAR_TIE), its chosen sets equal but for
    at most MAX_FLIPS near-ties (the unsharded k-th and (k + 1)-th scores
    within SEL_NEAR_TIE), and, after a flip, its f64 comparison is within
    SERVE_TOL with equal routes and chosen sets; and unless some selection
    step left a sequence shard none of the chosen rows (kb = 0) where a
    mesh splits the sequence."""
    empty = None
    for r in runs:
        shape = tuple(r["mesh"])
        label = f"{shape}" + (", one row" if r["batch"] == 1 else "")
        t, c = _launch_totals(r["launches"])
        parts = []
        for name, tol in (("unsharded", SERVE_TOL),
                          ("plain", MODEL_TOL["v2_lite"])):
            h = r[name]
            parts.append(
                f"against {name} " + ", ".join(f"{k} {v:.3e}" for k, v in
                                               h["errs"].items())
                + f" (atol {tol[0]:g}, rtol {tol[1]:g}); routes "
                + ("equal" if not h["flips"] else
                   f"flipped at (call, token, router margin) {h['flips']}"))
        log(f"[dist] (c1) V2-Lite cut to 4 layers in f32, KERNELS, on a "
            f"{shape} (data, model) NCCL mesh over {n_cards} card(s): "
            f"prefill {r['batch']} x {MODEL_PROMPT} into {SERVE_SLOTS} "
            f"slots, {MODEL_STEPS} decode steps at slots {MODEL_PROMPT}-"
            f"{MODEL_PROMPT + MODEL_STEPS - 1}, then {SEL_STEPS} with "
            f"selection_k {SEL_K}; {r['routes']} route entries; "
            + "; ".join(parts) + f"; sharded {_fmt_walls(r['walls'])}; "
            f"unsharded {_fmt_walls(r['unsharded_walls'])}; peak GiB by "
            f"card {[round(p, 2) for p in r['peak_gib']]}; launches {t}, by "
            f"card {c}; part wall {wall:.1f} s; {smi_line}")
        kb = r["kb"]
        n_layers = len(kb) // SEL_STEPS if kb else 0
        by_step = [[min(kb[i * n_layers + li][k] for li in range(n_layers))
                    for k in range(len(kb[0]))]
                   for i in range(SEL_STEPS)] if kb else None
        log(f"[dist] (c1) {label}: the selection steps' chosen sets (a "
            f"global top-{SEL_K} over the sequence shards, {r['chosen_calls']}"
            f" layer calls unsharded) against the unsharded run's: "
            + ("equal" if not r["chosen_flips"] else
               f"differ at (call, row, unsharded k-th/(k+1)-th gap) "
               f"{r['chosen_flips']}")
            + f"; kb (chosen rows a shard attends), the least over the "
            f"layers and rows, by step and rank {by_step}; {smi_line}")
        _log_held("c1", label, r["held"], smi_line)
        if by_step is None:
            fail(f"(5e) (c1) {label}: the ranks chose different sets")
        if len(by_step[0]) > 1:
            empty = bool(empty) or any(0 in row for row in by_step)
        for name in ("unsharded", "plain"):
            h = r[name]
            if h["beyond"]:
                fail(f"(5e) (c1) {label}: against {name} beyond the limit "
                     f"in {h['beyond']}: {h['errs']}")
            ties = [f for f in h["flips"]
                    if f[2] is not None and f[2] < NEAR_TIE]
            if len(ties) < len(h["flips"]) or len(ties) > MAX_FLIPS:
                fail(f"(5e) (c1) {label}: against {name} routes flipped "
                     f"beyond {MAX_FLIPS} near-ties (router margin < "
                     f"{NEAR_TIE:g}): {h['flips']}")
        ties = [f for f in r["chosen_flips"]
                if f[2] is not None and f[2] <= SEL_NEAR_TIE]
        if len(ties) < len(r["chosen_flips"]) or len(ties) > MAX_FLIPS:
            fail(f"(5e) (c1) {label}: chosen sets differ beyond {MAX_FLIPS} "
                 f"near-ties (gap <= {SEL_NEAR_TIE:g}): {r['chosen_flips']}")
        if "f64" in r:
            f = r["f64"]
            if f is None or f["beyond"] or f["flips"] or f["chosen_flips"]:
                fail(f"(5e) (c1) {label}: a flip, and the f64 comparison "
                     f"did not hold: {f}")
            log(f"[dist] (c1) {label}: after the flip, the sharded steps "
                f"against the unsharded ones in f64 with PLAIN ops: "
                + ", ".join(f"{k} {v:.3e}" for k, v in f["errs"].items())
                + f" (atol {SERVE_TOL[0]:g}, rtol {SERVE_TOL[1]:g}), routes "
                f"and chosen sets equal; {smi_line}")
    if empty is False:
        fail("(5e) (c1) no selection step left a sequence shard without a "
             "chosen row (kb = 0): the merge identity went untested")


def log_serve_bf16(r, wall, n_cards, smi_line):
    """(c2)'s lines: its kernels held at its shard shapes on every card;
    its numbers against the unsharded run reported."""
    t, c = _launch_totals(r["launches"])
    rows = [sum(col) for col in zip(*r["top1_by_row"])]
    shares = r["merge_share_card0"]
    log(f"[dist] (c2) V2-Lite as published ({r['layers']} layers) in bf16, "
        f"KERNELS, on a {tuple(r['mesh'])} (data, model) NCCL mesh, "
        f"weights from seed 0 (sharded in {r['init_s']:.2f} s): prefill "
        f"{MODEL_BATCH} x {MODEL_PROMPT} into {SERVE_SLOTS} slots, "
        f"{MODEL_STEPS} decode steps fed card 0's unsharded greedy tokens; "
        f"against the unsharded run: last-token logits max|diff| "
        f"{r['last_token_max_abs_diff']:.4e}, decode logits max|diff| "
        f"{r['decode_max_abs_diff']:.4e}, top-1 agreement per row "
        f"{rows} of {len(r['top1_by_row'])} (prefill + {MODEL_STEPS} "
        f"steps), routes equal {r['routes_equal']} of {r['routes']} "
        f"tokens; sharded {_fmt_walls(r['walls'])}; unsharded "
        f"{_fmt_walls(r['unsharded_walls'])}; peak GiB by card "
        f"{[round(p, 2) for p in r['peak_gib']]} (unsharded on card 0 "
        f"{r['unsharded_peak_gib']:.2f}); part wall {wall:.1f} s; "
        f"{smi_line}")
    p = r["parting"]
    log(f"[dist] (c2) layer by layer, the sharded run against the unsharded "
        f"one: prefill cache entries max|diff| "
        f"{[float(f'{x:.3g}') for x in p['cache_max_abs_diff']]}; share of "
        f"prefill tokens whose top-k routes are all equal, by MoE layer "
        f"{[round(x, 4) for x in p['routes_equal_share']]}; {smi_line}")
    log(f"[dist] (c2) cross-card merge (all-gather of (o, m, l) over the "
        f"sequence's ranks + softmax_merge, CUDA events after the shard's "
        f"attention and after the merge, summed over the layers) ms a "
        f"decode step by card "
        f"{[[round(x, 3) for x in m] for m in r['merge_ms']]}"
        f"; share of card 0's step wall "
        f"{[round(x, 4) for x in shares]} (median "
        f"{statistics.median(shares):.4f}); launches {t}, by card {c}; "
        f"{smi_line}")
    _log_held("c2", tuple(r["mesh"]), r["held"], smi_line)


def _rounded(x, digits=4):
    """Nested lists of floats, each to `digits` significant digits."""
    if isinstance(x, (list, tuple)):
        return [_rounded(v, digits) for v in x]
    return float(f"{x:.{digits}g}")


def log_long(r, smi_line):
    """(c3)'s lines: its kernels held at its shard shapes on every card and
    the first step's chosen ids exact (fail otherwise); its numbers against
    the unsharded run reported."""
    t, c = _launch_totals(r["launches"])
    walls = r["walls"]
    share = lambda key: [[round(ms / (w * 1e3), 4) for ms, w in
                          zip(per, walls)] for per in r[key]]
    first = [round(x, 4) for x in r["overlap_by_step_layer"][0]]
    control = [round(x, 4) for x in r["control_overlap_by_step_layer"][0]]
    log(f"[dist] (c3) long_500k decode: V2-Lite as published "
        f"({r['layers']} layers) in bf16, KERNELS, one row on a "
        f"{tuple(r['mesh'])} (data, model) NCCL mesh on (c2)'s weights, "
        f"{LONG_SLOTS} slots drawn N(0, 1) on the cards (each its own "
        f"{LONG_SLOTS // len(r['peak_gib'])} rows, {r['fill_s']:.2f} s), "
        f"selection_k {LONG_K}, {LONG_STEPS} steps at slots "
        f"{LONG_SLOTS - LONG_STEPS}-{LONG_SLOTS - 1} fed card 0's unsharded "
        f"greedy tokens; against the unsharded run: logits max|diff| by step "
        f"{[float(f'{x:.4g}') for x in r['logits_max_abs_diff']]}, top-1 "
        f"equal {r['top1_equal']}, chosen-set overlap by layer, step 0 "
        f"{first}, least over steps and layers "
        f"{min(min(x) for x in r['overlap_by_step_layer']):.4f}; decode "
        f"steps sharded " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
        + " ms, unsharded " + ", ".join(f"{w * 1e3:.1f}"
                                          for w in r["unsharded_walls"])
        + f" ms; peak GiB by card {[round(p, 2) for p in r['peak_gib']]} "
        f"(unsharded on card 0 {r['unsharded_peak_gib']:.2f}); launches "
        f"{t}, by card {c}; {smi_line}")
    log(f"[dist] (c3) the control, the same steps unsharded through the "
        f"PLAIN ops against KERNELS (bf16 rounded elsewhere, no mesh): "
        f"chosen-set overlap by layer, step 0 {control}, logits max|diff| "
        f"by step {[float(f'{x:.4g}') for x in r['control_logits_max_abs_diff']]}"
        f"; {smi_line}")
    log(f"[dist] (c3) a decode step's parts by card, CUDA events summed over "
        f"the layers, ms a step: selection (scores, the shard's top k, the "
        f"candidates' all-gather) {r['select_ms']}, attend (sparse_select) "
        f"{r['attend_ms']}, merge (the partials' all-gather, softmax_merge) "
        f"{r['merge_ms']}; share of the step wall by card: selection "
        f"{share('select_ms')}, merge {share('merge_ms')}; step 0's kb by "
        f"card, layer by layer {r['kb_first_step']}; {smi_line}")
    log(f"[dist] (c3) step 0, every layer: the chosen ids equal "
        f"top_k_lowest_first over the all-gathered scores, by card "
        f"{[all(e) for e in r['exact']]}; {smi_line}")
    p, pc, pa = r["pinned"], r["pinned_control"], r["pinned_all"]
    log(f"[dist] (c3) C.7's bf16 split, by step and layer against the "
        f"unsharded KERNELS run: chosen-set overlap, the sharded run "
        f"unpinned {_rounded(r['overlap_by_step_layer'])}, pinned to the "
        f"unsharded routes {_rounded(p['overlap_by_step_layer'])}, the PLAIN "
        f"control pinned {_rounded(pc['overlap_by_step_layer'])}; logits "
        f"max|diff| by step, pinned {_rounded(p['logits_max_abs_diff'])}, "
        f"the pinned control {_rounded(pc['logits_max_abs_diff'])}; top-1 "
        f"equal pinned {p['top1_equal']}, the pinned control "
        f"{pc['top1_equal']}; the written entries' max|diff| by step and "
        f"layer, unpinned {_rounded(r['entry_err_by_step_layer'])}, pinned "
        f"{_rounded(p['entry_err_by_step_layer'])}, the pinned control "
        f"{_rounded(pc['entry_err_by_step_layer'])}; {smi_line}")
    log(f"[dist] (c3) the sharded run pinned to the unsharded routes and "
        f"chosen sets (each layer's own choice recorded, the unsharded rows "
        f"attended): its own chosen sets' overlap by step and layer "
        f"{_rounded(pa['overlap_by_step_layer'])}; logits max|diff| by step "
        f"{_rounded(pa['logits_max_abs_diff'])}, top-1 equal "
        f"{pa['top1_equal']}; the written entries' max|diff| by step and "
        f"layer {_rounded(pa['entry_err_by_step_layer'])}; {smi_line}")
    _log_held("c3", tuple(r["mesh"]), r["held"], smi_line)
    bad = [card for card, e in enumerate(r["exact"]) if not all(e)]
    if bad:
        fail(f"(5e) (c3) chosen ids differ from the top k of the gathered "
             f"scores on cards {bad}: {r['exact']}")
    if not p["routes_pinned"]:
        fail("(5e) (c3) the pinned sharded run's routes are not the "
             "unsharded run's")


def _near_tie(flip):
    """Whether a chosen-set difference (chosen_differences') is a near-tie:
    the unsharded k-th and (k + 1)-th scores, and every differing id's
    score and the k-th, within SEL_NEAR_TIE relative."""
    return flip[2] <= SEL_NEAR_TIE and all(abs(d) <= SEL_NEAR_TIE
                                           for _, d in flip[3])


def log_long_f32(r, wall, smi_line):
    """(c5)'s lines; fail unless, pinned to the unsharded routes and chosen
    sets, each layer's own chosen set equals the unsharded run's but for
    near-ties (_near_tie) and the logits are within SERVE_TOL every step;
    unless, pinned to the routes alone, the first chosen set that differs
    is a near-tie and the logits before its step are within SERVE_TOL;
    unless the unpinned run's routes equal the unsharded run's but for at
    most MAX_FLIPS near-ties (router margin < NEAR_TIE); and unless every
    kernel's first call on each card is within TOL."""
    t, c = _launch_totals(r["launches"])
    log(f"[dist] (c5) C.7's check in f32: V2-Lite at full width cut to "
        f"{r['layers']} of 27 layers ({r['params']} parameters, sharded in "
        f"{r['init_s']:.2f} s), KERNELS, long_500k's decode: one row on a "
        f"{tuple(r['mesh'])} (data, model) NCCL mesh, {LONG_SLOTS} slots "
        f"drawn N(0, 1) on the cards ({r['fill_s']:.2f} s), selection_k "
        f"{LONG_K}, {LONG_STEPS} steps at slots {LONG_SLOTS - LONG_STEPS}-"
        f"{LONG_SLOTS - 1} fed card 0's unsharded greedy tokens, "
        f"{r['routes']} MoE calls; decode steps unsharded "
        + ", ".join(f"{w * 1e3:.1f}" for w in r["unsharded_walls"])
        + f" ms; peak GiB by card (the pinned run) "
        f"{[round(p, 2) for p in r['peak_gib']]}, unsharded on card 0 "
        f"{r['unsharded_peak_gib']:.2f}; launches {t}, by card {c}; part "
        f"wall {wall:.1f} s; {smi_line}")
    runs = {"pinned": "pinned to the unsharded routes and chosen sets (each "
                      "layer's own choice held, the unsharded rows "
                      "attended)",
            "routes_pinned": "pinned to the unsharded routes alone",
            "unpinned": "unpinned"}
    for name, what in runs.items():
        x = r[name]
        log(f"[dist] (c5) {what}, against the unsharded run: logits "
            f"max|diff| by step "
            f"{_rounded(x['logits_max_abs_diff'])} (within atol "
            f"{SERVE_TOL[0]:g}, rtol {SERVE_TOL[1]:g}: {x['logits_within']})"
            f", top-1 equal {x['top1_equal']}; chosen-set overlap by step "
            f"and layer {_rounded(x['overlap_by_step_layer'])}; sets that "
            f"differ at (step, layer, unsharded k-th/(k+1)-th gap, [(id, "
            f"its unsharded score less the k-th, relative)]) "
            f"{x['chosen_flips'] or 'none'}; the written entries' max|diff| "
            f"by step and layer {_rounded(x['entry_err_by_step_layer'])}; "
            f"routes " + ("equal" if not x["route_flips"] else
                          f"flipped at (call, token, router margin) "
                          f"{x['route_flips']}")
            + "; decode steps sharded "
            + ", ".join(f"{w * 1e3:.1f}" for w in x["walls"])
            + f" ms; {smi_line}")
    timed = r["timed"]
    log(f"[dist] (c5) the shard's kernels at the shapes the pinned run gave "
        f"them (each card's first call), CUDA events behind a spin, ms a "
        f"call by card: " + "; ".join(
            f"{k}: " + ", ".join(
                f"cuda:{i} {tm[k]['shapes']} {tm[k]['ms']:.4f} device, "
                f"{tm[k]['host_ms']:.4f} as issued, plain "
                f"{tm[k]['plain_ms']:.4f}, bound {tm[k]['bound_ms']:.5f} by "
                f"{tm[k]['bound_by']}" for i, tm in enumerate(timed)
                if k in tm)
            for k in ("sparse_select", "softmax_merge"))
        + f"; {smi_line}")
    _log_held("c5", tuple(r["mesh"]), r["held"], smi_line)
    p = r["pinned"]
    far = [f for f in p["chosen_flips"] if not _near_tie(f)]
    if far:
        fail(f"(5e) (c5) pinned: chosen sets differ beyond near-ties (gap "
             f"<= {SEL_NEAR_TIE:g}): {far}")
    if not all(p["logits_within"]):
        fail(f"(5e) (c5) pinned: logits beyond atol {SERVE_TOL[0]:g}, rtol "
             f"{SERVE_TOL[1]:g}: {p['logits_max_abs_diff']}")
    q = r["routes_pinned"]
    first = q["chosen_flips"][:1]
    upto = first[0][0] if first else LONG_STEPS
    if first and not _near_tie(first[0]):
        fail(f"(5e) (c5) pinned to the routes: the first chosen set that "
             f"differs is not a near-tie: {first}")
    if not all(q["logits_within"][:upto]):
        fail(f"(5e) (c5) pinned to the routes: logits beyond atol "
             f"{SERVE_TOL[0]:g}, rtol {SERVE_TOL[1]:g} before the first "
             f"flip: {q['logits_max_abs_diff']}")
    for x in (p, q):
        if x["route_flips"]:
            fail(f"(5e) (c5) pinned: routes not the unsharded run's: "
                 f"{x['route_flips']}")
    flips = r["unpinned"]["route_flips"]
    ties = [f for f in flips if f[2] is not None and f[2] < NEAR_TIE]
    if len(ties) < len(flips) or len(ties) > MAX_FLIPS:
        fail(f"(5e) (c5) unpinned: routes flipped beyond {MAX_FLIPS} "
             f"near-ties (router margin < {NEAR_TIE:g}): {flips}")


def log_families(r, wall, n_cards, smi_line):
    """(c4)'s lines: (a) and (b) a mesh each, each held against the
    unsharded run and the sharded PLAIN ops at FAMILY_TOL and its kernels'
    first calls at TOL (fail otherwise); (c)'s numbers reported beside its
    held first calls."""
    runs = [("c4a", x) for x in r["a"]] + \
        ([("c4b", r["b"])] if "b" in r else [])
    for part, x in runs:
        shape = tuple(x["mesh"])
        label = f"{shape}" + (", one row" if x["batch"] == 1 else "")
        t, c = _launch_totals(x["launches"])
        parts = [f"against {name} " + ", ".join(
            f"{k} {v:.3e}" for k, v in x[name]["errs"].items())
            for name in ("unsharded", "plain")]
        log(f"[dist] ({part}) {x['name']} at full width cut to {x['layers']}"
            f" layers in f32, KERNELS, on a {shape} (data, model) NCCL mesh "
            f"over {n_cards} card(s): prefill {x['batch']} x {MODEL_PROMPT} "
            f"into {SERVE_SLOTS} slots, {MODEL_STEPS} decode steps at slots "
            f"{MODEL_PROMPT}-{MODEL_PROMPT + MODEL_STEPS - 1}; "
            + "; ".join(parts) + f" (atol {FAMILY_TOL[0]:g}, rtol "
            f"{FAMILY_TOL[1]:g}); sharded {_fmt_walls(x['walls'])}; "
            f"unsharded {_fmt_walls(x['unsharded_walls'])}; peak GiB by card "
            f"{[round(p, 2) for p in x['peak_gib']]}; launches {t}, by card "
            f"{c}; part wall {wall:.1f} s; {smi_line}")
        _log_held(part, label, x["held"], smi_line)
        for name in ("unsharded", "plain"):
            if x[name]["beyond"]:
                fail(f"(5e) ({part}) {label}: against {name} beyond the "
                     f"limit in {x[name]['beyond']}: {x[name]['errs']}")
    if "c" not in r:
        return
    x = r["c"]
    t, c = _launch_totals(x["launches"])
    rows = [sum(col) for col in zip(*x["top1_by_row"])]
    shares = x["merge_share_card0"]
    log(f"[dist] (c4c) {x['name']} as published ({x['layers']} layers) in "
        f"bf16, KERNELS, on a {tuple(x['mesh'])} (data, model) NCCL mesh, "
        f"weights from seed 0 (sharded in {x['init_s']:.2f} s): prefill "
        f"{MODEL_BATCH} x {MODEL_PROMPT} into {SERVE_SLOTS} slots, "
        f"{MODEL_STEPS} decode steps fed card 0's unsharded greedy tokens; "
        f"against the unsharded run: last-token logits max|diff| "
        f"{x['last_token_max_abs_diff']:.4e}, decode logits max|diff| by "
        f"step {[float(f'{d:.4g}') for d in x['decode_max_abs_diff']]}, "
        f"top-1 agreement per row {rows} of {len(x['top1_by_row'])} "
        f"(prefill + {MODEL_STEPS} steps); sharded "
        f"{_fmt_walls(x['walls'])}; unsharded "
        f"{_fmt_walls(x['unsharded_walls'])}; peak GiB by card "
        f"{[round(p, 2) for p in x['peak_gib']]} (unsharded on card 0 "
        f"{x['unsharded_peak_gib']:.2f}); launches {t}, by card {c}; "
        f"{smi_line}")
    log(f"[dist] (c4c) cross-card merge of the shared block's decode "
        f"attention (all-gather of (o, m, l) over the sequence's ranks + "
        f"softmax_merge, CUDA events after the shard's attention and after "
        f"the merge, summed over the block's invocations) ms a decode step "
        f"by card {[[round(v, 3) for v in m] for m in x['merge_ms']]}; "
        f"share of card 0's step wall {[round(v, 4) for v in shares]} "
        f"(median {statistics.median(shares):.4f}); {smi_line}")
    _log_held("c4c", tuple(x["mesh"]), x["held"], smi_line)


# ---------------------------------------------------------------------------
# phase 5f: the example drivers (repro_torch.examples)
# ---------------------------------------------------------------------------

# train_mla_100m --full: the reference's step count (its --steps default);
# the phase's wall allows it in full
EXAMPLE_TRAIN_STEPS = 200


def echoed(name, fn, *args, **kw):
    """fn's result; its printed lines, each prefixed "[examples] name:",
    are logged after it returns or raises."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args, **kw)
    finally:
        for line in buf.getvalue().splitlines():
            log(f"[examples] {name}: {line}")


def example_train_profile(torch, dev, ex):
    """One step of train_mla_100m --full from fresh weights (seed 0) under
    the profiler, after a warm step: (device busy ms, top kernels)."""
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import model as M
    from repro_torch.models.module import trainable
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         cosine_schedule)
    from repro_torch.train.step import TrainConfig, make_train_step
    cfg = ex.build_config(True)
    params = trainable(M.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=torch.float32))
    ocfg = AdamWConfig(lr=1e-3)
    opt = adamw_init(params, ocfg)
    step = make_train_step(cfg, ocfg, TrainConfig(n_micro=2),
                           cosine_schedule(1e-3, warmup=20,
                                           total=EXAMPLE_TRAIN_STEPS))
    pipe = SyntheticPipeline.for_model(cfg, seq_len=128, global_batch=4,
                                       device=dev)
    step(params, opt, pipe.batch_at(0))
    _, busy_ms, top = profiled(torch, lambda: step(params, opt,
                                                   pipe.batch_at(1)))
    return busy_ms, top


def run_examples(torch, dev, counted, smi_line):
    """Phase 5f: the five example drivers in-process through run(), each
    counted apart. Returns (results, launches by example)."""
    from repro_torch.examples import (agentic_fanout, plan_execute,
                                      quickstart, serve_routed,
                                      train_mla_100m)
    atol = TOL["mla_decode"][0]
    res, by = {}, {}
    t0 = time.perf_counter()
    r, by["ex_quickstart"] = counted(
        lambda: echoed("quickstart", quickstart.run, "cuda"))
    log(f"[examples] quickstart: route+merge max|err| {r['route_err']:.3e}, "
        f"mla_decode kernel {r['kernel_err']:.3e} (atol {atol:g}); "
        f"launches {by['ex_quickstart']}")
    if not (r["route_err"] <= atol and r["kernel_err"] <= atol):
        fail(f"quickstart: errors {r['route_err']}, {r['kernel_err']}")
    _, by["ex_serve_routed"] = counted(
        lambda: echoed("serve_routed", serve_routed.run))
    r, by["ex_agentic_fanout"] = counted(
        lambda: echoed("agentic_fanout", agentic_fanout.run, "cuda"))
    log(f"[examples] agentic_fanout: routed fork decode max|err| "
        f"{r['max_err']:.3e} (< {agentic_fanout.TOL:g}); fan-in "
        f"{r['fan_in']}, replicate {r['replicate']}, holders {r['holders']}; "
        f"launches {by['ex_agentic_fanout']}")
    r, by["ex_plan_execute"] = counted(
        lambda: echoed("plan_execute", plan_execute.run, "cuda"))
    log(f"[examples] plan_execute: {r['steps']} steps, primitives and "
        f"latency equal to the analytic backend's every step, max|err| "
        f"{r['max_err']:.3e} (atol {plan_execute.ATOL:g}); {r['routed']} "
        f"routed, {r['fetched']} fetched of {r['dispatches']} dispatches; "
        f"launches {by['ex_plan_execute']}")
    res["plan_execute"] = r
    log(f"[examples] quickstart .. plan_execute wall "
        f"{time.perf_counter() - t0:.1f} s")

    # train_mla_100m --full: the ~100M configuration unreduced
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as d:
        log(f"[examples] train_mla_100m --full --steps "
            f"{EXAMPLE_TRAIN_STEPS} (the reference's count) --seq 128 "
            f"--batch 4")
        r, n = counted(lambda: echoed(
            "train_mla_100m", train_mla_100m.run, "cuda",
            EXAMPLE_TRAIN_STEPS, 128, 4, True, d))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if any(n.values()):
        fail(f"train_mla_100m launched kernels in its train steps: {n}")
    by["ex_train_mla_100m"] = n
    busy_ms, top = example_train_profile(torch, dev, train_mla_100m)
    walls = [w for _, _, w in r["ran"]]
    wall = statistics.median(walls[1:])           # the first step warms up
    back = [e["step"] for e in r["events"] if e.get("event") == "restored"]
    fault_at = r["steps"] // 2
    ran = [s for s, _, _ in r["ran"]]
    if len(back) != 1 or ran != list(range(fault_at)) + list(
            range(back[0], r["steps"])):
        fail(f"train_mla_100m: restores {r['events']}, steps run {ran} (want "
             f"one restore, to the last checkpoint before the failure at "
             f"step {fault_at}, and every step from there)")
    # the steps between the checkpoint and the failure ran twice (none when
    # the checkpoint is at the failed step itself)
    first, again = {}, {}
    for s, x, _ in r["ran"]:
        (again if s in first else first)[s] = x
    if any(again[s] != first[s] for s in again):
        fail(f"train_mla_100m: replayed losses {again} differ from their "
             f"first run")
    replay = (f"steps {back[0]}..{fault_at - 1} replayed bit for bit"
              if again else "a checkpoint at the failed step: nothing "
              "replayed")
    log(f"[examples] train_mla_100m {r['name']}: {r['params']} parameters "
        f"(f32 weights and AdamW moments), {r['steps']} steps of "
        f"{r['tokens_per_step']} tokens in {r['wall_s']:.1f} s "
        f"({r['steps_per_s']:.2f} steps/s, checkpoints and the restore "
        f"included); step wall median {wall * 1e3:.1f} ms ({min(walls) * 1e3:.1f}"
        f"-{max(walls) * 1e3:.1f}), {r['tokens_per_step'] / wall:.0f} "
        f"tokens/s; loss {r['losses'][0][1]:.4f} -> {r['losses'][-1][1]:.4f}"
        f" (first -> last logged); the failure before step {fault_at}, one "
        f"restore, to step {back[0]} ({replay}); checkpoints kept "
        f"{r['checkpoints']}; one step under the profiler: device busy "
        f"{busy_ms:.1f} ms = {100 * busy_ms / 1e3 / wall:.1f}% of the median "
        f"wall, top kernels ms {top}; max_memory_allocated {peak:.2f} GiB; "
        f"launches {n}; {smi_line}")
    res["train"] = {k: v for k, v in r.items() if k != "ran"}
    res["train"].update(step_s=wall, tokens_s=r["tokens_per_step"] / wall,
                        busy_ms=busy_ms, busy_share=busy_ms / 1e3 / wall,
                        peak_gib=peak)
    return res, by


def run_mesh_phases(torch, cfg, dev, kind, smi_line, counted, cards_of):
    """Phases 4c, 4d and 4e, each counted on its own: 4c the mesh on its
    default placement on one card (one slot; pinned to cuda:0 where more
    cards are visible), 4d the same over cuda:0 listed 4 times, bit for
    bit 4c, and 4e over every visible card where there are two or more,
    bit for bit 4c, with the peer pulls timed. Returns 4c's result and
    the launches by phase."""
    # 4c. the multi-instance backend: its default placement on one card
    # (one slot), pinned to cuda:0 where more cards are visible
    n_cards = torch.cuda.device_count()
    mesh_4c, mesh_launches = counted(lambda: run_mesh(
        torch, cfg, devices=None if n_cards == 1 else [dev]))
    log(f"[mesh] launches {mesh_launches}")
    # 4d. the same over four slots folded onto cuda:0: bit for bit 4c
    t0 = time.perf_counter()
    mesh_4d, slots_launches = counted(lambda: run_mesh(
        torch, cfg, devices=[dev] * 4, tag="4d"))
    d4_diff = outputs_diff(torch, mesh_4d["outs"], mesh_4c["outs"])
    log(f"[mesh] 4d: cuda:0 listed 4 times: {len(mesh_4d['outs'])} outputs "
        f"(serve fused / serial / depth 2, selection fused / serial, the "
        f"goldens in both modes) against 4c's: max|diff| {d4_diff:.3e} "
        f"(want 0); oracle {mesh_4d['worst']['oracle']:.3e}; launches "
        f"{slots_launches}; {time.perf_counter() - t0:.1f} s")
    if d4_diff != 0.0:
        fail(f"phase 4d: 4 slots on one card differ from 4c by {d4_diff!r}")
    report_slots("4d", mesh_4d, mesh_4c, 4, smi_line)
    # 4e. the same over every visible card, where two or more are
    cards_launches = None
    if n_cards >= 2:
        t0 = time.perf_counter()
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        mesh_4e, cards_launches = counted(lambda: run_mesh(
            torch, cfg, tag="4e"))
        # the phase's launches by card, before the next count clears them
        on_cards = {k: dict(sorted(cards_of(k).items()))
                    for k in MESH_KERNELS}
        e_diff = outputs_diff(torch, mesh_4e["outs"], mesh_4c["outs"])
        log(f"[mesh] 4e: {n_cards} cards {slot_names(cards)}: "
            f"{len(mesh_4e['outs'])} outputs against 4c's: max|diff| "
            f"{e_diff:.3e} (want 0); oracle {mesh_4e['worst']['oracle']:.3e}"
            f"; launches {cards_launches}, by card {on_cards}; "
            f"{time.perf_counter() - t0:.1f} s")
        if e_diff != 0.0:
            fail(f"phase 4e: {n_cards} cards differ from 4c by {e_diff!r}")
        off_zero = [k for k, v in on_cards.items()
                    if not any(c != 0 and n > 0 for c, n in v.items())]
        if off_zero:
            fail(f"phase 4e: {off_zero} launched on no card but cuda:0")
        report_slots("4e", mesh_4e, mesh_4c, n_cards, smi_line)
        peer_pulls(torch, cards, smi_line)
    else:
        log(f"[mesh] 4e did not run: {n_cards} card visible (it needs two "
            f"or more: the copy between two cards and peer access run only "
            f"there); 4d ran every other part of the multi-card logic on "
            f"{kind}")
    return mesh_4c, {"mesh": mesh_launches, "mesh_4_slots": slots_launches,
                     **({"mesh_cards": cards_launches} if cards_launches
                        else {})}


def main(mesh_only: bool = False, dist_only: bool = False) -> int:
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is false: this "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"[chip_smoke] FAIL: {SRC}/repro_torch not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    t_all = time.perf_counter()

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"[device] {kind}; count {torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; {smi_line}")
    dev = torch.device("cuda", 0)

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    took = build.build_all()
    log(f"[build] {len(took)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s (nvcc in parallel: "
        + ", ".join(f"{k} {v[0]:.1f} s" for k, v in took.items()) + ")")
    for name, (_, ptxas) in took.items():       # registers and spills
        log(f"[build] {name}.cu ptxas -v: " + " | ".join(ptxas))

    # the launch counters: every counter is zeroed just before each phase
    # of the main path (4-5f) and read just after
    from repro_torch.kernels.delta_rotate import ops as rot_ops
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.mla_decode import ops as mla_ops
    from repro_torch.kernels.softmax_merge import ops as merge_ops
    from repro_torch.kernels.sparse_select import ops as sel_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    wrappers = {"mla_decode": mla_ops.mla_decode,
                "softmax_merge": merge_ops.softmax_merge,
                "delta_rotate": rot_ops.delta_rotate,
                "sparse_select": sel_ops.sparse_select,
                "flash_prefill": fp_ops.flash_prefill,
                "ssd_chunk": ssd_ops.ssd_intra_chunk}
    # flash_prefill's wrapper counts its two kernels apart
    by_dtype = fp_ops.flash_prefill.launches_by_dtype
    fp_cards = fp_ops.flash_prefill.launches_by_card
    # each kernel's launches by card, summed over every counted phase
    by_card = {k: {} for k in KERNELS}

    def cards_of(name):
        if name.startswith("flash_prefill"):
            return fp_cards["bfloat16" if name.endswith("bf16")
                            else "float32"]
        return wrappers[name].launches_by_card

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        for k in by_dtype:
            by_dtype[k] = 0
        for name in KERNELS:
            cards_of(name).clear()
        result = fn()
        torch.cuda.synchronize()
        n = {k: w.launches for k, w in wrappers.items()}
        n["flash_prefill"] = by_dtype["float32"]
        n["flash_prefill_bf16"] = by_dtype["bfloat16"]
        for name, tot in by_card.items():
            for card, c in cards_of(name).items():
                tot[card] = tot.get(card, 0) + c
        return result, n

    if dist_only:           # phase 5e (c1)-(f) alone (a run on four cards)
        t0 = time.perf_counter()
        _, total, cards = run_dist_serve(torch, smi_line)
        log(f"[dist] (c1)-(c5), (d), (e) and (f) alone: "
            f"{time.perf_counter() - t0:.1f} s; "
            f"launches {total}; by card {cards}; {smi_line}")
        print(smi_line)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if mesh_only:           # phases 4c-4e alone (a run on several cards)
        from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA as cfg
        t0 = time.perf_counter()
        run_mesh_phases(torch, cfg, dev, kind, smi_line, counted, cards_of)
        log(f"[mesh] phases 4c-4e alone: {time.perf_counter() - t0:.1f} s; "
            f"launches by card {by_card}; {smi_line}")
        return 0

    # 3. kernels against plain versions
    from repro_torch.configs import deepseek_v2_lite, mamba2_370m, zamba2_7b
    from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA as cfg
    v2_lite, mamba2 = deepseek_v2_lite.config(), mamba2_370m.config()
    zamba2 = zamba2_7b.config()
    checks = {"mla_decode": check_mla_decode(torch, dev, cfg),
              "softmax_merge": check_softmax_merge(torch, dev, cfg),
              "delta_rotate": check_delta_rotate(torch, dev, cfg),
              "sparse_select": check_sparse_select(torch, dev, cfg),
              "flash_prefill": check_flash_prefill(torch, dev, cfg,
                                                   torch.float32),
              "flash_prefill_bf16": check_flash_prefill(torch, dev, cfg,
                                                        torch.bfloat16),
              "ssd_chunk": check_ssd_chunk(torch, dev, mamba2.ssm,
                                           zamba2.ssm)}

    # 3b. the long_500k decode of 5e (c3), unsharded, on this card
    long_res, long_launches = counted(
        lambda: long_unsharded_peak(torch, dev, v2_lite))

    from repro_torch.launch import serve

    def run_serve(extra):
        argv = ["--backend", "exec", "--device", "cuda", "--exec-geometry",
                "v2-lite", "--verify"] + extra
        log(f"[serve] repro_torch.launch.serve {' '.join(argv)}")
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = buf.getvalue()
        sys.stdout.write(out)
        errs = [float(x) for x in re.findall(r"max\|err\| (\S+)", out)]
        if len(errs) != 5 or not all(e <= ORACLE_ATOL for e in errs):
            fail(f"serve {extra}: per-step max|err| {errs} (want 5 steps, "
                 f"each <= {ORACLE_ATOL:g})")
        return wall, out

    (serve_s, _), serve_launches = counted(
        lambda: run_serve(["--selection-frac", "0"]))
    log(f"[serve] {serve_s:.2f} s wall; every step within {ORACLE_ATOL:g} "
        f"of the oracle; launches {serve_launches}")
    (sel_s, sel_out), sel_launches = counted(lambda: run_serve(
        ["--selection", "--selection-frac", "0.5", "--selection-k", "512"]))
    found = re.search(r"selector=indexer, (\d+) selected pairs", sel_out)
    n_selected = int(found.group(1)) if found else 0
    if n_selected <= 0:
        fail("selection serve: no selected pairs")
    log(f"[serve] selection: {sel_s:.2f} s wall; {n_selected} selected "
        f"pairs; every step within {ORACLE_ATOL:g} of the selection oracle; "
        f"launches {sel_launches}")
    # 4c-4e. the multi-instance backend
    mesh_4c, mesh_phases = run_mesh_phases(torch, cfg, dev, kind, smi_line,
                                           counted, cards_of)
    mesh_walls, mesh_worst = mesh_4c["walls"], mesh_4c["worst"]
    mesh_conc, mesh_index = mesh_4c["conc"], mesh_4c["index"]
    log(f"[mesh] index stage, scored on the holder's stream "
        f"(ShardMapIndexerService), median wall a call: "
        + ", ".join(f"{mode} {w['median_us']:.2f} us over {w['n']} calls "
                    f"({w['min_us']:.2f}-{w['max_us']:.2f})" for mode, w in
                    ((m, mesh_index[m]) for m in ("serial", "fused")))
        + f"; analytic median {mesh_index['analytic_us']:.2f} us; host "
        f"scoring (the earlier service), serial: {INDEX_HOST_US} us (analytic "
        f"{INDEX_ANALYTIC_US}); blocks equal to the host IndexerService's "
        f"for all {mesh_index['pairs']} (step, request, chunk) of the "
        f"selection serves and the selection scenario; {smi_line}")
    (golden_err, sel_golden_err), golden_launches = counted(
        lambda: (run_goldens(torch, cfg), run_selection_goldens(torch, cfg)))

    # 5b. the model's serving form
    t0 = time.perf_counter()
    _, full_launches = counted(lambda: model_full_bf16(torch, dev, v2_lite))
    cut = dataclasses.replace(v2_lite, n_layers=4)
    sel = dataclasses.replace(cut, selection_k=512)
    log(f"[model] (b) {cut.name} at full width in f32, depth cut from "
        f"{v2_lite.n_layers} to {cut.n_layers} layers ({cut.first_k_dense} "
        f"dense + {cut.n_layers - cut.first_k_dense} MoE; the f32 weights of "
        f"all 27 would not leave room), prefill {MODEL_BATCH} x "
        f"{VERIFY_PROMPT} tokens: kernels against plain versions")
    (v_errs, n_routes, _, _), verify_launches = counted(lambda: model_verify(
        torch, dev, cut, MODEL_TOL["v2_lite"],
        [cut] * MODEL_STEPS + [sel] * 2, "V2-Lite f32 cut", VERIFY_PROMPT))
    log(f"[model] (b) {n_routes} MoE routes equal in both runs; max|err| "
        f"prefill logits {v_errs['prefill']:.3e}, latent caches "
        f"{v_errs['caches']:.3e}, decode logits ({MODEL_STEPS} steps + 2 "
        f"with selection_k {sel.selection_k}) {v_errs['decode']:.3e} (atol "
        f"{MODEL_TOL['v2_lite'][0]:g}, rtol {MODEL_TOL['v2_lite'][1]:g})")
    (m_errs, _, mk, _), mamba_launches = counted(lambda: model_verify(
        torch, dev, mamba2, MODEL_TOL["mamba2"], [mamba2] * MODEL_STEPS,
        "Mamba2-370m f32", MODEL_PROMPT))
    log(f"[model] (c) {mamba2.name} full config ({mamba2.n_layers} layers) "
        f"in f32: prefill {MODEL_BATCH} x {MODEL_PROMPT} tokens "
        f"{mk['prefill_s']:.3f} s, decode steps "
        + ", ".join(f"{w * 1e3:.1f}" for w in mk["decode_s"])
        + f" ms; max|err| kernels vs plain: prefill logits "
        f"{m_errs['prefill']:.3e}, states {m_errs['caches']:.3e}, decode "
        f"logits {m_errs['decode']:.3e} (atol {MODEL_TOL['mamba2'][0]:g}, "
        f"rtol {MODEL_TOL['mamba2'][1]:g})")
    d_errs, layer_launches = counted(
        lambda: mla_layer_bf16(torch, dev, v2_lite))
    if (layer_launches["flash_prefill_bf16"], layer_launches["flash_prefill"]) \
            != (1, 0):
        fail(f"(d) launched flash_prefill bf16 "
             f"{layer_launches['flash_prefill_bf16']} and f32 "
             f"{layer_launches['flash_prefill']} times, want 1 and 0")
    model_s = time.perf_counter() - t0

    # 5c. the training path
    t0 = time.perf_counter()
    train_res, train_launches = run_training(torch, dev, v2_lite, mamba2,
                                             counted, smi_line)
    train_s = time.perf_counter() - t0

    # 5d. the model families
    t0 = time.perf_counter()
    fam_res, fam_launches = run_families(torch, dev, zamba2, counted)
    fam_s = time.perf_counter() - t0
    log(f"[families] phase 5d wall {fam_s:.1f} s; launches by part "
        f"{fam_launches}")

    # 5e. distribution: the sharded train step, the production dry run,
    # the sharded serve over NCCL
    t0 = time.perf_counter()
    dist_res, dist_launches = run_distribution(torch, smi_line)
    t1 = time.perf_counter()
    sharded_res, sharded_launches, sharded_cards = run_dist_serve(torch,
                                                                  smi_line)
    sharded_s = time.perf_counter() - t1
    for name, per_card in sharded_cards.items():
        for card, n in per_card.items():
            by_card[name][card] = by_card[name].get(card, 0) + n
    dist_s = time.perf_counter() - t0
    log(f"[dist] phase 5e wall {dist_s:.1f} s; {smi_line}")

    # 5f. the example drivers
    t0 = time.perf_counter()
    ex_res, ex_launches = run_examples(torch, dev, counted, smi_line)
    ex_s = time.perf_counter() - t0
    log(f"[examples] phase 5f wall {ex_s:.1f} s; launches by example "
        f"{ex_launches}")
    by_phase = {"long_500k_unsharded": long_launches,
                "serve": serve_launches, "selection_serve": sel_launches,
                **mesh_phases,
                "goldens": golden_launches, "model_v2_lite": full_launches,
                "model_verify": verify_launches,
                "model_mamba2": mamba_launches,
                "model_mla_bf16": layer_launches, **train_launches,
                **fam_launches,
                "dist_train": {k: dist_launches.get(k, 0) for k in checks},
                "dist_serve": sharded_launches,
                **ex_launches}
    launches = {k: sum(p[k] for p in by_phase.values()) for k in checks}

    # 6. proof of the path: the dense kernels over serve + goldens,
    # sparse_select over the selection serve + goldens, and the model's
    # kernels over the model phase
    log(f"[path] launches by phase: {by_phase}")
    log(f"[path] delta_rotate on the goldens: "
        f"{golden_launches['delta_rotate']} splices (fetch_heavy 3 + "
        f"mixed_congested 1), one launch each and no other device kernel "
        f"(phase 3)")
    missing = [k for k in ("mla_decode", "softmax_merge", "delta_rotate")
               if serve_launches[k] + golden_launches[k] <= 0]
    if sel_launches["sparse_select"] + golden_launches["sparse_select"] <= 0:
        missing.append("sparse_select")
    missing += [f"{k} ({ph})" for ph, n in mesh_phases.items()
                for k in MESH_KERNELS if n[k] <= 0]
    model_phases = (full_launches, verify_launches, mamba_launches,
                    layer_launches)
    missing += [f"{k} (model)" for k in ("flash_prefill",
                                         "flash_prefill_bf16", "ssd_chunk",
                                         "mla_decode")
                if sum(p[k] for p in model_phases) <= 0]
    if fam_launches["families_zamba2"]["ssd_chunk"] <= 0:
        missing.append("ssd_chunk (families)")
    if long_launches["sparse_select"] <= 0:   # one shard: no merge
        missing.append("sparse_select (long_500k)")
    missing += [f"{k} (dist_serve)" for k in SERVE_PATH["c1"]
                + FAMILY_PATH["a"] if sharded_launches[k] <= 0]
    # 5f: the routed decode of the examples on the kernels
    want_ex = {"ex_quickstart": ("mla_decode", "softmax_merge"),
               "ex_agentic_fanout": ("mla_decode",),
               "ex_plan_execute": ("mla_decode", "softmax_merge")
               + (("delta_rotate",) if ex_res["plan_execute"]["fetched"]
                  else ())}
    missing += [f"{k} ({ex})" for ex, ks in want_ex.items() for k in ks
                if ex_launches[ex][k] <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    # 7. report
    replaces = {
        "mla_decode": "src/repro/kernels/mla_decode/kernel.py:69",
        "softmax_merge": "src/repro/kernels/softmax_merge/kernel.py:33",
        "delta_rotate": "src/repro/kernels/delta_rotate/kernel.py:30",
        "sparse_select": "src/repro/kernels/sparse_select/kernel.py:58",
        "flash_prefill": "src/repro/kernels/flash_prefill/kernel.py:74",
        "flash_prefill_bf16": "src/repro/kernels/flash_prefill/kernel.py:74",
        "ssd_chunk": "src/repro/kernels/ssd_chunk/kernel.py:66"}
    # the representative main-path shape of each kernel: a 16-request
    # ROUTE group (m_q = 16) for mla_decode, M = 2 for softmax_merge, the
    # FETCH splice of a 2048-token chunk in f32, cold, for delta_rotate,
    # one request over 8 selected blocks for sparse_select, one 2048-token
    # sequence for flash_prefill (f32 and bf16 operands) and ssd_chunk
    pick = {"mla_decode": 1, "softmax_merge": 0, "delta_rotate": 0,
            "sparse_select": 0, "flash_prefill": 0, "flash_prefill_bf16": 0,
            "ssd_chunk": 0}
    kernels = []
    for name, (worst, cases) in checks.items():
        c = cases[pick[name]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "launches_by_phase": {ph: n[name] for ph, n in by_phase.items()},
            "launches_by_card": {f"cuda:{c}": v for c, v in
                                 sorted(by_card[name].items())},
            "max_abs_err": worst, "atol": TOL[name][0], "rtol": TOL[name][1],
            "shape": c["shape"], "ms": c["ms"], "host_ms": c["host_ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            **({"bound_3xtf32_ms": c["bound_3xtf32_ms"]}
               if "bound_3xtf32_ms" in c else {}),
            **({"copy_ms": c["copy_ms"]} if "copy_ms" in c else {}),
            "library_ms": c["library_ms"], "cases": cases})
    log(f"[summary] long_500k unsharded peak {long_res['peak_gib']:.2f} GiB "
        f"(cast: {long_res['peak_cast_gib']:.2f}), "
        f"serve {serve_s:.2f} s, selection serve {sel_s:.2f} s, "
        f"mesh serve {sum(mesh_walls.values()):.2f} s (oracle "
        f"{mesh_worst['oracle']:.3e}, fused vs serial "
        f"{mesh_worst['modes']:.3e}, {mesh_conc['streams']} streams), "
        f"goldens max|err| {golden_err:.3e}, selection goldens "
        f"{sel_golden_err:.3e}, (d) bf16 latent attention "
        f"{d_errs['latent attention']:.3e}, model phase {model_s:.1f} s, "
        f"training phase {train_s:.1f} s ((b) {train_res['b']['wall_s']:.3f}"
        f" s a step, (c) {train_res['c']['wall_s']:.3f} s; (d) served "
        f"{train_res['serve_rel']['pinned']:.3e} on equal routes, "
        f"{train_res['serve_rel']['own']:.3e} on the train form's; (e) f32 "
        f"vs f64 loss "
        f"{train_res['f64'][0]:.3e}, grad norm {train_res['f64'][1]:.3e}), "
        f"families phase {fam_s:.1f} s ((a) Zamba2-7B prefill "
        f"{fam_res['a']['warm_s']:.3f} s warm; (b) kernels vs plain "
        f"{max(fam_res['b'].values()):.3e}; (d) decode vs forward "
        f"{fam_res['d']['qwen3-32b']:.3e} GQA, "
        f"{fam_res['d']['zamba2-7b']:.3e} hybrid), distribution phase "
        f"{dist_s:.1f} s ((a) {dist_res['a_s']:.1f} s, (b) the "
        f"{DRYRUN_ARCH} dry run {dist_res['b_s']:.1f} s, dominant "
        f"{dist_res['record']['roofline']['dominant']}; "
        + ", ".join(f"{k} ok in {v['wall_s']:.1f} s"
                    for k, v in dist_res["cells"].items())
        + f"; the sharded serve {sharded_s:.1f} s: "
        + ", ".join(f"({k}) {v['wall_s']:.1f} s"
                    for k, v in sharded_res.items())
        + "), examples phase "
        f"{ex_s:.1f} s (train_mla_100m --full "
        f"{ex_res['train']['step_s'] * 1e3:.1f} ms a step, "
        f"{100 * ex_res['train']['busy_share']:.1f}% busy), mesh index "
        f"stage {mesh_index['serial']['median_us']:.2f} us median serial, "
        f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:3] == ["--dist-part", "a"]:     # phase 5e (a)'s process
        import torch
        sys.path.insert(0, SRC)
        dist_part_a(torch, *sys.argv[3:4])
        sys.exit(0)
    if sys.argv[1:3] == ["--dist-part", "f"]:     # (f) with its lines
        sys.exit(dist_part_f())
    if sys.argv[1:2] == ["--dist-part"] and sys.argv[2:3] in (
            ["c1"], ["c2"], ["c4"], ["c5"], ["d"], ["e"], ["f-ranks"]):
        # (c1)-(c5), (d), (e) or (f)'s ranks
        dist_serve_part(sys.argv[2].removesuffix("-ranks"))
        sys.exit(0)
    sys.exit(main(mesh_only=sys.argv[1:2] == ["--mesh-only"],
                  dist_only=sys.argv[1:2] == ["--dist-only"]))
