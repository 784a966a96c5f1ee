#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (src/repro_torch).

    python3 chip_smoke.py

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
   step's kernels by stream under the profiler;
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
6. proof of the path — each kernel's launch counter, zeroed before each of
   phases 4, 4b, 4c, 5, the four parts of 5b, the parts of 5c and of 5d
   and read after it, is > 0 over the phases that run it (4c alone runs
   all four exec kernels; flash_prefill's f32 and bf16 kernels
   counted apart: (a) launches the bf16 one once per layer in each prefill
   and the f32 one never, (d) the bf16 one once), and 0 for every kernel
   in the train steps of 5c, whose (d) launches the bf16 flash_prefill
   once per layer and nothing else; in 5d, ssd_chunk once per Mamba2 layer
   in each prefill of (a) and (b) and nothing else, and no kernel in (c);
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
        cases.append({"shape": f"q({B},{R},{D}) ckv({B},{S},{D})",
                      "loop": plan.loop, "n_split": plan.n_split,
                      "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "device_us_by_kernel": split, "loops_ms": loops_ms})
        log(f"[kernels] mla_decode {tag}: loop {plan.loop} x "
            f"{plan.n_split} spans, {ms:.4f} ms device, "
            f"{host_ms:.4f} ms as issued (plain "
            f"{plain_ms:.4f}, sdpa {lib_ms}, bound {b_ms:.5f} by {b_by}); "
            + "".join(f"{k} {v:.4f} ms; " for k, v in loops_ms.items())
            + "profiler µs/call " + ", ".join(f"{k} {v:.1f}"
                                              for k, v in split.items()))

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
        cases.append({"shape": f"q({B},{R},{D}) ckv({B},{S},{D}) "
                               f"{tag}, {t_sel} selected rows",
                      "loop": plan.loop, "n_split": plan.n_split,
                      "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "mla_decode_gathered_ms": dense_ms,
                      "bits_equal_mla_decode_gathered": bits,
                      **({"resources": res} if not cases else {})})
        log(f"[kernels] sparse_select {tag}: loop {plan.loop} x "
            f"{plan.n_split} spans, {ms:.4f} ms device, {host_ms:.4f} ms as "
            f"issued (plain {plain_ms:.4f}, sdpa with mask {lib_ms}, bound "
            f"{b_ms:.5f} by {b_by}; mla_decode over the gathered rows "
            f"{dense_ms}, bits equal: {bits})")
    return worst, cases


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


def run_mesh_serve(torch, serve, extra, device="cuda"):
    """The serve CLI through --backend shard_map at V2-Lite width: every
    step within ORACLE_ATOL of its oracle and a measured report with no
    filled stage."""
    argv = (["--backend", "shard_map", "--device", device, "--exec-geometry",
             "v2-lite", "--verify", "--intra-fabric", MESH_FABRICS[0],
             "--cross-fabric", MESH_FABRICS[1]] + extra)
    log(f"[mesh] repro_torch.launch.serve {' '.join(argv)}")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eng = serve.main(argv)
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


def profile_mesh_step(torch, serve):
    """One fused step of the serve default world (after a warm step) under
    the profiler: the streams its kernels ran on and how much of the busy
    time had more than one kernel running."""
    args = serve.build_parser().parse_args(
        ["--backend", "shard_map", "--device", "cuda", "--exec-geometry",
         "v2-lite", "--selection-frac", "0", "--intra-fabric",
         MESH_FABRICS[0], "--cross-fabric", MESH_FABRICS[1]])
    eng = serve.build_engine(args)
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


def run_mesh_goldens(torch, cfg, device="cuda"):
    """The three dense goldens and the selection scenario (priced on the
    H100 fabrics) through ShardMapExecBackend, fused and serial: StepStats
    equal to the analytic run, outputs within ORACLE_ATOL of the oracle,
    fused against serial within MESH_MODES_ATOL, no filled stage on any
    planned step."""
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
        svcs[be.fused] = ShardMapIndexerService(mla=cfg, device=device)
        return sel_build(be, svcs[be.fused])[0]
    cases.append(("selection_scenario", with_indexer, None))
    for name, build, ana_steps in cases:
        engines = {}
        for mode in ("fused", "serial"):
            be = ShardMapExecBackend(cfg, device=device,
                                     fused=mode == "fused")
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


def run_mesh(torch, cfg, device="cuda"):
    """Phase 4c: the serve world and the selection serve through the mesh
    backend (fused, --serial-exec, fused at --pipeline-depth 2), the
    goldens in both modes, and one fused step's streams."""
    from repro_torch.launch import serve
    dense, sel = ["--selection-frac", "0"], [
        "--selection", "--selection-frac", "0.5", "--selection-k", "512"]
    walls, stage = {}, {}
    for label, extra in (("fused", dense), ("serial", dense + [
            "--serial-exec"]), ("fused depth 2", dense + [
                "--pipeline-depth", "2"]), ("selection fused", sel),
            ("selection serial", sel + ["--serial-exec"])):
        walls[label], eng = run_mesh_serve(torch, serve, extra, device)
        stage[label] = stage_rows(eng.backend.stage_log.values())
        log_step_totals(f"serve {label}", eng.backend)
        log_stage_rows(f"serve {label}", stage[label], eng.backend.fused)
        if eng.backend.fused:
            log(f"[mesh] serve {label}: phase_wall_total "
                + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                            eng.backend.phase_wall_total.items()))
            stage[label + " phase_wall_total_s"] = dict(
                eng.backend.phase_wall_total)
        log(f"[mesh] serve {label}: {walls[label]:.2f} s wall, every step "
            f"within {ORACLE_ATOL:g} of its oracle")
    worst, logs = run_mesh_goldens(torch, cfg, device)
    for mode in ("fused", "serial"):
        stage[f"goldens {mode}"] = stage_rows(logs[mode])
        log_stage_rows(f"goldens {mode}", stage[f"goldens {mode}"],
                       mode == "fused")
    conc = (profile_mesh_step(torch, serve) if device == "cuda"
            else {"streams": 0})
    return walls, worst, conc


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
              feed=None, routes=None, profile_last=False):
    """prefill batch ({"tokens": (B, S)} and the family's stub inputs)
    through the entry points, then one decode_step per config of step_cfgs
    on a cache of the context (S, and the VLM's patches) plus
    len(step_cfgs) slots holding the prefill caches (fill_decode_state).
    Greedy tokens, or `feed`'s. Returns the prefill logits and caches, the
    decode logits, the tokens fed, the state after the last step and the
    walls; with profile_last, the last step's device busy time and top
    kernels (that step runs under the profiler, its wall is not kept)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    S += cfg.vlm_patches if cfg.family == "vlm" else 0
    dev = tokens.device
    t0 = time.perf_counter()
    logits, caches = M.prefill(params, cfg, batch, ops=ops, routes=routes)
    torch.cuda.synchronize(dev)
    t_prefill = time.perf_counter() - t0
    state = M.fill_decode_state(cfg, M.init_decode_state(
        cfg, B, S + len(step_cfgs), dtype=dtype, device=dev), caches)
    tok = logits.argmax(-1)
    fed, outs, walls, prof = [], [], [], None
    for i, scfg in enumerate(step_cfgs):
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
            "state": state, "prefill_s": t_prefill, "decode_s": walls,
            "profile": prof}


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
DIST_TIMEOUT = {"a": 300, "b": 900}            # seconds, each subprocess
DRYRUN_ARCH = "deepseek-v2-236b"


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
    from repro_torch.kernels.delta_rotate import ops as rot_ops
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.mla_decode import ops as mla_ops
    from repro_torch.kernels.softmax_merge import ops as merge_ops
    from repro_torch.kernels.sparse_select import ops as sel_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
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
    wrappers = {"mla_decode": mla_ops.mla_decode,
                "softmax_merge": merge_ops.softmax_merge,
                "delta_rotate": rot_ops.delta_rotate,
                "sparse_select": sel_ops.sparse_select,
                "flash_prefill": fp_ops.flash_prefill,
                "ssd_chunk": ssd_ops.ssd_intra_chunk}
    by_dtype = fp_ops.flash_prefill.launches_by_dtype
    for w in wrappers.values():
        w.launches = 0
    for k in by_dtype:
        by_dtype[k] = 0
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
    launches = {k: w.launches for k, w in wrappers.items()}
    launches["flash_prefill"] = by_dtype["float32"]
    launches["flash_prefill_bf16"] = by_dtype["bfloat16"]

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


def run_subprocess_part(part, argv):
    """Run argv (a part of phase 5e) in a subprocess with its timeout;
    echo its output; fail on a non-zero exit or a timeout."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    try:
        res = subprocess.run(argv, capture_output=True, text=True, env=env,
                             timeout=DIST_TIMEOUT[part], cwd=ROOT)
    except subprocess.TimeoutExpired:
        fail(f"(5e) ({part}) did not end within {DIST_TIMEOUT[part]} s")
    wall = time.perf_counter() - t0
    sys.stdout.write(res.stdout)
    if res.returncode != 0:
        fail(f"(5e) ({part}) exited {res.returncode}: "
             f"{res.stderr.strip()[-3000:]}")
    return res.stdout, wall


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

    rec_path = os.path.join(ROOT, "build", "dryrun_torch",
                            "deepseek_v2_236b__train_4k__pod1.json")
    if os.path.exists(rec_path):
        os.remove(rec_path)
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            DRYRUN_ARCH]
    log(f"[dist] (b) {' '.join(argv[1:])} (no --smoke): the full config's "
        "train_4k on the (16, 16) mesh over a fake group, on meta tensors")
    _, b_wall = run_subprocess_part("b", argv)
    with open(rec_path) as fh:
        rec = json.load(fh)
    if not rec.get("ok"):
        fail(f"(5e) (b) the dry run's record is not ok: {rec.get('error')}")
    mem, col, roof = rec["memory"], rec["collectives"], rec["roofline"]
    gib = lambda b: b / 2**30
    log(f"[dist] (b) {rec['arch']} {rec['shape']} on {rec['mesh']} "
        f"({rec['n_devices']} devices, {rec['n_params']} parameters, "
        f"{rec['n_layers']} layers, depth cut {rec['depth_cut']}, n_micro "
        f"{rec['n_micro']}, ops {rec['ops'].split(' ')[0]}): per device "
        f"argument bytes {mem['argument_bytes']} ({gib(mem['argument_bytes']):.2f}"
        f" GiB), peak temporary {mem['peak_temp_bytes']} "
        f"({gib(mem['peak_temp_bytes']):.2f} GiB), together "
        f"{gib(mem['device_bytes']):.2f} GiB against "
        f"{gib(mem['hbm_bytes']):.0f} GiB (fits {mem['fits']}); FLOPs "
        f"{rec['flops']:.6e}; traffic bytes {rec['traffic_bytes']:.6e}; "
        f"collectives {col['counts']}, result bytes "
        f"{col['result_bytes']:.6e}, wire bytes {col['wire_bytes']:.6e}; "
        f"roofline on one H100: compute {roof['compute_s']:.4f} s, memory "
        f"{roof['memory_s']:.4f} s, collective {roof['collective_s']:.4f} s "
        f"({roof['rates']['collective_fabric']} at "
        f"{roof['rates']['collective_Bps']:.3g} B/s), dominant "
        f"{roof['dominant']}; dry-run wall {b_wall:.1f} s on the host "
        f"(build {rec['t_build_s']} s, analyse {rec['t_analyse_s']} s); "
        f"{smi_line}")
    return {"a_s": a_wall, "b_s": b_wall, "record": rec}, r["launches"]


def main() -> int:
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

    # 4-5. the main path: serve, the selection serve, then the goldens;
    # every counter is zeroed just before each phase and read just after
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

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        for k in by_dtype:
            by_dtype[k] = 0
        result = fn()
        torch.cuda.synchronize()
        n = {k: w.launches for k, w in wrappers.items()}
        n["flash_prefill"] = by_dtype["float32"]
        n["flash_prefill_bf16"] = by_dtype["bfloat16"]
        return result, n

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
    # 4c. the multi-instance backend
    (mesh_walls, mesh_worst, mesh_conc), mesh_launches = counted(
        lambda: run_mesh(torch, cfg))
    log(f"[mesh] launches {mesh_launches}")
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

    # 5e. distribution: the sharded train step, the production dry run
    t0 = time.perf_counter()
    dist_res, dist_launches = run_distribution(torch, smi_line)
    dist_s = time.perf_counter() - t0
    log(f"[dist] phase 5e wall {dist_s:.1f} s; {smi_line}")
    by_phase = {"serve": serve_launches, "selection_serve": sel_launches,
                "mesh": mesh_launches,
                "goldens": golden_launches, "model_v2_lite": full_launches,
                "model_verify": verify_launches,
                "model_mamba2": mamba_launches,
                "model_mla_bf16": layer_launches, **train_launches,
                **fam_launches,
                "dist_train": {k: dist_launches.get(k, 0) for k in checks}}
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
    missing += [f"{k} (mesh)" for k in ("mla_decode", "softmax_merge",
                                        "delta_rotate", "sparse_select")
                if mesh_launches[k] <= 0]
    model_phases = (full_launches, verify_launches, mamba_launches,
                    layer_launches)
    missing += [f"{k} (model)" for k in ("flash_prefill",
                                         "flash_prefill_bf16", "ssd_chunk",
                                         "mla_decode")
                if sum(p[k] for p in model_phases) <= 0]
    if fam_launches["families_zamba2"]["ssd_chunk"] <= 0:
        missing.append("ssd_chunk (families)")
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
            "max_abs_err": worst, "atol": TOL[name][0], "rtol": TOL[name][1],
            "shape": c["shape"], "ms": c["ms"], "host_ms": c["host_ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            **({"bound_3xtf32_ms": c["bound_3xtf32_ms"]}
               if "bound_3xtf32_ms" in c else {}),
            **({"copy_ms": c["copy_ms"]} if "copy_ms" in c else {}),
            "library_ms": c["library_ms"], "cases": cases})
    log(f"[summary] serve {serve_s:.2f} s, selection serve {sel_s:.2f} s, "
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
        f"{dist_res['record']['roofline']['dominant']}), "
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
    sys.exit(main())
