#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (src/repro_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc (PATH, $CUDA_HOME or /usr/local/cuda) and the
repository's src/ beside this file; imports nothing of JAX or of the JAX
package. Phases, each fatal on failure:

1. device — require CUDA, disable TF32, print the card and its power limit;
2. build  — compile the four kernels from src/repro_torch/kernels/csrc
   (one nvcc per source, all at once) into build/kernels/;
3. kernels against their plain PyTorch versions on the card, at main-path
   shapes, with the tolerance printed beside the error reached; each timed
   with CUDA events next to its plain version (and SDPA for mla_decode and,
   with the selection as a boolean mask, for sparse_select);
4. serve  — repro_torch.launch.serve at DeepSeek-V2-Lite width over the
   CLI's default world, every step verified against the plain oracle;
4b. selection serve — the same world with the live indexer (--selection,
   half the sessions selecting 512 tokens), every step verified against
   the selection oracle, selected pairs > 0;
5. goldens — the routed_only / fetch_heavy / mixed_congested scenarios,
   the selection scenario and a FETCH forced under selection, at V2-Lite
   width: StepStats equal to the analytic backend's (replaying the live
   indexer's selections), outputs within tolerance of the oracle;
6. proof of the path — each kernel's launch counter, zeroed before each of
   phases 4, 4b and 5 and read after it, is > 0 over the phases that run
   it;
7. report — a JSON line of the kernels, the nvidia-smi line, and last the
   {"ok": true, "device": ...} line.
"""

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data-sheet peaks (at the 700 W limit): HBM3 bytes/s and f32
# operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# Tolerances, card kernel against its plain version, f32:
# mla_decode sums over S = 2048 rows and D = 576 columns in another order
# (tiled online softmax with rescaling vs one max then one sum), so it is
# held at 1e-5 absolute and relative; softmax_merge and delta_rotate round
# every product and sum as the plain version does, and are held at 1e-6.
# sparse_select sums over the selected rows in another order in the same
# way as mla_decode and is held to the same.
TOL = {"mla_decode": (1e-5, 1e-5), "softmax_merge": (1e-6, 0.0),
       "delta_rotate": (1e-6, 0.0), "sparse_select": (1e-5, 1e-5)}
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


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_mla_decode(torch, dev, cfg):
    from repro_torch.kernels.mla_decode import mla_decode, mla_decode_ref
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    atol, rtol = TOL["mla_decode"]
    D, d_v, scale = cfg.d_qk, cfg.kv_lora_rank, cfg.scale
    g = torch.Generator(device=dev).manual_seed(1)
    ckv = torch.randn((1, CHUNK, D), device=dev, generator=g)
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

    for m_q in (1, 16, 256):
        R = cfg.n_heads * m_q
        q = torch.randn((1, R, D), device=dev, generator=g)
        got = mla_decode(q, ckv, d_v=d_v, scale=scale)
        want = mla_decode_ref(q, ckv, None, d_v, scale)
        compare(f"m_q={m_q} ({R} rows x {CHUNK})", got, want)
        iters = 100 if m_q < 256 else 20
        ms, host_ms = time_ms(
            torch, lambda: mla_decode(q, ckv, d_v=d_v, scale=scale), iters)
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
        nbytes = 4 * (R * D + CHUNK * D + R * (d_v + 2))
        flops = 2.0 * R * CHUNK * (D + d_v)
        b_ms, b_by = bound(nbytes, flops)
        cases.append({"shape": f"q(1,{R},{D}) ckv(1,{CHUNK},{D})",
                      "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by})
        split = device_split_us(
            torch, lambda: mla_decode(q, ckv, d_v=d_v, scale=scale))
        cases[-1]["device_us_by_kernel"] = split
        log(f"[kernels] mla_decode m_q={m_q}: {ms:.4f} ms device, "
            f"{host_ms:.4f} ms as issued (plain "
            f"{plain_ms:.4f}, sdpa {lib_ms}, bound {b_ms:.5f} by {b_by}); "
            "profiler µs/call " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in split.items()))

    # ragged lengths with an empty row: the empty row is the identity
    B = 3
    q = torch.randn((B, cfg.n_heads, D), device=dev, generator=g)
    ck = torch.randn((B, CHUNK, D), device=dev, generator=g)
    lengths = torch.tensor([CHUNK, 1000, 0], dtype=torch.int32, device=dev)
    got = mla_decode(q, ck, lengths, d_v=d_v, scale=scale)
    compare("ragged [2048, 1000, 0]", got,
            mla_decode_ref(q, ck, lengths, d_v, scale))
    torch.cuda.synchronize()
    if not (bool((got.o[2] == 0).all()) and bool((got.l[2] == 0).all())
            and bool(torch.isneginf(got.m[2]).all())):
        fail("mla_decode: the length-0 row is not the identity")
    return worst, cases


def check_softmax_merge(torch, dev, cfg):
    from repro_torch.kernels.softmax_merge import (softmax_merge,
                                                   softmax_merge_ref)
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
    return worst, cases


def check_delta_rotate(torch, dev, cfg):
    from repro_torch.kernels.delta_rotate import (delta_cos_sin, delta_rotate,
                                                  delta_rotate_ref)
    atol, _ = TOL["delta_rotate"]
    d_c, d_r = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    g = torch.Generator(device=dev).manual_seed(3)
    ckv = torch.randn((CHUNK, cfg.d_qk), device=dev, generator=g)
    band = ckv[:, d_c:]                     # strided view, row pitch 576
    moved = torch.empty_like(ckv)
    worst, cases = 0.0, []
    for delta in (0, 1, 17, 4095):
        cos, sin = delta_cos_sin(delta, d_r, cfg.rope_theta)
        got = delta_rotate(band, cos, sin, out=moved[:, d_c:])
        want = delta_rotate_ref(band, cos, sin)
        torch.cuda.synchronize()
        e = max_err(torch, got, want)
        ok = e <= atol and (delta != 0 or bool((got == band).all()))
        log(f"[kernels] delta_rotate delta={delta} ({CHUNK},{d_r}) band of "
            f"({CHUNK},{cfg.d_qk}): max|err| {e:.3e} (atol {atol:g}) "
            f"{'ok' if ok else 'OVER TOLERANCE'}")
        if not ok:
            fail(f"delta_rotate delta={delta} disagrees with its plain "
                 "version")
        worst = max(worst, e)
    cos, sin = delta_cos_sin(17, d_r, cfg.rope_theta)
    out = moved[:, d_c:]
    ms, host_ms = time_ms(torch, lambda: delta_rotate(band, cos, sin, out=out),
                          500)
    plain_ms, _ = time_ms(torch, lambda: delta_rotate_ref(band, cos, sin),
                          PLAIN_ITERS)
    nbytes = 4 * (2 * CHUNK * d_r + d_r)
    flops = float(CHUNK * d_r * 3)
    b_ms, b_by = bound(nbytes, flops)
    cases.append({"shape": f"band({CHUNK},{d_r}) of ({CHUNK},{cfg.d_qk})",
                  "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                  "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
    log(f"[kernels] delta_rotate: {ms:.4f} ms device, {host_ms:.4f} ms as "
        f"issued (plain {plain_ms:.4f}, bound "
        f"{b_ms:.5f} by {b_by})")
    return worst, cases


def _sparse_cases():
    """(tag, R, S, block ids per batch row, kb or None, block_tokens): one
    request (16 rows) and a 16-request group (256 rows) over 8 and over all
    32 blocks of a chunk; a ragged batch with its tail block selected and an
    empty row; token-level selection of 37 scattered rows."""
    return [
        ("R=16 kb=8", 16, CHUNK, [[1, 4, 5, 9, 17, 20, 28, 31]], None, 64),
        ("R=16 kb=32", 16, CHUNK, [list(range(32))], None, 64),
        ("R=256 kb=8", 256, CHUNK, [[0, 2, 3, 11, 12, 19, 25, 30]], None,
         64),
        ("R=256 kb=32", 256, CHUNK, [list(range(32))], None, 64),
        ("ragged kb=[8,3,0] S=2080", 16, CHUNK + 32,
         [[0, 3, 7, 9, 12, 20, 31, 32], [32, 5, 1, 0, 0, 0, 0, 0],
          [0] * 8], [8, 3, 0], 64),
        ("bt=1 37 rows", 16, CHUNK, [[(i * 331) % CHUNK for i in range(37)]],
         None, 1),
    ]


def check_sparse_select(torch, dev, cfg):
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.sparse_select import (sparse_select,
                                                   sparse_select_ref)
    from repro_torch.kernels.sparse_select.ref import covered_rows
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    atol, rtol = TOL["sparse_select"]
    D, d_v, scale = cfg.d_qk, cfg.kv_lora_rank, cfg.scale
    g = torch.Generator(device=dev).manual_seed(4)
    worst, cases = 0.0, []

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

        got = kernel()
        compare(tag, got, plain())
        if kb is not None:
            torch.cuda.synchronize()
            if not (bool((got.o[2] == 0).all()) and bool((got.l[2] == 0).all())
                    and bool(torch.isneginf(got.m[2]).all())):
                fail("sparse_select: the kb = 0 row is not the identity")
        if len(ids[0]) * bt == S:           # every row selected
            compare(tag, got, mla_decode(q, ckv, d_v=d_v, scale=scale),
                    "mla_decode over the whole chunk")
        rows, valid = covered_rows(idx, kbt, None, bt, S)
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
                      "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by})
        log(f"[kernels] sparse_select {tag}: {ms:.4f} ms device, "
            f"{host_ms:.4f} ms as issued (plain {plain_ms:.4f}, sdpa with "
            f"mask {lib_ms}, bound {b_ms:.5f} by {b_by})")
    return worst, cases


# ---------------------------------------------------------------------------
# phase 5: the golden scenarios, built with the port's engine
# ---------------------------------------------------------------------------

def scenarios():
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    def routed_only(backend):
        eng = ServingEngine(8, pool_tokens=10**6, cfg=EngineConfig(),
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
        eng = ServingEngine(4, pool_tokens=10**6, cfg=EngineConfig(),
                            backend=backend)
        for i in range(3):
            eng.register_chunk(f"doc{i}", holder=1 + (i % 3), length=2048)
        reqs = [Request(i, home=0, chunk_ids=[f"doc{i}"], m_q=1,
                        expected_reuse_steps=100_000) for i in range(3)]
        return eng, [reqs, reqs, reqs]

    def mixed_congested(backend):
        eng = ServingEngine(8, pool_tokens=10**6, cfg=EngineConfig(),
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


def selection_scenario(backend=None, selector=None):
    """The frozen selection-regime trace of the reference's test scenarios:
    two selecting requests over chunks of 192 and 160 tokens (2.5 blocks:
    a partial tail block), a dense rider, a chunk the budget leaves
    empty."""
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
    eng = ServingEngine(4, pool_tokens=10**6, cfg=EngineConfig(),
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
        + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) + ")")

    # 3. kernels against plain versions
    from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA as cfg
    checks = {"mla_decode": check_mla_decode(torch, dev, cfg),
              "softmax_merge": check_softmax_merge(torch, dev, cfg),
              "delta_rotate": check_delta_rotate(torch, dev, cfg),
              "sparse_select": check_sparse_select(torch, dev, cfg)}

    # 4-5. the main path: serve, the selection serve, then the goldens;
    # every counter is zeroed just before each phase and read just after
    from repro_torch.kernels.delta_rotate import ops as rot_ops
    from repro_torch.kernels.mla_decode import ops as mla_ops
    from repro_torch.kernels.softmax_merge import ops as merge_ops
    from repro_torch.kernels.sparse_select import ops as sel_ops
    wrappers = {"mla_decode": mla_ops.mla_decode,
                "softmax_merge": merge_ops.softmax_merge,
                "delta_rotate": rot_ops.delta_rotate,
                "sparse_select": sel_ops.sparse_select}

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        result = fn()
        torch.cuda.synchronize()
        return result, {k: w.launches for k, w in wrappers.items()}

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
    (golden_err, sel_golden_err), golden_launches = counted(
        lambda: (run_goldens(torch, cfg), run_selection_goldens(torch, cfg)))
    by_phase = {"serve": serve_launches, "selection_serve": sel_launches,
                "goldens": golden_launches}
    launches = {k: sum(p[k] for p in by_phase.values()) for k in wrappers}

    # 6. proof of the path: the dense kernels over serve + goldens, and
    # sparse_select over the selection serve + goldens
    log(f"[path] launches by phase: {by_phase}")
    missing = [k for k in ("mla_decode", "softmax_merge", "delta_rotate")
               if serve_launches[k] + golden_launches[k] <= 0]
    if sel_launches["sparse_select"] + golden_launches["sparse_select"] <= 0:
        missing.append("sparse_select")
    if missing:
        fail(f"kernels never launched on the main path: {missing}")

    # 7. report
    replaces = {
        "mla_decode": "src/repro/kernels/mla_decode/kernel.py:69",
        "softmax_merge": "src/repro/kernels/softmax_merge/kernel.py:33",
        "delta_rotate": "src/repro/kernels/delta_rotate/kernel.py:30",
        "sparse_select": "src/repro/kernels/sparse_select/kernel.py:58"}
    # the representative main-path shape of each kernel: a 16-request
    # ROUTE group (m_q = 16) for mla_decode, M = 2 for softmax_merge, one
    # request over 8 selected blocks for sparse_select
    pick = {"mla_decode": 1, "softmax_merge": 0, "delta_rotate": 0,
            "sparse_select": 0}
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
            "library_ms": c["library_ms"], "cases": cases})
    log(f"[summary] serve {serve_s:.2f} s, selection serve {sel_s:.2f} s, "
        f"goldens max|err| {golden_err:.3e}, selection goldens "
        f"{sel_golden_err:.3e}, total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
