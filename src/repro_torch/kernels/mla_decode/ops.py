"""Wrapper of the absorbed-MLA decode kernel (csrc/mla_decode.cu).

Replaces src/repro/kernels/mla_decode/kernel.py:mla_decode_pallas. On this
card the kernel is byte-bound for a single request (R = 16 rows over a
2048 x 576 chunk) and operation-bound for a large ROUTE group; it works in
f32 on CUDA cores and reads the cache in place in its own type (f32, bf16
or f16: no f32 copy of a bf16 cache). decode_plan picks its loop and its
split of S per call: from 64 rows the group loop (256-row cache tiles) or
group32 (32-row tiles), whichever busiest SM does less work, one of two
16-row loops below, and balanced spans of whole cache tiles that fill the
card, merged in the same cooperative launch (see the source for the
design). The
serving backend folds a group's query rows into R and calls it with B = 1
against the one shared chunk, so the cache is never copied per request.

sparse_select runs the same loops over a gathered row table and takes
decode_plan too. split_plan serves the flash_prefill kernels, which keep
merge.cuh's combine kernel; partial_buffers serves all three.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.merge import Partial
from repro_torch.kernels import build
from repro_torch.kernels.mla_decode.ref import mla_decode_ref

MAX_DV = 512
MAX_D = 576               # group32's Q tile + cache tile fill 227 KB
MIN_SPLIT_TILES = 2       # split_plan: a span of S is at least this many tiles
MAX_SPLITS = 256          # csrc MERGE_MAX_SLOTS: spans the combine can merge

# The cache's element types the kernels read in place, by their code in the
# C entries (csrc/decode_launch.cuh).
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
STAMP_WORDS = 8           # csrc/decode_tiled.cuh stamp::WORDS
STAMP_PHASES = ("wait", "scores", "softmax", "pv", "combine")


class Loop(NamedTuple):
    """One of mla_decode.cu's loops: its code in the C entry, query rows
    and cache rows per block, and the blocks an SM the plan fills (its
    __launch_bounds__ minimum)."""
    code: int
    rows: int
    tile: int
    blocks_per_sm: int


LOOPS = {"group": Loop(0, 64, 256, 1),      # csrc/decode_group.cuh
         "tiled16": Loop(1, 16, 16, 1),     # csrc/decode_tiled.cuh Single
         "attend16": Loop(2, 16, 32, 2),    # csrc/attend.cuh
         "group32": Loop(3, 64, 32, 1)}     # csrc/decode_tiled.cuh Group32
GROUP_MIN_ROWS = 64       # R from which a call takes a group loop


class DecodePlan(NamedTuple):
    loop: str
    n_split: int          # spans of S, merged in the same launch when > 1


def loop_plan(name: str, B: int, R: int, S: int, n_sm: int) -> DecodePlan:
    """The split of S that loop `name` takes for q (B, R, D) over S cache
    rows. Its row tiles make base = ceil(R / rows) * B blocks; while more
    fit on the card (capacity = n_sm x blocks_per_sm, never more than can
    be resident at once), S is split into n = min(T, capacity // base)
    spans of the T cache tiles, so the launch fills the card and stays
    co-resident, as its cooperative combine needs. Span z holds tiles
    [z T / n, (z + 1) T / n) (csrc/decode_launch.cuh span_of)."""
    lp = LOOPS[name]
    tiles = math.ceil(S / lp.tile)
    base = math.ceil(R / lp.rows) * B
    n = min(tiles, (n_sm * lp.blocks_per_sm) // base) if base else 1
    return DecodePlan(name, max(1, n))


def busiest_sm_rows(plan: DecodePlan, B: int, R: int, S: int,
                    n_sm: int) -> int:
    """Cache rows that the busiest SM walks under `plan`: the blocks it
    holds times the tiles of the longest span times the tile's rows."""
    lp = LOOPS[plan.loop]
    blocks = math.ceil(R / lp.rows) * B * plan.n_split
    longest = math.ceil(math.ceil(S / lp.tile) / plan.n_split)
    return math.ceil(blocks / n_sm) * longest * lp.tile


def busiest_sm_work(plan: DecodePlan, B: int, R: int, S: int,
                    n_sm: int) -> int:
    """Query-row x cache-row pairs that the busiest SM walks under `plan`:
    busiest_sm_rows times the loop's query rows a block."""
    return busiest_sm_rows(plan, B, R, S, n_sm) * LOOPS[plan.loop].rows


def decode_plan(B: int, R: int, S: int, n_sm: int) -> DecodePlan:
    """The loop and the split of S for q (B, R, D) over S cache rows.

    From GROUP_MIN_ROWS rows: group32 when its busiest SM walks fewer
    query-row x cache-row pairs (busiest_sm_work), else "group". Both
    plans fill the card as far as their tiles allow, so the busiest SM's
    work says which one a short span of few row tiles leaves idle SMs (256
    rows over 2048: "group" on 32 SMs, group32 on 132); on a tie "group",
    whose larger micro-tiles do the same work in fewer clocks.

    Below: the 16-row loop whose busiest SM walks fewer cache rows.
    tiled16 when its spans of one 16-row tile fill the card (a single
    request) or S is short; on a tie attend16, whose two blocks an SM hide
    each other's latency (model decode at B = 2), unless its spans
    outnumber the SMs: every block then merges more spans in the combine
    than tiled16's (one request over 8192 slots). chip_smoke.py phase 3
    times both sides."""
    if R >= GROUP_MIN_ROWS:
        wide, small = (loop_plan(name, B, R, S, n_sm)
                       for name in ("group", "group32"))
        if (busiest_sm_work(small, B, R, S, n_sm)
                < busiest_sm_work(wide, B, R, S, n_sm)):
            return small
        return wide
    tiled, attend = (loop_plan(name, B, R, S, n_sm)
                     for name in ("tiled16", "attend16"))
    rows_t, rows_a = (busiest_sm_rows(p, B, R, S, n_sm)
                      for p in (tiled, attend))
    if rows_t < rows_a or (rows_t == rows_a and attend.n_split > n_sm):
        return tiled
    return attend


def _launcher(name: str = "mla_decode"):
    fn = getattr(build.library("mla_decode"), name)
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        if name == "mla_decode":
            fn.argtypes = [P, L, L, P, L, L, I, P, I, I, I, I, I,
                           ctypes.c_float, I, I, P, P, P, P, P, P,
                           P]     # dtype, loop, n_split
        else:                     # mla_decode_stamped: f32, + stamps
            fn.argtypes = [P, L, L, P, L, L, P, I, I, I, I, I,
                           ctypes.c_float, I, I, P, P, P, P, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def split_plan(B: int, R: int, S: int, n_sm: int, *, rows: int, tile: int,
               blocks_per_sm: int) -> Tuple[int, int]:
    """The f32 and bf16 flash_prefill kernels' plan: (split_len, n_split):
    spans of S per block so that about blocks_per_sm blocks per SM are in
    flight, each span at least MIN_SPLIT_TILES tiles long, for a kernel
    whose blocks own `rows` query rows and walk S in `tile`-row tiles.
    split_len is a multiple of `tile`."""
    tiles = max(1, math.ceil(S / tile))
    blocks = max(1, math.ceil(R / rows) * B)
    want = max(1, (blocks_per_sm * n_sm) // blocks)
    n = max(1, min(want, tiles // MIN_SPLIT_TILES, MAX_SPLITS))
    split_len = math.ceil(tiles / n) * tile
    return split_len, max(1, math.ceil(S / split_len))


def partial_buffers(n_split: int, B: int, R: int, d_v: int, device):
    """The (o, m, l) partials of n_split spans that the combine merges, or
    three Nones when one span writes the result directly."""
    if n_split == 1:
        return (None, None, None)
    m = torch.empty((n_split, B, R), dtype=torch.float32, device=device)
    return (torch.empty((n_split, B, R, d_v), dtype=torch.float32,
                        device=device), m, torch.empty_like(m))


def _check(q, ckv, lengths, d_v) -> None:
    if q.ndim != 3 or ckv.ndim != 3:
        raise ValueError(f"mla_decode: q must be (B, R, D) and ckv (B, S, D), "
                         f"got {tuple(q.shape)} and {tuple(ckv.shape)}")
    if q.shape[0] != ckv.shape[0] or q.shape[2] != ckv.shape[2]:
        raise ValueError(f"mla_decode: q {tuple(q.shape)} and ckv "
                         f"{tuple(ckv.shape)} disagree on B or D")
    if not 0 < d_v <= ckv.shape[2]:
        raise ValueError(f"mla_decode: d_v={d_v} outside (0, D={ckv.shape[2]}]")
    if lengths is not None and tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(f"mla_decode: lengths must be (B,), got "
                         f"{tuple(lengths.shape)}")
    if q.device != ckv.device or (lengths is not None
                                  and lengths.device != q.device):
        raise ValueError("mla_decode: q, ckv and lengths must share a device")


def _check_cuda(q, ckv, lengths, d_v) -> None:
    D = q.shape[2]
    if D % 4 or D > MAX_D or d_v % 4 or d_v > MAX_DV:
        raise ValueError(f"mla_decode kernel needs D % 4 == 0, D <= {MAX_D}, "
                         f"d_v % 4 == 0 and d_v <= {MAX_DV}, got D={D}, "
                         f"d_v={d_v}")
    check_cache(q, ckv, d_v, "mla_decode")
    if lengths is not None and (lengths.dtype != torch.int32
                                or not lengths.is_contiguous()):
        raise TypeError("mla_decode kernel: lengths must be contiguous int32")


def check_cache(q, ckv, d_v: int, what: str) -> None:
    """What the decode kernels need of q (f32, contiguous) and of a cache
    read in place: a type they read (DTYPES), unit column stride, row and
    batch strides and D and d_v in whole 16-byte units, 16-byte aligned."""
    if ckv.dtype not in DTYPES:
        raise TypeError(f"{what} kernel reads an f32, bf16 or f16 cache, got "
                        f"{ckv.dtype}")
    per16 = 16 // ckv.element_size()
    if not q.is_contiguous():
        raise ValueError(f"{what} kernel: q must be contiguous")
    if (ckv.stride(2) != 1 or ckv.stride(1) % per16 or ckv.stride(0) % per16
            or ckv.shape[2] % per16 or d_v % per16 or ckv.data_ptr() % 16
            or q.data_ptr() % 16):
        raise ValueError(f"{what} kernel: a {ckv.dtype} cache needs unit "
                         f"column stride, D, d_v and row/batch strides "
                         f"divisible by {per16} and 16-byte alignment, got "
                         f"D={ckv.shape[2]}, d_v={d_v}, strides "
                         f"{ckv.stride()}")


def cache_operands(what: str, q, ckv):
    """(q, ckv) as the kernels take them: q in f32; the cache as it is when
    the kernels read its type in place (DTYPES, on a card), else in f32 as
    the reference's kernels cast it (the plain version on the CPU; an f64
    cache)."""
    (q,) = build.as_f32(what, q)
    if ckv.device.type == "cpu" or ckv.dtype not in DTYPES:
        (ckv,) = build.as_f32(what, ckv)
    return q, ckv


def mla_decode(q: torch.Tensor, ckv: torch.Tensor,
               lengths: Optional[torch.Tensor] = None, *, d_v: int = 512,
               scale: float = 1.0) -> Partial:
    """Absorbed-MLA decode partial: q (B, R, D) over ckv (B, S, D), values
    the first d_v columns of ckv, lengths (B,) valid rows (None: all S).

    Returns Partial(o (B, R, d_v), m (B, R), l (B, R)) in f32 — the
    (o, m, l) wire triple of §3.2. q may be bf16 or f16: it is cast to f32
    (R x D, small). On a card the kernel reads a bf16 or f16 cache in place,
    each value cast to f32 where it is used, as the reference's kernel casts
    each block: bit for bit the kernel on ckv.float(), with no f32 copy. CPU
    tensors take the plain version, on the cache cast to f32. A DTensor
    raises TypeError (on a mesh: distributed.sharding.local_seq_partials)."""
    build.refuse_dtensor(
        "mla_decode", "on a mesh call it through "
        "repro_torch.distributed.sharding.local_seq_partials (each rank's "
        "sequence shard, the partials merged across the ranks)", q, ckv,
        lengths)
    _check(q, ckv, lengths, d_v)
    q, ckv = cache_operands("mla_decode", q, ckv)
    if q.device.type == "cpu":
        return mla_decode_ref(q, ckv, lengths, d_v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"mla_decode: unsupported device {q.device}")
    _check_cuda(q, ckv, lengths, d_v)
    B, R, D = q.shape
    return _launch(q, ckv, lengths, d_v, scale,
                   decode_plan(B, R, ckv.shape[1], build.sm_count(q.device)))


def _outputs(plan: DecodePlan, B: int, R: int, d_v: int, device):
    """o, m, l and the span partials of a launch under `plan`."""
    o = torch.empty((B, R, d_v), dtype=torch.float32, device=device)
    m = torch.empty((B, R), dtype=torch.float32, device=device)
    l = torch.empty((B, R), dtype=torch.float32, device=device)
    parts = partial_buffers(plan.n_split, B, R, d_v, device)
    return o, m, l, [None if t is None else t.data_ptr() for t in parts], \
        parts


def _launch(q, ckv, lengths, d_v: int, scale: float,
            plan: DecodePlan) -> Partial:
    """Launch the kernel under `plan` on checked CUDA inputs: mla_decode's
    launch, which chip_smoke.py also calls with another loop's plan to time
    both sides of decode_plan's rules."""
    B, R, D = q.shape
    S = ckv.shape[1]
    with torch.cuda.device(q.device):
        o, m, l, ptrs, _parts = _outputs(plan, B, R, d_v, q.device)
        status = _launcher()(
            q.data_ptr(), q.stride(0), q.stride(1),
            ckv.data_ptr(), ckv.stride(0), ckv.stride(1), DTYPES[ckv.dtype],
            None if lengths is None else lengths.data_ptr(),
            B, R, S, D, d_v, float(scale), LOOPS[plan.loop].code,
            plan.n_split, o.data_ptr(), m.data_ptr(), l.data_ptr(), *ptrs,
            build.stream_of(q))
        build.check(status, f"mla_decode ({ckv.dtype} cache)")
        mla_decode.launches += 1
        mla_decode.launches_by_card[q.device.index] += 1
    return Partial(o=o, m=m, l=l)


def stamped(q, ckv, d_v: int, scale: float, plan: DecodePlan):
    """A measurement launch of a group loop ("group" or "group32") under
    `plan` over an f32 cache on the card, instrumented
    (csrc/mla_decode.cu mla_decode_stamped): (Partial, stamps), stamps an
    int64 (blocks, STAMP_WORDS) tensor of each block's start and end
    %globaltimer ns, its clock64 cycles in all and by STAMP_PHASES. Not a
    launch of the main path: the wrapper's counts do not move."""
    _check(q, ckv, None, d_v)
    _check_cuda(q, ckv, None, d_v)
    if ckv.dtype != torch.float32 or plan.loop not in ("group", "group32"):
        raise ValueError("stamped: an f32 cache and a group loop")
    B, R, D = q.shape
    lp = LOOPS[plan.loop]
    blocks = math.ceil(R / lp.rows) * B * plan.n_split
    with torch.cuda.device(q.device):
        o, m, l, ptrs, _parts = _outputs(plan, B, R, d_v, q.device)
        stamps = torch.zeros((blocks, STAMP_WORDS), dtype=torch.int64,
                             device=q.device)
        status = _launcher("mla_decode_stamped")(
            q.data_ptr(), q.stride(0), q.stride(1),
            ckv.data_ptr(), ckv.stride(0), ckv.stride(1), None,
            B, R, ckv.shape[1], D, d_v, float(scale), lp.code, plan.n_split,
            o.data_ptr(), m.data_ptr(), l.data_ptr(), *ptrs,
            stamps.data_ptr(), build.stream_of(q))
        build.check(status, "mla_decode_stamped")
    return Partial(o=o, m=m, l=l), stamps


mla_decode.launches = 0
mla_decode.launches_by_card = collections.Counter()
