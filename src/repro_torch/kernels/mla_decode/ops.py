"""Wrapper of the absorbed-MLA decode kernel (csrc/mla_decode.cu).

Replaces src/repro/kernels/mla_decode/kernel.py:mla_decode_pallas. On this
card the kernel is byte-bound for a single request (R = 16 rows over a
2048 x 576 chunk) and operation-bound for a large ROUTE group; it works in
f32 on CUDA cores. decode_plan picks its loop and its split of S per call:
the register-tiled 64-row loop for R >= 64, one of two 16-row loops below,
and balanced spans of whole cache tiles that fill the card, merged in the same
cooperative launch (see the source for the design). The serving backend
folds a group's query rows into R and calls it with B = 1 against the one
shared chunk, so the cache is never copied per request.

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
MAX_D = 576               # the group loop's Q tile + cache tile fill 227 KB
MIN_SPLIT_TILES = 2       # split_plan: a span of S is at least this many tiles
MAX_SPLITS = 256          # csrc MERGE_MAX_SLOTS: spans the combine can merge


class Loop(NamedTuple):
    """One of mla_decode.cu's loops: its code in the C entry, query rows
    and cache rows per block, and the blocks an SM the plan fills (its
    __launch_bounds__ minimum)."""
    code: int
    rows: int
    tile: int
    blocks_per_sm: int


LOOPS = {"group": Loop(0, 64, 32, 1),       # csrc/decode_tiled.cuh Group
         "tiled16": Loop(1, 16, 16, 1),     # csrc/decode_tiled.cuh Single
         "attend16": Loop(2, 16, 32, 2)}    # csrc/attend.cuh
GROUP_MIN_ROWS = 64       # R from which a call takes the group loop


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
    [z T / n, (z + 1) T / n) (csrc/mla_decode.cu span_of)."""
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


def decode_plan(B: int, R: int, S: int, n_sm: int) -> DecodePlan:
    """The loop and the split of S for q (B, R, D) over S cache rows.

    The rule: the group loop when R >= GROUP_MIN_ROWS. Below, the 16-row
    loop whose busiest SM walks fewer cache rows, attend16 on a tie:
    tiled16 when its spans of one 16-row tile fill the card (a single
    request) or S is short, attend16 once every SM walks as many rows
    either way (model decode at B = 2), where its two blocks an SM hide
    each other's latency. chip_smoke.py phase 3 times both sides."""
    if R >= GROUP_MIN_ROWS:
        return loop_plan("group", B, R, S, n_sm)
    tiled, attend = (loop_plan(name, B, R, S, n_sm)
                     for name in ("tiled16", "attend16"))
    if (busiest_sm_rows(tiled, B, R, S, n_sm)
            < busiest_sm_rows(attend, B, R, S, n_sm)):
        return tiled
    return attend


def _launcher():
    fn = build.library("mla_decode").mla_decode_f32
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        fn.argtypes = [P, L, L, P, L, L, P, I, I, I, I, I, ctypes.c_float,
                       I, I, P, P, P, P, P, P, P]      # loop, n_split
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
    if not q.is_contiguous():
        raise ValueError("mla_decode kernel: q must be contiguous")
    if (ckv.stride(2) != 1 or ckv.stride(1) % 4 or ckv.stride(0) % 4
            or ckv.data_ptr() % 16 or q.data_ptr() % 16):
        raise ValueError(f"mla_decode kernel: ckv needs unit column stride, "
                         f"row/batch strides divisible by 4 and 16-byte "
                         f"alignment, got strides {ckv.stride()}")
    if lengths is not None and (lengths.dtype != torch.int32
                                or not lengths.is_contiguous()):
        raise TypeError("mla_decode kernel: lengths must be contiguous int32")


def mla_decode(q: torch.Tensor, ckv: torch.Tensor,
               lengths: Optional[torch.Tensor] = None, *, d_v: int = 512,
               scale: float = 1.0) -> Partial:
    """Absorbed-MLA decode partial: q (B, R, D) over ckv (B, S, D), values
    the first d_v columns of ckv, lengths (B,) valid rows (None: all S).

    Returns Partial(o (B, R, d_v), m (B, R), l (B, R)) in f32 — the
    (o, m, l) wire triple of §3.2. q and ckv may be bf16 or f16: they are
    cast to f32 first, as the reference's kernel casts them. CPU tensors
    take the plain version. A DTensor raises TypeError (on a mesh:
    distributed.sharding.local_seq_partials)."""
    build.refuse_dtensor(
        "mla_decode", "on a mesh call it through "
        "repro_torch.distributed.sharding.local_seq_partials (each rank's "
        "sequence shard, the partials merged across the ranks)", q, ckv,
        lengths)
    _check(q, ckv, lengths, d_v)
    q, ckv = build.as_f32("mla_decode", q, ckv)
    if q.device.type == "cpu":
        return mla_decode_ref(q, ckv, lengths, d_v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"mla_decode: unsupported device {q.device}")
    _check_cuda(q, ckv, lengths, d_v)
    B, R, D = q.shape
    return _launch(q, ckv, lengths, d_v, scale,
                   decode_plan(B, R, ckv.shape[1], build.sm_count(q.device)))


def _launch(q, ckv, lengths, d_v: int, scale: float,
            plan: DecodePlan) -> Partial:
    """Launch the kernel under `plan` on checked CUDA inputs: mla_decode's
    launch, which chip_smoke.py also calls with the other 16-row loop's
    plan to time both sides of decode_plan's rule."""
    B, R, D = q.shape
    S = ckv.shape[1]
    with torch.cuda.device(q.device):
        o = torch.empty((B, R, d_v), dtype=torch.float32, device=q.device)
        m = torch.empty((B, R), dtype=torch.float32, device=q.device)
        l = torch.empty((B, R), dtype=torch.float32, device=q.device)
        parts = partial_buffers(plan.n_split, B, R, d_v, q.device)
        status = _launcher()(
            q.data_ptr(), q.stride(0), q.stride(1),
            ckv.data_ptr(), ckv.stride(0), ckv.stride(1),
            None if lengths is None else lengths.data_ptr(),
            B, R, S, D, d_v, float(scale), LOOPS[plan.loop].code,
            plan.n_split, o.data_ptr(), m.data_ptr(), l.data_ptr(),
            *(None if t is None else t.data_ptr() for t in parts),
            build.stream_of(q))
        build.check(status, "mla_decode")
        mla_decode.launches += 1
        mla_decode.launches_by_card[q.device.index] += 1
    return Partial(o=o, m=m, l=l)


mla_decode.launches = 0
mla_decode.launches_by_card = collections.Counter()
