"""Wrapper of the block-sparse selected attention kernel
(csrc/sparse_select.cu).

Replaces src/repro/kernels/sparse_select/kernel.py:sparse_select_pallas. On
this card one request (R = 16 rows) over 512 selected rows is byte-bound
and a large ROUTE group operation-bound, as for mla_decode, whose decode
loops it runs over a gathered row table (csrc/decode_launch.cuh): each tile
row's cache row is looked up in the block table, in the cache's own type
(f32, bf16 or f16: a bf16 cache is read in place, never cast whole). Its
plan is mla_decode's decode_plan over T = KB * block_tokens positions
(select_plan): a 64-row group loop from 64 query rows, a 16-row loop
below, and spans that fill the card, merged in the same cooperative
launch, so a call is one launch. The serving backend folds a request's
query rows into R and passes the holder's chunk in place.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from repro_torch.core.merge import Partial
from repro_torch.kernels import build
from repro_torch.kernels.mla_decode.ops import (DTYPES, LOOPS, MAX_D, MAX_DV,
                                                DecodePlan, cache_operands,
                                                check_cache, decode_plan,
                                                partial_buffers)
from repro_torch.kernels.sparse_select.ref import sparse_select_ref

MAX_GRID_Y = 65535        # batch rows per launch (grid.y)


def select_plan(B: int, R: int, KB: int, block_tokens: int,
                n_sm: int) -> DecodePlan:
    """The loop and the split of the T = KB * block_tokens selected
    positions for q (B, R, D): mla_decode's decode_plan over T. Spans are
    cut over the widest row's positions; a span past a row's kb[b] *
    block_tokens is the identity."""
    return decode_plan(B, R, KB * block_tokens, n_sm)


def _launcher():
    fn = build.library("sparse_select").sparse_select
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        fn.argtypes = [P, L, L, P, L, L, I, P, L, P, P, I, I, I, I, I,
                       ctypes.c_float, I, I, I, I, P, P, P, P, P, P,
                       P]         # dtype; bt, kb_max, loop, n_split
        fn.restype = ctypes.c_int
    return fn


def resources(loop: str, D: int):
    """(dynamic shared memory bytes of a block, blocks one SM holds) of
    loop `loop` at D over an f32 cache, the latter as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor reports it (needs the
    card)."""
    fn = build.library("sparse_select").sparse_select_resources
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    smem = ctypes.c_int(0)
    per_sm = fn(LOOPS[loop].code, D, ctypes.byref(smem))
    return smem.value, per_sm


def _check(q, ckv, block_idx, kb, lengths, d_v, block_tokens) -> None:
    if q.ndim != 3 or ckv.ndim != 3 or block_idx.ndim != 2:
        raise ValueError(f"sparse_select: q must be (B, R, D), ckv (B, S, D) "
                         f"and block_idx (B, KB), got {tuple(q.shape)}, "
                         f"{tuple(ckv.shape)}, {tuple(block_idx.shape)}")
    B = q.shape[0]
    if ckv.shape[0] != B or block_idx.shape[0] != B \
            or q.shape[2] != ckv.shape[2]:
        raise ValueError(f"sparse_select: q {tuple(q.shape)}, ckv "
                         f"{tuple(ckv.shape)} and block_idx "
                         f"{tuple(block_idx.shape)} disagree on B or D")
    if block_idx.dtype.is_floating_point or block_idx.dtype == torch.bool:
        raise TypeError(f"sparse_select: block_idx must hold integers, got "
                        f"{block_idx.dtype}")
    if not 0 < d_v <= ckv.shape[2]:
        raise ValueError(f"sparse_select: d_v={d_v} outside "
                         f"(0, D={ckv.shape[2]}]")
    if block_tokens < 1:
        raise ValueError(f"sparse_select: block_tokens={block_tokens} < 1")
    for name, t in (("kb", kb), ("lengths", lengths)):
        if t is not None and tuple(t.shape) != (B,):
            raise ValueError(f"sparse_select: {name} must be (B,), got "
                             f"{tuple(t.shape)}")
    devs = {t.device for t in (q, ckv, block_idx, kb, lengths)
            if t is not None}
    if len(devs) != 1:
        raise ValueError("sparse_select: q, ckv, block_idx, kb and lengths "
                         "must share a device")


def _check_cuda(q, ckv, block_idx, kb, lengths, d_v, block_tokens) -> None:
    D = q.shape[2]
    if D % 4 or D > MAX_D or d_v % 4 or d_v > MAX_DV:
        raise ValueError(f"sparse_select kernel needs D % 4 == 0, D <= "
                         f"{MAX_D} (the group loop's shared memory), "
                         f"d_v % 4 == 0 and d_v <= {MAX_DV}, got D={D}, "
                         f"d_v={d_v}")
    check_cache(q, ckv, d_v, "sparse_select")
    if block_idx.dtype != torch.int32 or block_idx.stride(1) != 1:
        raise TypeError("sparse_select kernel: block_idx must be int32 with "
                        "unit column stride")
    for name, t in (("kb", kb), ("lengths", lengths)):
        if t is not None and (t.dtype != torch.int32
                              or not t.is_contiguous()):
            raise TypeError(f"sparse_select kernel: {name} must be "
                            f"contiguous int32")
    if q.shape[0] > MAX_GRID_Y:
        raise ValueError(f"sparse_select kernel: at most {MAX_GRID_Y} batch "
                         f"rows, got {q.shape[0]}")
    if block_idx.shape[1] * block_tokens >= 2**31:
        raise ValueError("sparse_select kernel: KB * block_tokens must fit "
                         "in int32")


def sparse_select(q: torch.Tensor, ckv: torch.Tensor,
                  block_idx: torch.Tensor, kb: Optional[torch.Tensor] = None,
                  lengths: Optional[torch.Tensor] = None, *, d_v: int = 512,
                  scale: float = 1.0, block_tokens: int = 64) -> Partial:
    """Selected-set decode partial (§5.4): q (B, R, D) attends the rows of
    ckv (B, S, D) that the first kb[b] ids of block_idx (B, KB) cover
    (None: all KB), block_tokens rows per block, rows at or past lengths[b]
    (None: S) skipped. Values are the first d_v columns of ckv.

    Returns Partial(o (B, R, d_v), m (B, R), l (B, R)) in f32; a row with
    nothing selected is the merge identity. q may be bf16 or f16: it is cast
    to f32. On a card the kernel reads a bf16 or f16 cache in place, each
    selected value cast to f32 where it is used, as the reference's kernel
    casts each block: bit for bit the kernel on ckv.float(), with no copy
    of the cache. CPU tensors take the plain version, on the cache cast to
    f32. A DTensor raises TypeError: selection
    over a sequence-sharded cache goes through
    repro_torch.distributed.sharding.local_seq_selected, which passes each
    rank's chosen rows as local tensors."""
    build.refuse_dtensor(
        "sparse_select", "selection over a sequence-sharded cache goes "
        "through repro_torch.distributed.sharding.local_seq_selected (a "
        "global top-k over the shards, each rank's chosen rows attended on "
        "its local tensors)", q, ckv, block_idx, kb, lengths)
    _check(q, ckv, block_idx, kb, lengths, d_v, block_tokens)
    q, ckv = cache_operands("sparse_select", q, ckv)
    if q.device.type == "cpu":
        return sparse_select_ref(q, ckv, block_idx, kb, lengths, d_v,
                                 block_tokens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"sparse_select: unsupported device {q.device}")
    _check_cuda(q, ckv, block_idx, kb, lengths, d_v, block_tokens)
    B, R, D = q.shape
    S, KB = ckv.shape[1], block_idx.shape[1]
    plan = select_plan(B, R, KB, block_tokens, build.sm_count(q.device))
    with torch.cuda.device(q.device):
        o = torch.empty((B, R, d_v), dtype=torch.float32, device=q.device)
        m = torch.empty((B, R), dtype=torch.float32, device=q.device)
        l = torch.empty((B, R), dtype=torch.float32, device=q.device)
        parts = partial_buffers(plan.n_split, B, R, d_v, q.device)
        status = _launcher()(
            q.data_ptr(), q.stride(0), q.stride(1),
            ckv.data_ptr(), ckv.stride(0), ckv.stride(1), DTYPES[ckv.dtype],
            block_idx.data_ptr(), block_idx.stride(0),
            None if kb is None else kb.data_ptr(),
            None if lengths is None else lengths.data_ptr(),
            B, R, S, D, d_v, float(scale), block_tokens, KB,
            LOOPS[plan.loop].code, plan.n_split, o.data_ptr(), m.data_ptr(),
            l.data_ptr(), *(None if t is None else t.data_ptr()
                            for t in parts),
            build.stream_of(q))
        build.check(status, f"sparse_select ({ckv.dtype} cache)")
        sparse_select.launches += 1
        sparse_select.launches_by_card[q.device.index] += 1
    return Partial(o=o, m=m, l=l)


sparse_select.launches = 0
sparse_select.launches_by_card = collections.Counter()
