"""Wrapper of the block-sparse selected attention kernel
(csrc/sparse_select.cu).

Replaces src/repro/kernels/sparse_select/kernel.py:sparse_select_pallas. On
this card one request (R = 16 rows) over 512 selected rows is byte-bound
and a large ROUTE group operation-bound, as for mla_decode, whose tile loop
(csrc/attend.cuh) it shares: one block per 16 query rows walks the selected
rows in 32-row tiles, each tile row's address looked up in the block table,
and the selected rows are split across blocks by mla_decode's split_plan
when the row tiles alone cannot fill the SMs. The serving backend folds a
request's query rows into R and passes the holder's chunk in place.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.merge import Partial
from repro_torch.kernels import build
from repro_torch.kernels.mla_decode.ops import MAX_DV, split_plan
from repro_torch.kernels.sparse_select.ref import sparse_select_ref

MAX_GRID_Y = 65535        # batch rows per launch (grid.y)


def _launcher():
    fn = build.library("sparse_select").sparse_select_f32
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        fn.argtypes = [P, L, L, P, L, L, P, L, P, P, I, I, I, I, I,
                       ctypes.c_float, I, I, I, I, P, P, P, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


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
    if q.dtype != torch.float32 or ckv.dtype != torch.float32:
        raise TypeError(f"sparse_select kernel takes f32, got {q.dtype} / "
                        f"{ckv.dtype}")
    D = q.shape[2]
    if D % 4 or d_v > MAX_DV:
        raise ValueError(f"sparse_select kernel needs D % 4 == 0 and d_v <= "
                         f"{MAX_DV}, got D={D}, d_v={d_v}")
    if not q.is_contiguous():
        raise ValueError("sparse_select kernel: q must be contiguous")
    if (ckv.stride(2) != 1 or ckv.stride(1) % 4 or ckv.stride(0) % 4
            or ckv.data_ptr() % 16 or q.data_ptr() % 16):
        raise ValueError(f"sparse_select kernel: ckv needs unit column "
                         f"stride, row/batch strides divisible by 4 and "
                         f"16-byte alignment, got strides {ckv.stride()}")
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
    nothing selected is the merge identity. CPU tensors take the plain
    version."""
    _check(q, ckv, block_idx, kb, lengths, d_v, block_tokens)
    if q.device.type == "cpu":
        return sparse_select_ref(q, ckv, block_idx, kb, lengths, d_v,
                                 block_tokens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"sparse_select: unsupported device {q.device}")
    _check_cuda(q, ckv, block_idx, kb, lengths, d_v, block_tokens)
    B, R, D = q.shape
    S, KB = ckv.shape[1], block_idx.shape[1]
    split_len, n_split = split_plan(B, R, KB * block_tokens,
                                    build.sm_count(q.device))
    with torch.cuda.device(q.device):
        o = torch.empty((B, R, d_v), dtype=torch.float32, device=q.device)
        m = torch.empty((B, R), dtype=torch.float32, device=q.device)
        l = torch.empty((B, R), dtype=torch.float32, device=q.device)
        if n_split > 1:
            o_p = torch.empty((n_split, B, R, d_v), dtype=torch.float32,
                              device=q.device)
            m_p = torch.empty((n_split, B, R), dtype=torch.float32,
                              device=q.device)
            l_p = torch.empty_like(m_p)
            parts = (o_p.data_ptr(), m_p.data_ptr(), l_p.data_ptr())
        else:
            parts = (None, None, None)
        status = _launcher()(
            q.data_ptr(), q.stride(0), q.stride(1),
            ckv.data_ptr(), ckv.stride(0), ckv.stride(1),
            block_idx.data_ptr(), block_idx.stride(0),
            None if kb is None else kb.data_ptr(),
            None if lengths is None else lengths.data_ptr(),
            B, R, S, D, d_v, float(scale), block_tokens, KB, split_len,
            n_split, o.data_ptr(), m.data_ptr(), l.data_ptr(), *parts,
            build.stream_of(q))
        build.check(status, "sparse_select")
        sparse_select.launches += 1
    return Partial(o=o, m=m, l=l)


sparse_select.launches = 0
