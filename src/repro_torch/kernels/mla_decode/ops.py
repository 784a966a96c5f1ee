"""Wrapper of the absorbed-MLA decode kernel (csrc/mla_decode.cu).

Replaces src/repro/kernels/mla_decode/kernel.py:mla_decode_pallas. On this
card the kernel is byte-bound for a single request (R = 16 rows over a
2048 x 576 chunk) and operation-bound for a large ROUTE group; it works in
f32 on CUDA cores, one block per 16 query rows, with S split across blocks
when the row tiles alone cannot fill the SMs (see the source for the
design). The serving backend folds a group's query rows into R and calls it
with B = 1 against the one shared chunk, so the cache is never copied per
request.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.merge import Partial
from repro_torch.kernels import build
from repro_torch.kernels.mla_decode.ref import mla_decode_ref

ROWS = 16                 # query rows per block (csrc/attend.cuh ROWS)
TILE = 32                 # cache rows per tile (csrc/attend.cuh BS)
MAX_DV = 512
MIN_SPLIT_TILES = 2       # a span of S is at least this many tiles
MAX_SPLITS = 256          # csrc MERGE_MAX_SLOTS: spans the combine can merge
BLOCKS_PER_SM = 2         # two ~111 KB blocks fit in an SM's shared memory


def _launcher():
    fn = build.library("mla_decode").mla_decode_f32
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        fn.argtypes = [P, L, L, P, L, L, P, I, I, I, I, I, ctypes.c_float,
                       I, I, P, P, P, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def split_plan(B: int, R: int, S: int, n_sm: int, *, rows: int = ROWS,
               tile: int = TILE,
               blocks_per_sm: int = BLOCKS_PER_SM) -> Tuple[int, int]:
    """(split_len, n_split): spans of S per block so that about
    blocks_per_sm blocks per SM are in flight, each span at least
    MIN_SPLIT_TILES tiles long, for a kernel whose blocks own `rows` query
    rows and walk S in `tile`-row tiles (by default attend.cuh's).
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
    if q.dtype != torch.float32 or ckv.dtype != torch.float32:
        raise TypeError(f"mla_decode kernel takes f32, got {q.dtype} / "
                        f"{ckv.dtype}")
    D = q.shape[2]
    if D % 4 or d_v > MAX_DV:
        raise ValueError(f"mla_decode kernel needs D % 4 == 0 and d_v <= "
                         f"{MAX_DV}, got D={D}, d_v={d_v}")
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
    (o, m, l) wire triple of §3.2. CPU tensors take the plain version."""
    _check(q, ckv, lengths, d_v)
    if q.device.type == "cpu":
        return mla_decode_ref(q, ckv, lengths, d_v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"mla_decode: unsupported device {q.device}")
    _check_cuda(q, ckv, lengths, d_v)
    B, R, D = q.shape
    S = ckv.shape[1]
    split_len, n_split = split_plan(B, R, S, build.sm_count(q.device))
    with torch.cuda.device(q.device):
        o = torch.empty((B, R, d_v), dtype=torch.float32, device=q.device)
        m = torch.empty((B, R), dtype=torch.float32, device=q.device)
        l = torch.empty((B, R), dtype=torch.float32, device=q.device)
        parts = partial_buffers(n_split, B, R, d_v, q.device)
        status = _launcher()(
            q.data_ptr(), q.stride(0), q.stride(1),
            ckv.data_ptr(), ckv.stride(0), ckv.stride(1),
            None if lengths is None else lengths.data_ptr(),
            B, R, S, D, d_v, float(scale), split_len, n_split,
            o.data_ptr(), m.data_ptr(), l.data_ptr(),
            *(None if t is None else t.data_ptr() for t in parts),
            build.stream_of(q))
        build.check(status, "mla_decode")
        mla_decode.launches += 1
    return Partial(o=o, m=m, l=l)


mla_decode.launches = 0
