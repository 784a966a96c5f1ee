"""Wrapper of the causal latent flash-prefill kernels (csrc/flash_prefill.cu,
csrc/flash_prefill_bf16.cu).

Replaces src/repro/kernels/flash_prefill/kernel.py:flash_prefill_pallas. On
this card one 2048-token sequence at V2-Lite width is operation-bound (~73
GFLOP). The wrapper dispatches on the operands' dtype, and on nothing else:

  * bf16 on the card: flash_prefill_bf16.cu, TMA tiles and wgmma on the
    tensor cores (64 query rows a block, f32 accumulation), the model's
    path in bf16;
  * f32 on the card: flash_prefill.cu, split-TF32 products on the tensor
    cores (csrc/tf32x3.cuh; 64 query rows a block, the Q tile resident,
    32-row cache tiles by cp.async), the f32 verification path;
  * either on the CPU: the plain version;
  * mixed or other dtypes: TypeError, on every device.

Both return f32. Unlike the Pallas kernel, Sq and Sk need not be multiples
of a block (see the sources for the designs).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.kernels.mla_decode.ops import (MAX_DV, partial_buffers,
                                                split_plan)

MAX_GRID_Y = 65535        # batch rows per launch (grid.y)
DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
# csrc/flash_prefill_bf16.cu: 64 query rows a block, 64 cache rows a tile,
# nine 64-column boxes of shared memory a tile, one block per SM
BF16_PLAN = {"rows": 64, "tile": 64, "blocks_per_sm": 1}
BF16_MAX_D = 576
# csrc/flash_prefill.cu: 64 query rows a block, 32 cache rows a tile; the
# resident Q tile and one cache tile fill the SM's shared memory (D <= 576)
F32_PLAN = {"rows": 64, "tile": 32, "blocks_per_sm": 1}
F32_MAX_D = 576


def _launcher_f32():
    fn = build.library("flash_prefill").flash_prefill_f32
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        fn.argtypes = [P, L, P, L, L, I, I, I, I, I, ctypes.c_float, I, I, I,
                       I, P, P, P, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def f32_resources(D: int, d_v: int):
    """(dynamic shared memory bytes of a block, blocks one SM holds) of the
    f32 kernel at (D, d_v), the latter as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor reports it (needs the
    card)."""
    lib = build.library("flash_prefill")
    out = []
    for fn in (lib.flash_prefill_f32_smem_bytes,
               lib.flash_prefill_f32_occupancy):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
        out.append(fn(D, d_v))
    return tuple(out)


def _launcher_bf16():
    fn = build.library("flash_prefill_bf16").flash_prefill_bf16
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        fn.argtypes = [P, P, L, L, I, I, I, I, I, ctypes.c_float, I, I, I, I,
                       P, P, P, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def _check(q, ckv, d_v) -> None:
    if q.ndim != 4 or ckv.ndim != 3:
        raise ValueError(f"flash_prefill: q must be (B, Sq, H, D) and ckv "
                         f"(B, Sk, D), got {tuple(q.shape)} and "
                         f"{tuple(ckv.shape)}")
    if q.shape[0] != ckv.shape[0] or q.shape[3] != ckv.shape[2]:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} and ckv "
                         f"{tuple(ckv.shape)} disagree on B or D")
    if q.shape[1] > ckv.shape[1]:
        raise ValueError(f"flash_prefill: Sq={q.shape[1]} > Sk="
                         f"{ckv.shape[1]} (queries align to the cache tail)")
    if not 0 < d_v <= ckv.shape[2]:
        raise ValueError(f"flash_prefill: d_v={d_v} outside "
                         f"(0, D={ckv.shape[2]}]")
    if q.dtype != ckv.dtype or q.dtype not in DTYPES:
        raise TypeError(f"flash_prefill takes q and ckv both f32 or both "
                        f"bf16, got {q.dtype} / {ckv.dtype}")
    if q.device != ckv.device:
        raise ValueError("flash_prefill: q and ckv must share a device")


def _check_grid(q) -> None:
    B, Sq, H, _ = q.shape
    if B > MAX_GRID_Y or Sq * H >= 2**31:
        raise ValueError(f"flash_prefill kernel: at most {MAX_GRID_Y} batch "
                         f"rows and 2^31 query rows, got B={B}, "
                         f"Sq*H={Sq * H}")


def _check_f32(q, ckv, d_v) -> None:
    D = q.shape[3]
    if D % 4 or D > F32_MAX_D or d_v > MAX_DV:
        raise ValueError(f"flash_prefill kernel needs D % 4 == 0, D <= "
                         f"{F32_MAX_D} and d_v <= {MAX_DV}, got D={D}, "
                         f"d_v={d_v}")
    if not q.is_contiguous():
        raise ValueError("flash_prefill kernel: q must be contiguous")
    if (ckv.stride(2) != 1 or ckv.stride(1) % 4 or ckv.stride(0) % 4
            or ckv.data_ptr() % 16 or q.data_ptr() % 16):
        raise ValueError(f"flash_prefill kernel: ckv needs unit column "
                         f"stride, row/batch strides divisible by 4 and "
                         f"16-byte alignment, got strides {ckv.stride()}")
    _check_grid(q)


def check_bf16(q, ckv, d_v) -> None:
    """Raise ValueError for a shape or stride the bf16 kernel does not take
    (its tensor maps need 16-byte strides and bases; its shared tiles hold
    D <= 576 columns; its output columns go in pairs of warpgroup halves)."""
    B, Sq, H, D = q.shape
    if D % 8 or D > BF16_MAX_D:
        raise ValueError(f"flash_prefill bf16 kernel needs D % 8 == 0 and "
                         f"D <= {BF16_MAX_D}, got D={D}")
    if d_v % 16 or d_v > MAX_DV:
        raise ValueError(f"flash_prefill bf16 kernel needs d_v % 16 == 0 and "
                         f"d_v <= {MAX_DV}, got d_v={d_v}")
    if not q.is_contiguous():
        raise ValueError("flash_prefill bf16 kernel: q must be contiguous")
    if (ckv.stride(2) != 1 or ckv.stride(1) % 8
            or (B > 1 and ckv.stride(0) % 8)
            or ckv.data_ptr() % 16 or q.data_ptr() % 16):
        raise ValueError(f"flash_prefill bf16 kernel: ckv needs unit column "
                         f"stride, row/batch strides divisible by 8 (16 "
                         f"bytes) and 16-byte alignment, got strides "
                         f"{ckv.stride()}")
    _check_grid(q)


def flash_prefill(q: torch.Tensor, ckv: torch.Tensor, *, d_v: int = 512,
                  scale: float = 1.0) -> torch.Tensor:
    """Causal absorbed-MLA attention: q (B, Sq, H, D) over ckv (B, Sk, D),
    Sq <= Sk, query i seeing cache rows [0, Sk - Sq + i]; values the first
    d_v columns of ckv. q and ckv are both f32 or both bf16. Returns
    (B, Sq, H, d_v) f32. CPU tensors take the plain version. A DTensor
    raises TypeError (on a mesh: distributed.sharding.local_heads)."""
    build.refuse_dtensor(
        "flash_prefill", "on a mesh call it through "
        "repro_torch.distributed.sharding.local_heads (each rank's batch rows "
        "and heads)", q, ckv)
    _check(q, ckv, d_v)
    if q.device.type == "cpu":
        return flash_prefill_ref(q, ckv, d_v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    bf16 = q.dtype == torch.bfloat16
    (check_bf16 if bf16 else _check_f32)(q, ckv, d_v)
    B, Sq, H, D = q.shape
    Sk = ckv.shape[1]
    R = Sq * H
    split_len, n_split = split_plan(B, R, Sk, build.sm_count(q.device),
                                    **(BF16_PLAN if bf16 else F32_PLAN))
    with torch.cuda.device(q.device):
        o = torch.empty((B, Sq, H, d_v), dtype=torch.float32,
                        device=q.device)
        m = torch.empty((B, R), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        parts = partial_buffers(n_split, B, R, d_v, q.device)
        tail = (B, R, Sk, D, d_v, float(scale), H, Sk - Sq, split_len,
                n_split, o.data_ptr(), m.data_ptr(), l.data_ptr(),
                *(None if t is None else t.data_ptr() for t in parts),
                build.stream_of(q))
        if bf16:
            status = _launcher_bf16()(q.data_ptr(), ckv.data_ptr(),
                                      ckv.stride(0), ckv.stride(1), *tail)
        else:
            status = _launcher_f32()(q.data_ptr(), q.stride(0),
                                     ckv.data_ptr(), ckv.stride(0),
                                     ckv.stride(1), *tail)
        build.check(status, f"flash_prefill ({DTYPES[q.dtype]})")
        flash_prefill.launches += 1
        flash_prefill.launches_by_dtype[DTYPES[q.dtype]] += 1
        flash_prefill.launches_by_card[DTYPES[q.dtype]][q.device.index] += 1
    return o


flash_prefill.launches = 0
flash_prefill.launches_by_dtype = {name: 0 for name in DTYPES.values()}
flash_prefill.launches_by_card = {name: collections.Counter()
                                  for name in DTYPES.values()}
