"""Wrapper of the fused SSD intra-chunk kernel (csrc/ssd_chunk.cu).

Replaces src/repro/kernels/ssd_chunk/kernel.py:ssd_intra_chunk_pallas. On
this card one 2048-token sequence of mamba2-370m is ~1.7 GFLOP against
~53 MB; the kernel runs its three chunk products (C B^T, the gated y, the
chunk state) on the tensor cores as split-TF32 products (csrc/tf32x3.cuh)
and keeps CB, the decay gate and dt x on chip, so no (Q, Q, H) tensor
reaches device memory (see the source for the design). Any head-block size
works, including one that does not divide H; the kernel takes Q <= 128,
P <= 64 and N <= 128 (mamba2-370m: 128, 64, 128).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref

MAX_SMEM = 232448         # dynamic shared memory a block may opt into
LIMITS = {"Q": 128, "P": 64, "N": 128}   # csrc/ssd_chunk.cu MAX_Q/P/N
MAX_GRID_Y = 65535        # head blocks per launch (grid.y)


def _lib():
    lib = build.library("ssd_chunk")
    if lib.ssd_chunk_f32.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        lib.ssd_chunk_f32.argtypes = [P, P, P, P, P, L, I, I, I, I, I, P, P,
                                      P, P]
        lib.ssd_chunk_f32.restype = ctypes.c_int
        lib.ssd_chunk_smem_bytes.argtypes = [I, I, I]
        lib.ssd_chunk_smem_bytes.restype = ctypes.c_int
    return lib


def resources(Q: int, P: int, N: int):
    """(dynamic shared memory bytes of a block, blocks one SM holds) of the
    kernel at (Q, P, N), the latter as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor reports it (needs the
    card)."""
    fn = _lib().ssd_chunk_occupancy
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return _lib().ssd_chunk_smem_bytes(Q, P, N), fn(Q, P, N)


def _check(x, dt, A, B, C, hb) -> None:
    if x.ndim != 5 or dt.ndim != 4 or A.ndim != 1 or B.ndim != 4 \
            or C.ndim != 4:
        raise ValueError(f"ssd_intra_chunk: x must be (b, nc, Q, H, P), dt "
                         f"(b, nc, Q, H), A (H,), B/C (b, nc, Q, N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, nc, Q, H, _ = x.shape
    if tuple(dt.shape) != (b, nc, Q, H) or tuple(A.shape) != (H,) \
            or B.shape[:3] != (b, nc, Q) or C.shape != B.shape:
        raise ValueError(f"ssd_intra_chunk: shapes disagree: x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}")
    if hb < 1:
        raise ValueError(f"ssd_intra_chunk: hb={hb} < 1")
    if len({t.device for t in (x, dt, A, B, C)}) != 1:
        raise ValueError("ssd_intra_chunk: x, dt, A, B and C must share a "
                         "device")


def _check_cuda(x, dt, A, B, C, hb) -> None:
    if not all(t.is_contiguous() for t in (x, dt, A, B, C)):
        raise ValueError("ssd_intra_chunk kernel: inputs must be contiguous")
    b, nc, Q, H, P = x.shape
    N = B.shape[-1]
    if Q > LIMITS["Q"] or P > LIMITS["P"] or N > LIMITS["N"]:
        raise ValueError(f"ssd_intra_chunk kernel takes Q <= {LIMITS['Q']}, "
                         f"P <= {LIMITS['P']} and N <= {LIMITS['N']}, got "
                         f"Q={Q}, P={P}, N={N}")
    smem = _lib().ssd_chunk_smem_bytes(Q, P, N)
    if not 0 < smem <= MAX_SMEM:
        raise ValueError(f"ssd_intra_chunk kernel: Q={Q}, P={P}, N={N} need "
                         f"{smem} bytes of shared memory, more than a "
                         f"block's {MAX_SMEM}")
    if -(-H // hb) > MAX_GRID_Y or b * nc >= 2**31:
        raise ValueError(f"ssd_intra_chunk kernel: grid too large (b*nc="
                         f"{b * nc}, head blocks {-(-H // hb)})")


def ssd_intra_chunk(x, dt, A, B, C, *, hb: int = 4):
    """Fused SSD intra-chunk: x (b, nc, Q, H, P), dt (b, nc, Q, H)
    post-softplus, A (H,) negative, B/C (b, nc, Q, N) -> (y_intra
    (b, nc, Q, H, P), chunk states (b, nc, H, P, N), cum (b, nc, Q, H)), all
    f32. The operands may be bf16 or f16: they are cast to f32 first, as
    the reference's kernel casts them. hb heads share one block's C B^T. CPU
    tensors take the plain version. A DTensor raises TypeError (on a mesh:
    models.ssm.serving_intra runs it on each rank's local heads)."""
    build.refuse_dtensor(
        "ssd_intra_chunk", "on a mesh call it through "
        "repro_torch.models.ssm.serving_intra (each rank's batch rows and "
        "heads, through repro_torch.distributed.sharding.local_heads)", x,
        dt, A, B, C)
    _check(x, dt, A, B, C, hb)
    x, dt, A, B, C = build.as_f32("ssd_intra_chunk", x, dt, A, B, C)
    if x.device.type == "cpu":
        return ssd_intra_chunk_ref(x, dt, A, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk: unsupported device {x.device}")
    _check_cuda(x, dt, A, B, C, hb)
    b, nc, Q, H, P = x.shape
    N = B.shape[-1]
    dev = x.device
    with torch.cuda.device(dev):
        y = torch.empty((b, nc, Q, H, P), dtype=torch.float32, device=dev)
        states = torch.empty((b, nc, H, P, N), dtype=torch.float32,
                             device=dev)
        cum = torch.empty((b, nc, Q, H), dtype=torch.float32, device=dev)
        status = _lib().ssd_chunk_f32(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), b * nc, Q, H, P, N, hb, y.data_ptr(),
            states.data_ptr(), cum.data_ptr(), build.stream_of(x))
        build.check(status, "ssd_intra_chunk")
        ssd_intra_chunk.launches += 1
        ssd_intra_chunk.launches_by_card[x.device.index] += 1
    return y, states, cum


ssd_intra_chunk.launches = 0
ssd_intra_chunk.launches_by_card = collections.Counter()
