"""Wrapper of the splice kernel (csrc/delta_rotate.cu).

Replaces src/repro/kernels/delta_rotate/kernel.py:delta_rotate_pallas, and
with it the whole FETCH splice of core/splice.py: one launch copies a
chunk's latent columns and writes its rope band rotated by one position
delta, f32 or bf16. Byte-bound on this card: each thread moves 16-byte
vectors, several loads in flight before its first store, over a grid sized
to the work and the SM count (splice_plan). Two entries on the one kernel:
splice_rotate takes whole rows (latent + band), delta_rotate the band alone
(the kernel with no latent columns). Both read the source and write the
destination through their row pitches, so the band can be a column slice
of wider rows and the destination a slice of a pool. cos/sin are computed
on the host (rope_cos_sin of the delta, f32, memoised for a Python delta)
and passed by value in the launch. delta_rotate.launches counts the
kernel's launches through either entry.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.delta_rotate.ref import delta_rotate_ref
from repro_torch.models.layers import rope_cos_sin

MAX_PAIRS = 64            # csrc MAX_PAIRS: d_r <= 128
UNROLL = 4                # csrc UNROLL: items a thread loads at once
THREADS = 256
FILL_BLOCKS = 2           # blocks an SM the grid reaches before UNROLL
VEC_BYTES = 16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # csrc dtype codes

class SplicePlan(NamedTuple):
    """vec: the 16-byte path; width: elements an item moves (W); per_row:
    items a row (d_c / W latent vectors + d2 / W band pairs); blocks x
    threads: the grid (blocks = 0: nothing to launch)."""
    vec: bool
    width: int
    per_row: int
    blocks: int
    threads: int


def splice_plan(x_ptr: int, ldx: int, y_ptr: int, ldy: int, rows: int,
                d_c: int, d_r: int, elem_size: int, n_sm: int) -> SplicePlan:
    """The path and grid of one splice launch: source rows at x_ptr with a
    pitch of ldx elements, destination rows at y_ptr with ldy, d_c latent
    columns then a band of d_r. The 16-byte path needs both base pointers
    16-byte aligned, both pitches whole 16-byte multiples and d_c, d_r / 2
    multiples of the vector's W elements; otherwise one element an item
    (the same kernel, the same bits). The grid gives each thread one round
    of UNROLL items while that still fills FILL_BLOCKS blocks an SM, else
    fewer (one item a thread at the least); blocks past what the card
    holds at once run in waves (csrc/delta_rotate.cu says why)."""
    if d_r <= 0 or d_r % 2 or d_r > 2 * MAX_PAIRS:
        raise ValueError(f"delta_rotate kernel: d_r must be even and in "
                         f"[2, {2 * MAX_PAIRS}], got {d_r}")
    if d_c < 0 or rows < 0:
        raise ValueError(f"delta_rotate kernel: rows {rows}, d_c {d_c}")
    d2 = d_r // 2
    w = VEC_BYTES // elem_size
    vec = (x_ptr % VEC_BYTES == 0 and y_ptr % VEC_BYTES == 0
           and (ldx * elem_size) % VEC_BYTES == 0
           and (ldy * elem_size) % VEC_BYTES == 0
           and d_c % w == 0 and d2 % w == 0)
    if not vec:
        w = 1
    per_row = d_c // w + d2 // w
    items = rows * per_row
    blocks = 0 if items == 0 else min(
        math.ceil(items / THREADS),
        max(math.ceil(items / (THREADS * UNROLL)), FILL_BLOCKS * n_sm))
    return SplicePlan(vec, w, per_row, blocks, THREADS)


def _launcher():
    fn = build.library("delta_rotate").delta_rotate_splice
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        fn.argtypes = [I, I, P, L, P, L, L, I, I, P, P, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def launch_plan(src: torch.Tensor, out: torch.Tensor,
                d_c: int) -> SplicePlan:
    """splice_plan of the launch that splices the 2-D CUDA view src (N,
    d_c + d_r) into out."""
    return splice_plan(src.data_ptr(), src.stride(0), out.data_ptr(),
                       out.stride(0), src.shape[0], d_c, src.shape[1] - d_c,
                       src.element_size(), build.sm_count(src.device))


def _cos_sin(delta, head_dim: int, theta: float):
    d = torch.as_tensor(delta, dtype=torch.float32).to("cpu")
    cos, sin = rope_cos_sin(d, head_dim, theta)
    return cos.contiguous(), sin.contiguous()


_memo_cos_sin = functools.lru_cache(maxsize=64)(_cos_sin)


def delta_cos_sin(delta, head_dim: int, theta: float = 10000.0):
    """cos/sin (head_dim/2,) f32 on the host for one position delta. A
    Python number's pair is memoised (the serving path splices at delta 0
    every time); callers must not write into it. A tensor delta is
    computed afresh."""
    if isinstance(delta, (int, float)):
        return _memo_cos_sin(delta, head_dim, float(theta))
    return _cos_sin(delta, head_dim, theta)


def _check_angles(cos, sin, d2):
    if tuple(cos.shape) != (d2,) or tuple(sin.shape) != (d2,):
        raise ValueError(f"delta_rotate: cos/sin must be ({d2},), got "
                         f"{tuple(cos.shape)}, {tuple(sin.shape)}")


def _extent(t: torch.Tensor):
    """[first, last) byte addresses of a 2-D view with unit column
    stride."""
    n, cols = t.shape
    if n == 0 or cols == 0:
        return t.data_ptr(), t.data_ptr()
    return t.data_ptr(), t.data_ptr() + ((n - 1) * t.stride(0) + cols) \
        * t.element_size()


def _launch(src: torch.Tensor, cos, sin, d_c: int, out: torch.Tensor,
            what: str) -> torch.Tensor:
    """Checks of the CUDA path and one launch over src's rows into out."""
    if src.dtype not in DTYPES:
        raise TypeError(f"{what} kernel takes f32 or bf16, got {src.dtype}")
    d_r = src.shape[1] - d_c
    if cos.device.type != "cpu" or sin.device.type != "cpu" \
            or cos.dtype != torch.float32 or sin.dtype != torch.float32 \
            or not (cos.is_contiguous() and sin.is_contiguous()):
        raise ValueError(f"{what} kernel: cos/sin must be contiguous f32 "
                         "host tensors (they travel in the launch)")
    if src.stride(1) != 1 or out.stride(1) != 1:
        raise ValueError(f"{what} kernel: source and out need unit column "
                         "stride")
    if src.data_ptr() != out.data_ptr() or src.stride() != out.stride():
        (a0, a1), (b0, b1) = _extent(src), _extent(out)
        if a0 < b1 and b0 < a1:
            raise ValueError(f"{what} kernel: out overlaps the source other "
                             "than as the same rows (in place)")
    S = src.shape[0]
    plan = launch_plan(src, out, d_c)
    if plan.blocks == 0:
        return out
    with torch.cuda.device(src.device):
        status = _launcher()(DTYPES[src.dtype], int(plan.vec),
                             src.data_ptr(), src.stride(0), out.data_ptr(),
                             out.stride(0), S, d_c, d_r // 2, cos.data_ptr(),
                             sin.data_ptr(), plan.blocks, plan.threads,
                             build.stream_of(src))
        build.check(status, what)
        delta_rotate.launches += 1
        delta_rotate.launches_by_card[src.device.index] += 1
    return out


def _check_out(out, src, what):
    if out is not None and (out.shape != src.shape
                            or out.device != src.device
                            or out.dtype != src.dtype):
        raise ValueError(f"{what}: out must match the source's shape, "
                         "device and dtype")


def delta_rotate(band: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate band (S, d_r) by the angles cos/sin (d_r/2,) into out (S, d_r)
    (allocated when None). band and out may be column slices of wider rows
    (any row stride, unit column stride). CPU tensors take the plain
    version."""
    if band.ndim != 2 or band.shape[1] % 2:
        raise ValueError(f"delta_rotate: band must be (S, d_r) with even "
                         f"d_r, got {tuple(band.shape)}")
    _check_angles(cos, sin, band.shape[1] // 2)
    _check_out(out, band, "delta_rotate")
    if band.device.type == "cpu":
        res = delta_rotate_ref(band, cos, sin)
        return res if out is None else out.copy_(res)
    if band.device.type != "cuda":
        raise ValueError(f"delta_rotate: unsupported device {band.device}")
    if out is None:
        out = torch.empty(band.shape, dtype=band.dtype, device=band.device)
    return _launch(band, cos, sin, 0, out, "delta_rotate")


delta_rotate.launches = 0
delta_rotate.launches_by_card = collections.Counter()


def splice_rotate(src: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  d_c: int, out: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The FETCH splice of src (N, d_c + d_r): out[:, :d_c] = src[:, :d_c]
    bit for bit, out[:, d_c:] = the band rotated by cos/sin (d_r/2,). out
    (allocated when None) is any (N, d_c + d_r) of src's dtype with unit
    column stride, for example rows of a pool, or src itself (in place).
    One kernel launch on CUDA; CPU tensors take the plain version."""
    if src.ndim != 2 or not 0 <= d_c < src.shape[1] \
            or (src.shape[1] - d_c) % 2:
        raise ValueError(f"splice_rotate: src must be (N, d_c + d_r) with "
                         f"even d_r, got {tuple(src.shape)} with d_c {d_c}")
    _check_angles(cos, sin, (src.shape[1] - d_c) // 2)
    _check_out(out, src, "splice_rotate")
    if src.device.type == "cpu":
        band = delta_rotate_ref(src[:, d_c:], cos, sin)
        if out is None:
            out = torch.empty(src.shape, dtype=src.dtype)
        out[:, :d_c].copy_(src[:, :d_c])
        out[:, d_c:].copy_(band)
        return out
    if src.device.type != "cuda":
        raise ValueError(f"splice_rotate: unsupported device {src.device}")
    if out is None:
        out = torch.empty(src.shape, dtype=src.dtype, device=src.device)
    return _launch(src, cos, sin, d_c, out, "splice_rotate")


def delta_rotate_band(band: torch.Tensor, delta, *, head_dim: int,
                      theta: float = 10000.0,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Re-home a fetched chunk's rope band (S, d_r) by delta positions."""
    cos, sin = delta_cos_sin(delta, head_dim, theta)
    return delta_rotate(band, cos, sin, out)
