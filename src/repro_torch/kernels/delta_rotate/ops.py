"""Wrapper of the splice delta-rotation kernel (csrc/delta_rotate.cu).

Replaces src/repro/kernels/delta_rotate/kernel.py:delta_rotate_pallas.
Byte-bound on this card, and at a 2048-token chunk's band (512 KB each
way) bound in practice by its launch: one thread per (row, frequency pair),
reading the band through its row pitch from the source copy and writing it
through its row pitch into the destination, so the splice needs no
contiguous staging copy of the band. cos/sin are computed once on the host
(rope_cos_sin of the delta, f32) and passed by value in the launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.delta_rotate.ref import delta_rotate_ref
from repro_torch.models.layers import rope_cos_sin

MAX_PAIRS = 64            # csrc MAX_PAIRS: d_r <= 128


def _launcher():
    fn = build.library("delta_rotate").delta_rotate_f32
    if fn.argtypes is None:
        P, L = ctypes.c_void_p, ctypes.c_long
        fn.argtypes = [P, L, P, L, L, ctypes.c_int, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def delta_cos_sin(delta, head_dim: int, theta: float = 10000.0):
    """cos/sin (head_dim/2,) f32 on the host for one position delta."""
    d = torch.as_tensor(delta, dtype=torch.float32).to("cpu")
    cos, sin = rope_cos_sin(d, head_dim, theta)
    return cos.contiguous(), sin.contiguous()


def delta_rotate(band: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate band (S, d_r) by the angles cos/sin (d_r/2,) into out (S, d_r)
    (allocated when None). band and out may be column slices of wider rows
    (any row stride, unit column stride). CPU tensors take the plain
    version."""
    if band.ndim != 2 or band.shape[1] % 2:
        raise ValueError(f"delta_rotate: band must be (S, d_r) with even "
                         f"d_r, got {tuple(band.shape)}")
    d2 = band.shape[1] // 2
    if tuple(cos.shape) != (d2,) or tuple(sin.shape) != (d2,):
        raise ValueError(f"delta_rotate: cos/sin must be ({d2},), got "
                         f"{tuple(cos.shape)}, {tuple(sin.shape)}")
    if out is not None and (out.shape != band.shape
                            or out.device != band.device
                            or out.dtype != band.dtype):
        raise ValueError("delta_rotate: out must match band's shape, device "
                         "and dtype")
    if band.device.type == "cpu":
        res = delta_rotate_ref(band, cos, sin)
        return res if out is None else out.copy_(res)
    if band.device.type != "cuda":
        raise ValueError(f"delta_rotate: unsupported device {band.device}")
    if band.dtype != torch.float32:
        raise TypeError(f"delta_rotate kernel takes f32, got {band.dtype}")
    if d2 > MAX_PAIRS:
        raise ValueError(f"delta_rotate kernel: d_r <= {2 * MAX_PAIRS}")
    if cos.device.type != "cpu" or sin.device.type != "cpu" \
            or cos.dtype != torch.float32 or sin.dtype != torch.float32 \
            or not (cos.is_contiguous() and sin.is_contiguous()):
        raise ValueError("delta_rotate kernel: cos/sin must be contiguous "
                         "f32 host tensors (they travel in the launch)")
    if out is None:
        out = torch.empty(band.shape, dtype=band.dtype, device=band.device)
    if band.stride(1) != 1 or out.stride(1) != 1:
        raise ValueError("delta_rotate kernel: band and out need unit "
                         "column stride")
    with torch.cuda.device(band.device):
        status = _launcher()(band.data_ptr(), band.stride(0), out.data_ptr(),
                             out.stride(0), band.shape[0], d2,
                             cos.data_ptr(), sin.data_ptr(),
                             build.stream_of(band))
        build.check(status, "delta_rotate")
        delta_rotate.launches += 1
    return out


delta_rotate.launches = 0


def delta_rotate_band(band: torch.Tensor, delta, *, head_dim: int,
                      theta: float = 10000.0,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Re-home a fetched chunk's rope band (S, d_r) by delta positions."""
    cos, sin = delta_cos_sin(delta, head_dim, theta)
    return delta_rotate(band, cos, sin, out)
