"""Wrapper of the M-way merge kernel (csrc/softmax_merge.cu).

Replaces src/repro/kernels/softmax_merge/kernel.py:softmax_merge_pallas.
Byte-bound on this card (about 3 M operations per byte of o): one block per
(b, h) row, the M slot weights computed once per block into shared memory,
each thread merging four adjacent columns with one 16-byte load per slot.
The serving backend stacks a request's partials and launches it once per
request.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.merge import Partial
from repro_torch.kernels import build
from repro_torch.kernels.softmax_merge.ref import softmax_merge_ref

MAX_SLOTS = 256           # csrc MERGE_MAX_SLOTS


def _launcher():
    fn = build.library("softmax_merge").softmax_merge_f32
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, ctypes.c_long, I, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def softmax_merge(o: torch.Tensor, m: torch.Tensor,
                  l: torch.Tensor) -> Partial:
    """Merge M partials exactly (§3.3): o (M, ..., d_v), m/l (M, ...).
    Identity slots (m = -inf, l = 0) are no-ops. CPU tensors take the plain
    version."""
    if o.ndim < 2 or o.shape[0] < 1 or m.shape != o.shape[:-1] \
            or l.shape != m.shape:
        raise ValueError(f"softmax_merge: o must be (M, ..., d_v) and m/l "
                         f"(M, ...), got {tuple(o.shape)}, {tuple(m.shape)}, "
                         f"{tuple(l.shape)}")
    if not (o.device == m.device == l.device):
        raise ValueError("softmax_merge: o, m and l must share a device")
    if o.device.type == "cpu":
        return softmax_merge_ref(o, m, l)
    if o.device.type != "cuda":
        raise ValueError(f"softmax_merge: unsupported device {o.device}")
    if not all(t.dtype == torch.float32 for t in (o, m, l)):
        raise TypeError("softmax_merge kernel takes f32")
    if not all(t.is_contiguous() for t in (o, m, l)):
        raise ValueError("softmax_merge kernel: o, m, l must be contiguous")
    M, d_v = o.shape[0], o.shape[-1]
    if M > MAX_SLOTS:
        raise ValueError(f"softmax_merge kernel merges at most {MAX_SLOTS} "
                         f"partials, got {M}")
    lead = tuple(o.shape[1:-1])
    n_rows = math.prod(lead)
    with torch.cuda.device(o.device):
        oo = torch.empty(lead + (d_v,), dtype=torch.float32, device=o.device)
        mo = torch.empty(lead, dtype=torch.float32, device=o.device)
        lo = torch.empty(lead, dtype=torch.float32, device=o.device)
        status = _launcher()(o.data_ptr(), m.data_ptr(), l.data_ptr(), M,
                             n_rows, d_v, oo.data_ptr(), mo.data_ptr(),
                             lo.data_ptr(), build.stream_of(o))
        build.check(status, "softmax_merge")
        softmax_merge.launches += 1
    return Partial(o=oo, m=mo, l=lo)


softmax_merge.launches = 0
