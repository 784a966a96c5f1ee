"""Wrapper of the M-way merge kernel (csrc/softmax_merge.cu).

Replaces src/repro/kernels/softmax_merge/kernel.py:softmax_merge_pallas.
Byte-bound on this card, and at a serving request's size (a few KB to a
few hundred KB) latency-bound: each thread loads its (row, 4 columns)
item's M slots of o, m and l at once and computes the weights in
registers, one memory round trip. Two entries on the one kernel:
softmax_merge takes the partials stacked, (M, ..., d_v), up to MAX_SLOTS;
softmax_merge_parts takes up to MAX_PARTS partials where they lie, through
a table of pointers, so the serving backend merges a request's partials
in one launch with no stack copies. softmax_merge.launches counts the
kernel's launches through either entry.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Sequence

import torch

from repro_torch.core.merge import Partial
from repro_torch.kernels import build
from repro_torch.kernels.softmax_merge.ref import softmax_merge_ref

MAX_SLOTS = 256           # csrc MERGE_MAX_SLOTS: the stacked entry
MAX_PARTS = 16            # csrc MAX_PARTS: the in-place table (§6.3 elbow)


def _launcher(name: str):
    fn = getattr(build.library("softmax_merge"), name)
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        fn.argtypes = ([P, P, P] if name == "softmax_merge_f32"
                       else [ctypes.POINTER(P)]) + [I, L, I, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def _outputs(lead, d_v, device):
    return (torch.empty(lead + (d_v,), dtype=torch.float32, device=device),
            torch.empty(lead, dtype=torch.float32, device=device),
            torch.empty(lead, dtype=torch.float32, device=device))


def softmax_merge(o: torch.Tensor, m: torch.Tensor,
                  l: torch.Tensor) -> Partial:
    """Merge M partials exactly (§3.3): o (M, ..., d_v), m/l (M, ...).
    Identity slots (m = -inf, l = 0) are no-ops. o, m and l may be bf16 or
    f16: they are cast to f32 first, as the reference's kernel casts them.
    CPU tensors take the plain version. A DTensor raises TypeError (on a
    mesh: distributed.sharding.local_seq_partials gathers and merges)."""
    build.refuse_dtensor(
        "softmax_merge", "on a mesh merge the ranks' partials through "
        "repro_torch.distributed.sharding.local_seq_partials", o, m, l)
    if o.ndim < 2 or o.shape[0] < 1 or m.shape != o.shape[:-1] \
            or l.shape != m.shape:
        raise ValueError(f"softmax_merge: o must be (M, ..., d_v) and m/l "
                         f"(M, ...), got {tuple(o.shape)}, {tuple(m.shape)}, "
                         f"{tuple(l.shape)}")
    if not (o.device == m.device == l.device):
        raise ValueError("softmax_merge: o, m and l must share a device")
    o, m, l = build.as_f32("softmax_merge", o, m, l)
    if o.device.type == "cpu":
        return softmax_merge_ref(o, m, l)
    if o.device.type != "cuda":
        raise ValueError(f"softmax_merge: unsupported device {o.device}")
    if not all(t.is_contiguous() for t in (o, m, l)):
        raise ValueError("softmax_merge kernel: o, m, l must be contiguous")
    M, d_v = o.shape[0], o.shape[-1]
    if M > MAX_SLOTS:
        raise ValueError(f"softmax_merge kernel merges at most {MAX_SLOTS} "
                         f"partials, got {M}")
    lead = tuple(o.shape[1:-1])
    with torch.cuda.device(o.device):
        oo, mo, lo = _outputs(lead, d_v, o.device)
        status = _launcher("softmax_merge_f32")(
            o.data_ptr(), m.data_ptr(), l.data_ptr(), M, mo.numel(), d_v,
            oo.data_ptr(), mo.data_ptr(), lo.data_ptr(), build.stream_of(o))
        build.check(status, "softmax_merge")
        softmax_merge.launches += 1
        softmax_merge.launches_by_card[o.device.index] += 1
    return Partial(o=oo, m=mo, l=lo)


softmax_merge.launches = 0
softmax_merge.launches_by_card = collections.Counter()


def softmax_merge_parts(parts: Sequence[Partial]) -> Partial:
    """Merge M <= MAX_PARTS partials exactly where they lie: each part's o
    (..., d_v) and m/l (...) of one shape, contiguous. The same result as
    softmax_merge on their stack, bit for bit, without the stack. Raises,
    rather than copies, for more than MAX_PARTS parts or a part that is not
    contiguous: callers with more stack them and call softmax_merge. Parts
    in bf16 or f16 are cast to f32 first. CPU tensors take the plain
    version."""
    M = len(parts)
    if not 1 <= M <= MAX_PARTS:
        raise ValueError(f"softmax_merge_parts: 1 to {MAX_PARTS} partials, "
                         f"got {M}: stack more and call softmax_merge")
    shape, device = parts[0].o.shape, parts[0].o.device
    lead = shape[:-1]
    for i, (o, m, l) in enumerate(parts):
        if not shape or o.shape != shape or m.shape != lead \
                or l.shape != lead:
            raise ValueError(f"softmax_merge_parts: part {i} has o "
                             f"{tuple(o.shape)}, m {tuple(m.shape)}, l "
                             f"{tuple(l.shape)}; want o {tuple(shape)} and "
                             f"m/l {tuple(lead)}")
        if o.device != device or m.device != device or l.device != device:
            raise ValueError("softmax_merge_parts: every part must lie on "
                             f"{device}")
        if not (o.is_contiguous() and m.is_contiguous()
                and l.is_contiguous()):
            raise ValueError(f"softmax_merge_parts: part {i} is not "
                             f"contiguous (the kernel reads it in place)")
    parts = [Partial(*build.as_f32("softmax_merge_parts", *p))
             for p in parts]
    if device.type == "cpu":
        return softmax_merge_ref(*(torch.stack([p[k] for p in parts])
                                   for k in range(3)))
    if device.type != "cuda":
        raise ValueError(f"softmax_merge_parts: unsupported device {device}")
    # the slot table: the M o pointers, then the M m, then the M l
    table = (ctypes.c_void_p * (3 * M))(*[p[k].data_ptr() for k in range(3)
                                          for p in parts])
    with torch.cuda.device(device):
        oo, mo, lo = _outputs(tuple(lead), shape[-1], device)
        status = _launcher("softmax_merge_parts_f32")(
            table, M, mo.numel(), shape[-1], oo.data_ptr(), mo.data_ptr(),
            lo.data_ptr(), build.stream_of(oo))
        build.check(status, "softmax_merge")
        softmax_merge.launches += 1
        softmax_merge.launches_by_card[device.index] += 1
    return Partial(o=oo, m=mo, l=lo)
