"""int8 error-feedback gradient compression for the cross-pod reduction,
the counterpart of repro.optim.compress.

At 1000+-node scale the cross-pod gradient sync is the scarce bandwidth.
Scheme: a per-tensor scale shared by every rank (the all-reduce MAX of
max|g|, / 127), quantize to int8, all-reduce (SUM) the int8 values as an
int32 payload over the pod group, dequantize (mean = sum * s / n); the
quantization residual feeds back into the next step's gradient (error
feedback keeps SGD convergence: the tests hold it to full-precision DP).

What the wire carries: the int8 values travel in an int32 payload (an
all-reduce SUM of int8 would overflow), so the bytes on the wire are an
f32 all-reduce's, plus one f32 scalar a tensor for the scale; the
reference sums an int32 payload too. wire_bytes_ratio() is the
reference's nominal 0.25 (int8 against f32), not what either package
sends: on four H100s NCCL logged 3 502 289 008 bytes for V2-Lite's
gradients cut to 2 layers against 3 502 288 896 for a plain f32
all-reduce of them, a ratio of 1.0000 (chip_smoke.py 5e (f3)). A payload
of int8 on the wire (an all-gather of the int8 values, summed locally)
would send a quarter.

The group is a mesh dim's process group (mesh.get_group("pod")); the
in-pod reduction stays full-precision.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_with_feedback(grads: Sequence[torch.Tensor],
                                  errors: Sequence[torch.Tensor], group):
    """Error-feedback compressed all-reduce over `group`: grads/errors are
    matching sequences (f32). Returns (mean-reduced grads, new errors),
    lists."""
    n = dist.get_world_size(group)

    def one(g, e):
        g = g.to(torch.float32) + e
        # shared scale across pods (a scalar MAX on the wire — negligible)
        # so the int8 sum dequantizes exactly: sum_i q_i * s / n
        amax = torch.max(torch.abs(g))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        s = amax / 127.0 + 1e-12
        q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
        new_e = g - q.to(torch.float32) * s   # residual -> next step
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        return summed.to(torch.float32) * s / n, new_e

    out = [one(g, e) for g, e in zip(grads, errors, strict=True)]
    return [o[0] for o in out], [o[1] for o in out]


def wire_bytes_ratio() -> float:
    """int8 vs f32 gradient values on the pod axis: the reference's
    nominal ratio (the payload on the wire is int32; module docstring)."""
    return 0.25
