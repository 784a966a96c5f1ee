"""Plain PyTorch version of the M-way online-softmax merge
(== core.merge.merge_stacked)."""

from __future__ import annotations

import torch

from repro_torch.core.merge import Partial, merge_stacked


def softmax_merge_ref(o: torch.Tensor, m: torch.Tensor,
                      l: torch.Tensor) -> Partial:
    """o (M, ..., d_v); m/l (M, ...) -> merged Partial (..., d_v), in f32
    from operands of any floating dtype (the reference's kernel casts)."""
    f32 = torch.float32
    return merge_stacked(o.to(f32), m.to(f32), l.to(f32))
