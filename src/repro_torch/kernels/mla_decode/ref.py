"""Plain PyTorch version of the absorbed-MLA decode kernel (the holder-side
partial attention of ROUTE, §6.3)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.merge import Partial, partial_from_logits


def mla_decode_ref(q: torch.Tensor, ckv: torch.Tensor,
                   lengths: Optional[torch.Tensor], d_v: int,
                   scale: float = 1.0) -> Partial:
    """q (B, R, D); ckv (B, S, D) with values = ckv[..., :d_v]; lengths
    (B,) valid cache rows per batch row, or None for all S.

    Returns Partial(o (B, R, d_v), m (B, R), l (B, R)) in f32. A row with
    no valid entries is the merge identity (o = 0, m = -inf, l = 0)."""
    logits = torch.matmul(q.to(torch.float32),
                          ckv.to(torch.float32).transpose(-1, -2)) * scale
    mask = None
    if lengths is not None:
        pos = torch.arange(ckv.shape[1], device=ckv.device)
        mask = pos[None, None, :] < lengths.to(ckv.device)[:, None, None]
    return partial_from_logits(logits, ckv[..., :d_v], mask)
