"""Plain PyTorch version of the FETCH-splice delta rotation (§2.2)."""

from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope


def delta_rotate_ref(band: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """band (S, d_r) rope-encoded at cached positions; cos/sin (d_r/2,) of
    the one delta -> the band re-homed by delta."""
    return apply_rope(band, cos.to(band.device), sin.to(band.device))
