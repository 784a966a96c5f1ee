"""Shared layers, the subset the decode path needs: RMSNorm and RoPE.

RoPE uses the NeoX half-split pairing. rope(p + delta) = R(delta) . rope(p)
per frequency pair — the composition property the FETCH delta-rotation
splice (paper §2.2) relies on.
"""

from __future__ import annotations

import numpy as np
import torch


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32)).to(dt)


def rope_freqs(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0):
    """positions (...,) -> cos/sin (..., head_dim/2) in f32."""
    freqs = torch.tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                         device=positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., head_dim); cos/sin broadcastable (..., head_dim/2)."""
    d2 = x.shape[-1] // 2
    xf1 = x[..., :d2].to(torch.float32)
    xf2 = x[..., d2:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def delta_rotate(x: torch.Tensor, delta, head_dim: int,
                 theta: float = 10000.0) -> torch.Tensor:
    """Re-home a RoPE-encoded band from cached position p to p + delta: a
    purely positional rotation, independent of the token's own position."""
    cos, sin = rope_cos_sin(torch.as_tensor(delta, device=x.device),
                            head_dim, theta)
    return apply_rope(x, cos, sin)
