"""FETCH — move-the-cache: the delta-rotation splice (§2.2, §7).

The splice re-homes a contiguous chunk cached at canonical offset p0 to the
requester's offset p0 + delta: a *purely positional* rotation of the
64-wide decoupled-RoPE band of every entry (the latent 512 columns are
position-invariant). The rotation angle depends only on delta, not on the
entry's own position, which is why the splice is flat in chunk size (§7).

Under sparse *selection* the chosen entries are attended at their canonical
positions, so no rotation is admissible (§3.3).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.delta_rotate import delta_rotate_band
from repro_torch.models.mla import MLAConfig


def splice_delta_rotate(ckv_chunk: torch.Tensor, delta,
                        cfg: MLAConfig) -> torch.Tensor:
    """Re-home a fetched chunk: rotate the rope band by delta positions.

    ckv_chunk (..., S, d_qk) -> a new array of the same shape (the moved
    copy). The latent columns are copied as they are; the band goes through
    the delta_rotate kernel wrapper, which reads it in place from the source
    and writes it in place into the copy (the kernel on the card, the plain
    version on the CPU). Delta 0 runs the rotation too (cos = 1, sin = 0),
    as the reference computes it."""
    d_c = cfg.kv_lora_rank
    src = ckv_chunk.reshape(-1, ckv_chunk.shape[-1])
    moved = torch.empty_like(src, memory_format=torch.contiguous_format)
    moved[:, :d_c].copy_(src[:, :d_c])
    delta_rotate_band(src[:, d_c:], delta, head_dim=cfg.qk_rope_head_dim,
                      theta=cfg.rope_theta, out=moved[:, d_c:])
    return moved.reshape(ckv_chunk.shape)
