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

from typing import Optional

import torch

from repro_torch.kernels.delta_rotate import delta_cos_sin, splice_rotate
from repro_torch.models.mla import MLAConfig


def splice_delta_rotate(ckv_chunk: torch.Tensor, delta, cfg: MLAConfig,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Re-home a fetched chunk: rotate the rope band by delta positions.

    ckv_chunk (..., S, d_qk) -> the moved copy, of the same shape: the
    latent columns as they are, the band rotated. The leading dims are
    free, so a model's whole latent cache of one chunk, (n_layers, S,
    d_qk), is one call. One splice_rotate call over all the rows (one
    kernel launch on the card, the plain version on the CPU). out, when
    given, receives the moved copy and is returned: any tensor of the
    chunk's shape and dtype whose rows have one pitch, for example rows of
    the requester's pool, so the splice writes there with no staging copy;
    it may be ckv_chunk itself (in place, where the source copy is not
    kept). Otherwise a new tensor is allocated. Delta 0 runs the rotation
    too (cos = 1, sin = 0), as the reference computes it."""
    d_qk = ckv_chunk.shape[-1]
    src = ckv_chunk.reshape(-1, d_qk)
    if out is None:
        moved = torch.empty(src.shape, dtype=src.dtype, device=src.device)
    else:
        if out.shape != ckv_chunk.shape:
            raise ValueError(f"splice_delta_rotate: out {tuple(out.shape)} "
                             f"!= chunk {tuple(ckv_chunk.shape)}")
        moved = out.view(-1, d_qk)        # raises if the rows' pitch varies
    cos, sin = delta_cos_sin(delta, cfg.qk_rope_head_dim, cfg.rope_theta)
    splice_rotate(src, cos, sin, cfg.kv_lora_rank, out=moved)
    return moved.view(ckv_chunk.shape) if out is None else out
