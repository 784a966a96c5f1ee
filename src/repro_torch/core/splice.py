"""FETCH — move-the-cache: bulk pull + delta-rotation splice (§2.2, §7).

The splice re-homes a contiguous chunk cached at canonical offset p0 to the
requester's offset p0 + delta: a *purely positional* rotation of the
64-wide decoupled-RoPE band of every entry (the latent 512 columns are
position-invariant). The rotation angle depends only on delta, not on the
entry's own position, which is why the splice is flat in chunk size (§7).

Under sparse *selection* the chosen entries are attended at their canonical
positions, so no rotation is admissible (§3.3).

fetch_chunk and fetch_scattered_gather are the FETCH primitive between
instances of an InstanceMesh (core/instance_mesh.py): the holder's rows land
in the requester's pool rows, written on the requester's stream after
everything the holder issued. Within one slot the pull and the splice are
one delta_rotate launch that reads the holder's rows and writes the
requester's; between slots the rows are pulled, then spliced in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.instance_mesh import InstanceMesh
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


def fetch_chunk(mesh: InstanceMesh, local_pool: torch.Tensor,
                remote_ckv: torch.Tensor, delta, dst_offset: int,
                cfg: MLAConfig, holder: int, requester: int) -> torch.Tensor:
    """The full FETCH primitive: pull the holder's chunk remote_ckv (S,
    d_qk) into rows [dst_offset, dst_offset + S) of the requester's pool
    local_pool (P, d_qk), splicing it by delta on the way; returns the
    pool. Within one slot that is one splice_delta_rotate launch from the
    holder's rows into the pool's, on the requester's stream. Between two
    slots the chunk is pulled into the pool's rows (mesh.pull: a peer copy
    where the slots are two cards) and spliced there in place, on the
    requester's card: the same bits, the rotation being elementwise. delta
    None elides the rotation (a true-prefix re-home, §6.3): a plain
    copy."""
    rows = local_pool.narrow(-2, dst_offset, remote_ckv.shape[-2])
    if mesh.slot_of(holder) != mesh.slot_of(requester):
        mesh.pull(remote_ckv, holder, requester, out=rows)
        if delta is not None:
            with mesh.on(requester, local_pool):
                splice_delta_rotate(rows, delta, cfg, out=rows)
        return local_pool
    mesh.after(requester, holder)
    with mesh.on(requester, remote_ckv, local_pool):
        if delta is None:
            rows.copy_(remote_ckv, non_blocking=True)
        else:
            splice_delta_rotate(remote_ckv, delta, cfg, out=rows)
    return local_pool


def fetch_scattered_gather(mesh: InstanceMesh, local_pool: torch.Tensor,
                           remote_ckv: torch.Tensor, indices: torch.Tensor,
                           dst_offset: int, cfg: MLAConfig, holder: int,
                           requester: int) -> torch.Tensor:
    """The selection-regime FETCH (§5.4): the holder gathers the k chosen
    entries (index_select on its stream) and they are pulled into rows
    [dst_offset, dst_offset + k) of the requester's pool. NO splice — the
    entries stay at canonical positions."""
    with mesh.on(holder, remote_ckv, indices):
        gathered = remote_ckv.index_select(-2, indices)
    rows = local_pool.narrow(-2, dst_offset, gathered.shape[-2])
    mesh.pull(gathered, holder, requester, out=rows)
    return local_pool
