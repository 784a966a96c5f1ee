"""Plain PyTorch version of the block-sparse selected attention kernel (the
selection regime, §5.4): the holder attends the indexer's chosen blocks in
place, at canonical positions."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.merge import Partial, partial_from_logits


def covered_rows(block_idx: torch.Tensor, kb: Optional[torch.Tensor],
                 lengths: Optional[torch.Tensor], block_tokens: int,
                 S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache rows the selected blocks cover: (rows (B, T), valid (B, T))
    with T = KB * block_tokens. Position t of batch row b is row
    block_idx[b, t // bt] * bt + t % bt; it is valid when t lies in the
    row's first kb[b] blocks, its block id is not negative and the row lies
    below lengths[b] (and S). Invalid positions carry row 0."""
    B, KB = block_idx.shape
    dev = block_idx.device
    t = torch.arange(KB * block_tokens, device=dev)
    blk = block_idx.to(torch.int64)[:, t // block_tokens]          # (B, T)
    rows = blk * block_tokens + (t % block_tokens)[None]
    limit = torch.full((B,), S, dtype=torch.int64, device=dev)
    if lengths is not None:
        limit = torch.clamp(lengths.to(device=dev, dtype=torch.int64), 0, S)
    valid = (blk >= 0) & (rows < limit[:, None])
    if kb is not None:
        valid &= t[None] < kb.to(device=dev, dtype=torch.int64)[:, None] \
            * block_tokens
    return torch.where(valid, rows, torch.zeros_like(rows)), valid


def sparse_select_ref(q: torch.Tensor, ckv: torch.Tensor,
                      block_idx: torch.Tensor, kb: Optional[torch.Tensor],
                      lengths: Optional[torch.Tensor], d_v: int,
                      block_tokens: int, scale: float = 1.0) -> Partial:
    """q (B, R, D); ckv (B, S, D), values = ckv[..., :d_v]; block_idx (B, KB)
    selected block ids, of which the first kb[b] count (None: all KB);
    lengths (B,) valid cache rows (None: all S).

    Gathers the covered rows (canonical positions — no re-rotation, §3.3)
    and attends them with one max and one sum. Returns Partial(o (B, R,
    d_v), m (B, R), l (B, R)) in f32; a row with nothing selected is the
    merge identity (o = 0, m = -inf, l = 0)."""
    rows, valid = covered_rows(block_idx.to(ckv.device), kb, lengths,
                               block_tokens, ckv.shape[1])
    sel = torch.gather(ckv, 1, rows[..., None].expand(-1, -1, ckv.shape[2]))
    logits = torch.matmul(q.to(torch.float32),
                          sel.to(torch.float32).transpose(-1, -2)) * scale
    return partial_from_logits(logits, sel[..., :d_v], valid[:, None, :])
