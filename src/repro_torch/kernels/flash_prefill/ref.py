"""Plain PyTorch version of the causal latent flash-prefill kernel: causal
attention of absorbed queries over the c^KV store (the prefill hot-spot that
fills the canonical cache)."""

from __future__ import annotations

import torch


def flash_prefill_ref(q: torch.Tensor, ckv: torch.Tensor, d_v: int,
                      scale: float = 1.0) -> torch.Tensor:
    """q (B, Sq, H, D); ckv (B, Sk, D) with Sq <= Sk; causal with queries
    aligned to the cache tail (query i attends entries [0, Sk - Sq + i]).
    Values are ckv[..., :d_v]. Returns (B, Sq, H, d_v) f32."""
    Sq, Sk = q.shape[1], ckv.shape[1]
    if Sq > Sk:
        raise ValueError(f"flash_prefill: Sq={Sq} > Sk={Sk}")
    ckv = ckv.to(torch.float32)
    logits = torch.einsum("bqhd,bkd->bhqk", q.to(torch.float32), ckv) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    mask = qpos >= torch.arange(Sk, device=q.device)[None, :]
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkd->bqhd", p, ckv[..., :d_v])
