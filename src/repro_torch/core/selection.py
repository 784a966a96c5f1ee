"""Sparse selection — the indexer regime (§5.4): DSA/NSA-style top-k.

A lightweight indexer scores every cached entry per query and keeps the
top-k, at token granularity (DSA) or at 64-token block granularity (NSA).
The block form is what kernels/sparse_select consumes: the kernel reads each
selected block as contiguous cache rows.

ROUTE under selection is "the indexer's choice made distributed" (§5.4): the
selected set is scattered across holders; each holder attends its resident
subset of the selection in place and the partials merge — no gather, no
re-rotation.

The learned indexer's parameters are a {"q_proj", "k_proj"} dict of tensors
(init_indexer); the serving indexer needs none (latent_index_keys).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import constants as C
from repro_torch.models.module import param


@dataclasses.dataclass(frozen=True)
class IndexerConfig:
    d_model: int = 2048
    d_index: int = 64          # lightweight score-projection width
    k_tokens: int = 2048       # selection budget (V3.2/GLM-5.1 default)
    block_tokens: int = C.NSA_BLOCK_TOKENS   # 64


def init_indexer(gen, cfg: IndexerConfig, *, dtype=torch.bfloat16,
                 device="cuda"):
    """The lightweight score projections, drawn from gen on device."""
    shape = (cfg.d_model, cfg.d_index)
    return {"q_proj": param(shape, gen, dtype=dtype, device=device,
                            axes=("embed", None)),
            "k_proj": param(shape, gen, dtype=dtype, device=device,
                            axes=("embed", None))}


def index_scores(p, x_q: torch.Tensor, keys_idx: torch.Tensor) -> torch.Tensor:
    """x_q (..., D) query hidden state; keys_idx (S, d_index) precomputed
    index keys for the cache. Returns (..., S) relevance scores in f32."""
    q = x_q @ p["q_proj"]
    return torch.einsum("...d,sd->...s", q.to(torch.float32),
                        keys_idx.to(torch.float32))


def index_keys(p, x_ctx: torch.Tensor) -> torch.Tensor:
    """Precompute per-token index keys at prefill (cached alongside c^KV)."""
    return x_ctx @ p["k_proj"]


def topk_tokens(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(.., S) -> (.., k) selected token indices (DSA index_topk)."""
    return torch.topk(scores, k, dim=-1).indices


def topk_blocks(scores: torch.Tensor, block_tokens: int,
                k_blocks: int) -> torch.Tensor:
    """Block-granular selection (NSA): aggregate token scores per block by
    max, keep the top-k_blocks blocks. Returns block_idx (.., k_blocks) —
    k_blocks clamped to the block count.

    The tail is PADDED to the block boundary with -inf, so a partial last
    block competes on its real token scores; block_mask_to_tokens agrees on
    the padded length."""
    s = scores.shape[-1]
    n_blocks = -(-s // block_tokens)                    # ceil: tail counts
    pad = n_blocks * block_tokens - s
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad),
                                         value=float("-inf"))
    blocked = scores.reshape(scores.shape[:-1] + (n_blocks, block_tokens))
    bs = torch.amax(blocked, dim=-1)
    return torch.topk(bs, min(k_blocks, n_blocks), dim=-1).indices


def selection_mask(idx_tokens: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(.., k) indices -> (.., S) boolean mask (for masked partial attention:
    the holder attends selected & resident in place)."""
    mask = torch.zeros(idx_tokens.shape[:-1] + (seq_len,), dtype=torch.bool,
                       device=idx_tokens.device)
    return mask.scatter_(-1, idx_tokens.long(), True)


def block_mask_to_tokens(block_idx: torch.Tensor, block_tokens: int,
                         seq_len: int) -> torch.Tensor:
    """(.., kb) block indices -> (.., S) token mask. Counts blocks on the
    same padded length topk_blocks selects over (ceil, so the tail block is
    addressable), then truncates the mask back to seq_len."""
    n_blocks = -(-seq_len // block_tokens)
    blocks = selection_mask(block_idx, n_blocks)            # (.., n_blocks)
    return torch.repeat_interleave(blocks, block_tokens,
                                   dim=-1)[..., :seq_len]


def latent_index_keys(ckv, d_index: int):
    """The parameter-free DSA index-key rule: a token's index key IS the
    leading d_index latent columns of its c^KV entry (the position-invariant
    band — k_rope never enters the score, so keys need no re-rotation when a
    chunk moves). This is what the chunk store keeps as the index sidecar
    (Chunk.index_keys) next to the cache bytes; a slice of a numpy array or
    a tensor."""
    return ckv[..., :d_index]


def block_scores(scores, block_tokens: int) -> np.ndarray:
    """numpy mirror of topk_blocks' padded block aggregation, for the
    host-side serving indexer: per-block max of token scores, tail padded to
    the boundary with -inf so a partial last block competes on its real
    scores. (.., S) -> (.., ceil(S/bt))."""
    s = np.asarray(scores)
    n = s.shape[-1]
    n_blocks = -(-n // block_tokens)
    pad = n_blocks * block_tokens - n
    if pad:
        s = np.concatenate(
            [s, np.full(s.shape[:-1] + (pad,), -np.inf, s.dtype)], axis=-1)
    return s.reshape(s.shape[:-1] + (n_blocks, block_tokens)).max(axis=-1)


def residency_split(idx_tokens, shard_bounds) -> list:
    """Partition selected canonical indices by holder: holder j owns
    [bounds[j], bounds[j+1]). Returns per-holder *local* masks — the
    distributed form of the selection (§5.4). Host-side helper for the
    serving engine (numpy, small arrays)."""
    idx = np.asarray(idx_tokens)
    out = []
    for j in range(len(shard_bounds) - 1):
        lo, hi = shard_bounds[j], shard_bounds[j + 1]
        local = idx[(idx >= lo) & (idx < hi)] - lo
        mask = np.zeros(hi - lo, bool)
        mask[local] = True
        out.append(mask)
    return out
