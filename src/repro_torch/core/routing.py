"""Cross-instance query routing — "move the query, not the cache" (§2, §3.3),
single-process form.

route_simulated attends an arbitrary partition of the cache shard by shard
and merges the partials; the online-softmax merge is associative and
commutative with an identity (core/merge.py), so the result equals
attention over the concatenated shards to float round-off. The collective
transports (fanout / pairwise / ring over torch.distributed) come with the
multi-instance backend.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.constants import NSA_BLOCK_TOKENS
from repro_torch.core.merge import Partial
from repro_torch.kernels.softmax_merge import softmax_merge
from repro_torch.models.mla import (MLAConfig, absorbed_partial,
                                    selected_partial)

Blocks = Sequence[int]


def _shard_partial(cfg, q_abs, shard, mask, blocks, block_tokens) -> Partial:
    if blocks is not None:
        return selected_partial(cfg, q_abs, shard, blocks, block_tokens)
    return absorbed_partial(cfg, q_abs, shard, mask)


def route_simulated(cfg: MLAConfig, q_abs: torch.Tensor,
                    shards: Sequence[torch.Tensor],
                    masks: Optional[Sequence[torch.Tensor]] = None,
                    blocks: Optional[Sequence[Blocks]] = None,
                    block_tokens: int = NSA_BLOCK_TOKENS) -> Partial:
    """Merge partial attention over an arbitrary partition of the cache.

    q_abs (..., H, d_qk); shards: list of (S_i, d_qk) resident subsets.
    Under a selection each holder attends only its selected & resident
    entries: blocks[i] (ascending block ids of block_tokens rows — what the
    serving path passes, straight to sparse_select) or masks[i] (an
    (S_i,)-style token mask). Several shards merge in one softmax_merge
    call."""
    parts = [_shard_partial(cfg, q_abs, shard,
                            None if masks is None else masks[i],
                            None if blocks is None else blocks[i],
                            block_tokens)
             for i, shard in enumerate(shards)]
    if len(parts) == 1:
        return parts[0]
    return softmax_merge(torch.stack([p.o for p in parts]),
                         torch.stack([p.m for p in parts]),
                         torch.stack([p.l for p in parts]))


def route_batched(cfg: MLAConfig, queries: Sequence[torch.Tensor],
                  holder_shards: Sequence[Sequence[torch.Tensor]],
                  masks: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                  blocks: Optional[Sequence[Sequence[Blocks]]] = None,
                  block_tokens: int = NSA_BLOCK_TOKENS) -> "list[Partial]":
    """Batched multi-holder routing, keyed by a dispatch plan: group g ships
    queries[g] (the plan's stacked requester rows, (m_q_total, H, d_qk)) to
    every holder in holder_shards[g] and returns the g-th merged Partial —
    one holder-side batched partial per holder (the §6.3 "batched partial
    is ~free" kernel shape), merged requester-side."""
    if len(queries) != len(holder_shards):
        raise ValueError(
            f"{len(queries)} query groups vs {len(holder_shards)} shard sets")
    return [route_simulated(cfg, q, shards,
                            None if masks is None else masks[g],
                            None if blocks is None else blocks[g],
                            block_tokens)
            for g, (q, shards) in enumerate(zip(queries, holder_shards))]
