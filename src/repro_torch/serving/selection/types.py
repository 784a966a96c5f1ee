"""Numpy-only data types of the selection subsystem.

A RequestSelection is the indexer's verdict for one request at one decode
step: which NSA blocks (64-token granularity) of which chunks made the
global top-k, plus the per-chunk boolean token masks the plan layer
threads to the backends. It must stay importable without jax — the
planner and the ReplaySelector (trace replay) are numpy-only; only the
live IndexerService (repro.serving.selection.service) touches jax.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import numpy as np


def token_mask(block_ids: Iterable[int], block_tokens: int,
               length: int) -> np.ndarray:
    """Selected block ids -> (length,) bool token mask. Blocks are counted
    on the padded length (ceil — core.selection.topk_blocks' convention, so
    a partial tail block is addressable) and the mask truncates back."""
    n_blocks = -(-length // block_tokens)
    bm = np.zeros(n_blocks, bool)
    ids = list(block_ids)
    if ids:
        bm[np.asarray(ids, np.int64)] = True
    return np.repeat(bm, block_tokens)[:length]


@dataclasses.dataclass(frozen=True)
class RequestSelection:
    """One request's global top-k selection, split per chunk (the
    distributed form of §5.4: each holder attends selected & resident)."""
    req_id: int
    block_tokens: int
    blocks: Dict[str, Tuple[int, ...]]      # chunk_id -> block ids, ascending
    masks: Dict[str, np.ndarray]            # chunk_id -> (c_t,) bool mask

    @property
    def k_eff(self) -> int:
        """Selected tokens across every chunk (the block-rounded budget)."""
        return int(sum(int(m.sum()) for m in self.masks.values()))

    def k_on(self, chunk_id: str) -> int:
        """Selected tokens resident in one chunk (0: the indexer chose
        nothing there — the query still fans out, the partial is identity)."""
        m = self.masks.get(chunk_id)
        return 0 if m is None else int(m.sum())

    def kb_on(self, chunk_id: str) -> int:
        """Selected blocks in one chunk."""
        return len(self.blocks.get(chunk_id, ()))
