"""The distributed indexer service (§5.4): score -> select ->
scatter-attend, through the scheduler.

Per decode step, for every request in the selection regime:

  score  — the requester derives a NARROW indexer query from its absorbed
           decode rows (the DSA rule: mean-over-heads of the leading
           d_index latent columns) and broadcasts it to every holder of the
           request's chunks; each holder scores its RESIDENT index keys
           (the chunk store's sidecar, materialized alongside c^KV).
  select — each holder pools scores over the request's query rows, takes a
           LOCAL top-k at NSA 64-token block granularity (padded tail —
           core.selection.block_scores), and returns (block, score)
           candidates; the requester merges them into the GLOBAL top-k.
           Because every holder keeps its k best under one strict total
           order (score desc, then chunk order, then block id), the merged
           set equals the single-instance top-k over the concatenated
           cache — the distributed form is exact, not approximate.
  scatter-attend — the resulting per-(request, chunk) block ids and masks
           (RequestSelection) ride the StepPlan into the backends: the exec
           backend attends the selected blocks in place (sparse_select) and
           merges partials.

Everything here is host-side control plane on small arrays: scoring runs
in numpy f32 on host copies of the query and of the index keys, so the
verdicts are bit-identical to the JAX package's on the same arrays and
queries (scored on the card in another summation order, near-ties could
flip a block). torch appears only to materialize the canonical chunk arrays
and queries — the exec backend's deterministic materialization, on the same
device — and to copy them to the host: one transfer per chunk at first
touch, one per selected request per step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core import constants as C
from repro_torch.core import selection as SEL
from repro_torch.core.chunk_store import ChunkStore
from repro_torch.models.mla import MLAConfig
from repro_torch.serving.backends.torch_exec import (TINY_MLA, QuerySource,
                                                     chunk_array, query_for)
from repro_torch.serving.plan import Request
from repro_torch.serving.selection.types import RequestSelection, token_mask

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.serving.engine import ServingEngine


def pooled_max(scores: np.ndarray) -> np.ndarray:
    """Pool index scores over a request's query rows: max — a token ANY
    row wants is kept. (S,) from (m_q, S)."""
    return np.asarray(scores).max(axis=0)


@dataclasses.dataclass(frozen=True)
class SelectionConfig:
    block_tokens: int = C.NSA_BLOCK_TOKENS          # NSA granularity (64)
    # scoring-projection width; None -> the full latent band (d_c), the
    # parameter-free DSA decode rule
    d_index: Optional[int] = None


class IndexerService:
    """The live scoring service. mla, dtype and device fix the EXECUTION
    geometry and must match the engine's TorchExecBackend, and so must the
    query source when the backend was given one: indexer queries and index
    keys then derive from the same tensors the backend attends with. The
    planner's cost payload is independent, as everywhere else."""

    name = "indexer"

    def __init__(self, cfg: SelectionConfig = SelectionConfig(),
                 mla: MLAConfig = TINY_MLA, dtype=torch.float32,
                 device="cuda", query_source: Optional[QuerySource] = None):
        self.cfg = cfg
        self.mla = mla
        self.dtype = dtype
        self.device = torch.device(device)
        self.query_source = query_source
        self.block_tokens = cfg.block_tokens
        self.d_index = cfg.d_index or mla.kv_lora_rank
        # every verdict, by engine step — the recordable selection trace
        # (repro_torch.serving.selection.replay.save_selection_trace)
        self.log: Dict[int, Dict[int, RequestSelection]] = {}
        # service telemetry, read by the obs metrics registry: roundtrips =
        # per-(request, chunk) scoring round trips, merges = requester-side
        # global merges, merge_candidates / merge_selected = cumulative
        # candidate-in / block-out volumes of those merges.
        self.obs_counts: Dict[str, int] = {
            "roundtrips": 0, "merges": 0,
            "merge_candidates": 0, "merge_selected": 0}
        # per-merge candidate-set sizes since the last drain — bounded by
        # the obs layer draining every step into a streaming histogram
        self._merge_sizes: List[int] = []

    def drain_merge_sizes(self) -> List[int]:
        """Per-merge candidate counts accumulated since the last call
        (the obs layer folds them into a histogram once per step)."""
        out = self._merge_sizes
        self._merge_sizes = []
        return out

    # -- sidecar materialization --------------------------------------------

    def ensure_index_keys(self, store: ChunkStore,
                          chunk_id: str) -> np.ndarray:
        """The chunk's index keys, materializing the sidecar on first
        touch: the leading d_index latent columns of the canonical c^KV
        entries (core.selection.latent_index_keys — position-invariant, so
        replicas carry byte-identical keys), copied to the host as a
        contiguous f32 array: scoring is host-side control plane."""
        chunk = store.lookup(chunk_id)
        if chunk.index_keys is None:
            src = chunk.data
            if src is None:
                # analytic engines never materialize c^KV; derive the keys
                # from the same deterministic array exec would attend
                src = chunk_array(self.mla, chunk_id, chunk.length,
                                  self.dtype, self.device)
            keys = SEL.latent_index_keys(src, self.d_index).cpu().numpy()
            store.attach_index_keys(
                chunk_id, np.ascontiguousarray(keys, np.float32))
        return np.asarray(chunk.index_keys)

    # -- scoring ------------------------------------------------------------

    def index_query(self, rq: Request, step: int) -> np.ndarray:
        """The request's narrow indexer query rows (m_q, d_index): mean
        over heads, in numpy, of the latent band of the SAME absorbed
        decode queries the exec backend attends with (the query source
        when one was given, else query_for) — the DSA scoring rule, so
        single-instance selection_k decode is the oracle this service must
        reproduce."""
        if self.query_source is not None:
            q = np.asarray(self.query_source(rq, step), np.float32)
        else:
            q = query_for(self.mla, rq, step, self.dtype,
                          self.device).cpu().numpy()
        return q[..., :self.d_index].mean(axis=1)

    def pooled_scores(self, store: ChunkStore, rq: Request, iq: np.ndarray,
                      chunk_id: str, step: int) -> np.ndarray:
        """One holder's scoring round: index_scores over the chunk's
        resident keys, max-pooled over the request's query rows (a token
        any row wants is kept) -> (S,). The distributed hook: a mesh
        service overrides exactly this — the candidate policy downstream
        (topk_from_pooled, _merge) is shared, so two services can only
        differ in where scores are computed."""
        keys = self.ensure_index_keys(store, chunk_id)
        scores = iq @ keys.T                       # (m_q, S) index_scores
        return pooled_max(scores)

    def topk_from_pooled(self, pooled: np.ndarray,
                         k_blocks: int) -> List[Tuple[int, float]]:
        """Aggregate pooled token scores per NSA block (padded tail) and
        return the local top-k (block id, score) candidates under the
        strict total order — score desc, ties toward the lower id."""
        bs = SEL.block_scores(pooled, self.block_tokens)
        k = min(k_blocks, bs.shape[-1])
        order = np.lexsort((np.arange(bs.shape[-1]), -bs))[:k]
        return [(int(b), float(bs[b])) for b in order]

    def local_topk(self, iq: np.ndarray, keys: np.ndarray,
                   k_blocks: int) -> List[Tuple[int, float]]:
        """One holder's side of the service: score + pool + per-block
        top-k. Kept as the single-array entry (tests, examples); the
        service pipeline goes through pooled_scores/topk_from_pooled."""
        return self.topk_from_pooled(pooled_max(iq @ keys.T), k_blocks)

    # -- selection ----------------------------------------------------------

    def _merge(self, rq: Request, per_chunk: Dict[str, list],
               k_blocks: int) -> RequestSelection:
        """Requester-side merge: global top-k over every holder's
        candidates under the strict total order (score desc, chunk
        position, block id) — the same order a single instance ranking
        every block of the concatenated cache would use, so distributed ==
        global (tests assert it; ties cannot diverge, the order is total)."""
        cands = []
        for pos, cid in enumerate(rq.chunk_ids):
            for b, s in per_chunk[cid]:
                cands.append((-s, pos, b))
        cands.sort()
        chosen = cands[:k_blocks]
        self.obs_counts["merges"] += 1
        self.obs_counts["merge_candidates"] += len(cands)
        self.obs_counts["merge_selected"] += len(chosen)
        self._merge_sizes.append(len(cands))
        blocks: Dict[str, Tuple[int, ...]] = {cid: () for cid in rq.chunk_ids}
        for _, pos, b in chosen:
            cid = rq.chunk_ids[pos]
            blocks[cid] = blocks[cid] + (b,)
        blocks = {cid: tuple(sorted(bs)) for cid, bs in blocks.items()}
        # masks need chunk lengths; the callers attach them from the store
        return RequestSelection(rq.req_id, self.block_tokens, blocks, {})

    def _select(self, store: ChunkStore, rq: Request, step: int,
                truncate_local: bool) -> RequestSelection:
        """The one score -> local top-k -> merge -> mask pipeline.
        truncate_local=True is the distributed service (each holder
        returns at most k_blocks candidates); False ranks EVERY block —
        the single-instance reference. Both share this body so the
        distributed==global theorem compares selection POLICY, not two
        drifting implementations."""
        k_blocks = max(1, -(-int(rq.k_selected) // self.block_tokens))
        iq = self.index_query(rq, step)
        per_chunk = {}
        for cid in rq.chunk_ids:
            length = store.lookup(cid).length
            k = (k_blocks if truncate_local
                 else -(-length // self.block_tokens))
            self.obs_counts["roundtrips"] += 1
            pooled = self.pooled_scores(store, rq, iq, cid, step)
            per_chunk[cid] = self.topk_from_pooled(pooled, k)
        sel = self._merge(rq, per_chunk, k_blocks)
        masks = {cid: token_mask(sel.blocks[cid], self.block_tokens,
                                 store.lookup(cid).length)
                 for cid in rq.chunk_ids}
        return dataclasses.replace(sel, masks=masks)

    def select_request(self, store: ChunkStore, rq: Request,
                       step: int) -> RequestSelection:
        """score -> local top-k per holder -> global merge for one
        request. k_blocks = ceil(budget / block_tokens): NSA granularity
        rounds the token budget up to whole blocks."""
        return self._select(store, rq, step, truncate_local=True)

    def global_select(self, store: ChunkStore, rq: Request,
                      step: int) -> RequestSelection:
        """The single-instance reference selection: every block of every
        chunk ranked at once (no per-holder truncation). select_request
        must return exactly this — the distributed-top-k theorem the tests
        pin down."""
        return self._select(store, rq, step, truncate_local=False)

    # -- the engine's entry point -------------------------------------------

    def select_step(self, engine: "ServingEngine", requests: List[Request],
                    step: int) -> Dict[int, RequestSelection]:
        out = {rq.req_id: self.select_request(engine.store, rq, step)
               for rq in requests}
        self.log[step] = out
        return out
