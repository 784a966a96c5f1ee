"""TorchExecBackend: run dispatch plans on real torch tensors.

The planner decides ROUTE / FETCH / LOCAL per (holder, chunk, fabric)
group; this backend EXECUTES those decisions, by default on the card:

* chunks materialize as real c^KV arrays (S, d_qk) in the chunk store —
  deterministic per chunk_id (a torch.Generator seeded from _stable_seed),
  so a re-run (or the exactness oracle) sees the same cache bytes;
* ROUTE — the grouped requesters' query tensors are stacked into one
  holder-side batched partial (core.routing.route_batched: one mla_decode
  launch with the group's rows against the holder's chunk), sliced back per
  request, merged requester-side. The query moved, the cache did not.
* FETCH — the chunk replicates through the core.splice path (delta-0
  re-home through the delta_rotate kernel), the copy is stored as the
  replica's array, and the requesters attend it LOCALLY.
* LOCAL — re-prefill: the canonical entries are recomputed at the
  requester (same deterministic materialization) and attended locally.
* resident pairs (no transport planned) attend their local copy.

Under an active selection (the plan carries the indexer's verdicts in
StepPlan.selections), every primitive narrows to the chosen set: ROUTE,
LOCAL and resident accesses attend that chunk's selected blocks in place
through the sparse_select kernel (the block ids go straight to the kernel:
no mask tensor, no device sync), and FETCH becomes the scattered gather —
pull ONLY the selected rows at canonical positions into a new buffer,
attend it with mla_decode, persist nothing. The merged outputs then
reproduce single-instance selection_k decode to float round-off
(selection_oracle_partial).

Every request's per-chunk partials merge in one softmax_merge launch, so
the output per request equals single-instance attention over the
concatenated chunks to float round-off regardless of which primitive the
predicate picked (§3.3).

On CUDA tensors the four kernels (mla_decode, softmax_merge, delta_rotate,
sparse_select) do the array work; on CPU tensors the same call sites take
their plain versions.

State can be carried in from elsewhere (repro_torch.convert): chunk arrays
attached to the store before step 1 are used as they are, and
`query_source(rq, step) -> ndarray` replaces the generated queries.
"""

from __future__ import annotations

import zlib
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple, TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core.chunk_store import ChunkStore
from repro_torch.core.merge import Partial
from repro_torch.core.routing import route_batched
from repro_torch.core.splice import splice_delta_rotate
from repro_torch.kernels.softmax_merge import softmax_merge
from repro_torch.models.mla import (MLAConfig, absorbed_partial,
                                    absorbed_partial_ref, selected_partial)
from repro_torch.serving import timeline as TL
from repro_torch.serving.backends.base import StepExecution, StepTicket
from repro_torch.serving.plan import Request, StepPlan, build_timeline

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.serving.engine import ServingEngine


# Execution geometry for CPU-scale tests and the serve CLI: d_qk = 24.
# The PLANNER's costs always use the paper payload (cfg.payload on the
# engine) — primitive decisions are invariant to the execution geometry.
TINY_MLA = MLAConfig(d_model=64, n_heads=2, kv_lora_rank=16,
                     qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8)

QuerySource = Callable[[Request, int], np.ndarray]


def _stable_seed(*parts) -> int:
    """Deterministic 32-bit seed from stringable parts (NOT Python hash(),
    which is salted per process)."""
    return zlib.crc32(":".join(str(p) for p in parts).encode())


def _generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def fetch_source(rec) -> int:
    """The instance a fetch-kind dispatch pulls its bytes FROM: plain
    "fetch" records carry link_instance == holder, and "fetch_replica"
    spawns carry the canonical holder (their `holder` field is the TARGET
    instance)."""
    return rec.link_instance if rec.link_instance >= 0 else rec.holder


def chunk_array(cfg: MLAConfig, chunk_id: str, length: int,
                dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The canonical c^KV array of a chunk: (length, d_qk), drawn on
    `device` from a generator seeded by chunk_id — re-prefill (LOCAL)
    regenerates exactly these entries."""
    dev = torch.device(device)
    return torch.randn((length, cfg.d_qk), dtype=dtype, device=dev,
                       generator=_generator(_stable_seed("ckv", chunk_id),
                                            dev))


def query_for(cfg: MLAConfig, rq: Request, step: int, dtype=torch.float32,
              device="cuda") -> torch.Tensor:
    """The request's absorbed decode queries this step: (m_q, H, d_qk),
    deterministic in (query_seed, step)."""
    seed = rq.req_id if rq.query_seed is None else rq.query_seed
    dev = torch.device(device)
    return torch.randn((rq.m_q, cfg.n_heads, cfg.d_qk), dtype=dtype,
                       device=dev,
                       generator=_generator(_stable_seed("q", seed, step),
                                            dev))


def oracle_partial(cfg: MLAConfig, store: ChunkStore, rq: Request, step: int,
                   dtype=torch.float32, device="cuda",
                   q: Optional[torch.Tensor] = None) -> Partial:
    """The §3.3 exactness reference: single-instance attention over the
    request's CONCATENATED chunks (canonical arrays), computed with the
    plain version. q is the query tensor the backend used (default: the
    generated one)."""
    if q is None:
        q = query_for(cfg, rq, step, dtype, device)
    cat = torch.cat([store.lookup(c).data for c in rq.chunk_ids], dim=0)
    return absorbed_partial_ref(cfg, q, cat)


def selection_oracle_partial(cfg: MLAConfig, store: ChunkStore, rq: Request,
                             sel, step: int, dtype=torch.float32,
                             device="cuda",
                             q: Optional[torch.Tensor] = None) -> Partial:
    """The selection-regime exactness reference: single-instance
    selection_k decode. One instance holds the request's CONCATENATED
    chunks, applies the GLOBAL selection mask (sel: a RequestSelection) and
    attends the chosen entries in place (canonical positions — no
    re-rotation, §3.3), with the plain version. The scheduler-driven
    scatter-attend must reproduce this to float round-off however the
    selection was split across holders and whichever primitives served
    the shards."""
    if q is None:
        q = query_for(cfg, rq, step, dtype, device)
    cat = torch.cat([store.lookup(c).data for c in rq.chunk_ids], dim=0)
    gmask = np.concatenate([np.asarray(sel.masks[c]) for c in rq.chunk_ids])
    return absorbed_partial_ref(cfg, q, cat,
                                torch.as_tensor(gmask, device=cat.device))


def max_oracle_err(engine: "ServingEngine", reqs: List[Request],
                   step: int) -> float:
    """Worst |exec output - oracle| over a step's requests. The engine must
    be running a TorchExecBackend (its cfg/dtype/device/query source define
    the oracle). Requests under an active selection verify against the
    selection oracle; everything else against dense single-instance
    attention."""
    backend = engine.backend
    outs = engine.outputs_of(step)
    sels = (engine.plans[step - 1].selections
            if 1 <= step <= len(engine.plans) else {})
    worst = 0.0
    for rq in reqs:
        sel = sels.get(rq.req_id)
        q = backend.fresh_query(rq, step)
        if sel is not None:
            want = selection_oracle_partial(backend.cfg, engine.store, rq,
                                            sel, step, q=q)
        else:
            want = oracle_partial(backend.cfg, engine.store, rq, step, q=q)
        worst = max(worst, float(torch.max(torch.abs(
            outs[rq.req_id].o - want.o))))
    return worst


def analytic_timeline(plan: StepPlan) -> TL.Timeline:
    """The plan's stage costs scheduled exactly as AnalyticBackend schedules
    them — the columnar scheduler when the plan carries its arrays, else
    the object path — so StepStats are bit-identical to an analytic run.
    (The two schedulers sum serial_stage_s in different orders and can
    differ in the last bit.)"""
    if plan.arrays is not None:
        return TL.simulate_arrays(plan.arrays.flow_arrays())
    return build_timeline(plan.records)


class TorchExecBackend:
    """Execute StepPlans on real tensors. cfg sets the EXECUTION geometry
    (array shapes); it is independent of the planner's cost payload."""

    name = "exec"

    def __init__(self, cfg: MLAConfig = TINY_MLA, dtype=torch.float32,
                 device="cuda", query_source: Optional[QuerySource] = None):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchExecBackend: device 'cuda' requested but no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "versions on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"TorchExecBackend: unsupported device {dev}")
        self.cfg = cfg
        self.dtype = dtype
        self.device = dev
        self.query_source = query_source
        # query memo: the tensor is materialized ONCE per (seed, step, m_q);
        # entries older than the previous step are pruned on a new step
        self._qmemo: Dict[Tuple[int, int, int], torch.Tensor] = {}
        self._qmemo_step = -1
        # query-memo effectiveness, read by the obs registry
        self.qmemo_hits = 0
        self.qmemo_misses = 0

    def fresh_query(self, rq: Request, step: int) -> torch.Tensor:
        """The request's queries this step, from the query source when one
        was given, else generated — never memoized."""
        if self.query_source is not None:
            return torch.tensor(np.array(self.query_source(rq, step)),
                                dtype=self.dtype, device=self.device)
        return query_for(self.cfg, rq, step, self.dtype, self.device)

    def query_of(self, rq: Request, step: int) -> torch.Tensor:
        """Memoized fresh_query: the request's decode queries this step."""
        if step != self._qmemo_step:
            if step > self._qmemo_step:
                self._qmemo = {k: v for k, v in self._qmemo.items()
                               if k[1] >= step - 1}
            else:                        # a fresh engine restarted the clock
                self._qmemo.clear()
            self._qmemo_step = step
        seed = rq.req_id if rq.query_seed is None else rq.query_seed
        key = (seed, step, rq.m_q)
        q = self._qmemo.get(key)
        if q is None:
            self.qmemo_misses += 1
            q = self._qmemo[key] = self.fresh_query(rq, step)
        else:
            self.qmemo_hits += 1
        return q

    # -- materialization ----------------------------------------------------

    def ensure_chunk_data(self, store: ChunkStore,
                          chunk_id: str) -> torch.Tensor:
        """Canonical array of chunk_id, materializing it on first touch."""
        chunk = store.lookup(chunk_id)
        if chunk.data is None:
            store.attach_data(
                chunk_id, chunk_array(self.cfg, chunk_id, chunk.length,
                                      self.dtype, self.device))
        return chunk.data

    def _array_on(self, store: ChunkStore, chunk_id: str,
                  instance: int) -> torch.Tensor:
        """The copy instance would attend: its replica array if the exec
        path produced one, else the canonical array."""
        arr = store.array_on(chunk_id, instance)
        return arr if arr is not None else self.ensure_chunk_data(store,
                                                                  chunk_id)

    # -- execution ----------------------------------------------------------

    def execute(self, engine: "ServingEngine",
                plan: StepPlan) -> StepExecution:
        store = engine.store
        reqs: Dict[int, Request] = {rq.req_id: rq for rq in plan.requests}
        sels = plan.selections

        def q_of(rid: int) -> torch.Tensor:
            return self.query_of(reqs[rid], plan.step)

        def attend(rid: int, chunk_id: str, arr: torch.Tensor) -> Partial:
            """The request's partial over one copy of a chunk: dense, or
            through the indexer's selected blocks when it chose for this
            request (plan.selections is the §5.4 handoff)."""
            sel = sels.get(rid)
            if sel is None:
                return absorbed_partial(self.cfg, q_of(rid), arr)
            return selected_partial(self.cfg, q_of(rid), arr,
                                    sel.blocks[chunk_id], sel.block_tokens)

        parts: Dict[int, List[Partial]] = defaultdict(list)

        # resident accesses: local attention on the instance's copy
        for rp in plan.resident_pairs:
            arr = self._array_on(store, rp.chunk_id, rp.instance)
            parts[rp.req_id].append(attend(rp.req_id, rp.chunk_id, arr))

        for rec in plan.records:
            if rec.backup or not rec.req_ids:
                continue
            if rec.primitive == "route":
                self._exec_route(store, rec, q_of, parts, sels)
            elif rec.primitive in ("fetch", "fetch_replica"):
                if rec.req_ids[0] in sels:
                    self._exec_fetch_selected(store, rec, q_of, parts,
                                              sels[rec.req_ids[0]])
                else:
                    self._exec_fetch(store, rec, q_of, parts)
            else:                                     # local re-prefill
                arr = self.ensure_chunk_data(store, rec.chunk_id)
                for rid in rec.req_ids:
                    parts[rid].append(attend(rid, rec.chunk_id, arr))

        outputs = {rid: self._merge(ps) for rid, ps in parts.items()}
        return StepExecution(timeline=analytic_timeline(plan),
                             outputs=outputs, backend=self.name)

    @staticmethod
    def _merge(ps: List[Partial]) -> Partial:
        """One request's partials, all (m_q, H, d_v): one softmax_merge."""
        return softmax_merge(torch.stack([p.o for p in ps]),
                             torch.stack([p.m for p in ps]),
                             torch.stack([p.l for p in ps]))

    # single-process execution blocks as it goes: submit runs the step
    # eagerly (a CUDA stream/event split is later work)

    def submit(self, engine: "ServingEngine", plan: StepPlan) -> StepTicket:
        return StepTicket(plan=plan, execution=self.execute(engine, plan))

    def await_result(self, engine: "ServingEngine",
                     ticket: StepTicket) -> StepExecution:
        return ticket.execution

    def _exec_route(self, store: ChunkStore, rec, q_of, parts,
                    sels) -> None:
        """One batched dispatch: stack the group's queries, one holder-side
        partial over the holder's resident copy, slice back per request.
        A selection-regime dispatch (single-request by construction: the
        planner groups selection pairs per request) attends the request's
        selected blocks of the holder's copy in place (§5.4)."""
        holder_arr = self._array_on(store, rec.chunk_id, rec.holder)
        qs = [q_of(rid) for rid in rec.req_ids]
        sel = sels.get(rec.req_ids[0])
        if sel is not None:
            merged = route_batched(self.cfg, [qs[0]], [[holder_arr]],
                                   blocks=[[sel.blocks[rec.chunk_id]]],
                                   block_tokens=sel.block_tokens)[0]
        else:
            stacked = torch.cat(qs, dim=0) if len(qs) > 1 else qs[0]
            merged = route_batched(self.cfg, [stacked], [[holder_arr]])[0]
        off = 0
        for rid, q in zip(rec.req_ids, qs):
            n = q.shape[0]
            parts[rid].append(Partial(o=merged.o[off:off + n],
                                      m=merged.m[off:off + n],
                                      l=merged.l[off:off + n]))
            off += n

    def _exec_fetch(self, store: ChunkStore, rec, q_of, parts) -> None:
        """Move the cache: pull the source copy, delta-0 splice, persist
        the replica array where the planner made it resident, then serve
        the group with LOCAL attention on the moved copy."""
        src_arr = self._array_on(store, rec.chunk_id, fetch_source(rec))
        moved = splice_delta_rotate(src_arr, 0, self.cfg)
        dest = rec.home
        if dest >= 0 and store.resident_on(rec.chunk_id, dest):
            store.set_replica_data(rec.chunk_id, dest, moved)
            # the index sidecar moves with the cache bytes (keys derive
            # from the latent band only, which the splice leaves alone)
            keys = store.lookup(rec.chunk_id).index_keys
            if keys is not None:
                store.set_replica_index_keys(rec.chunk_id, dest, keys)
        for rid in rec.req_ids:
            parts[rid].append(absorbed_partial(self.cfg, q_of(rid), moved))

    def _exec_fetch_selected(self, store: ChunkStore, rec, q_of, parts,
                             sel) -> None:
        """FETCH under selection: the scattered gather (§5.4) — pull ONLY
        the selected rows of the source copy, at their canonical positions
        (no splice: re-rotating a selection diverges, see core/splice),
        into a new contiguous buffer (the moved bytes), attend it at the
        requester with mla_decode, persist nothing (the selection is
        re-chosen every step)."""
        # fetch_replica under selection is unreachable by construction:
        # replica spawns batch only DENSE fan-in overflow (selection pairs
        # group per request and never join a dense group), so a selected
        # request never rides a fetch_replica record, and the source below
        # (fetch_source == rec.holder for plain fetch records) holds.
        if rec.primitive != "fetch":
            raise RuntimeError(
                f"selection fetch arrived as {rec.primitive!r}: replica "
                "spawns must never batch selected requests")
        rid = rec.req_ids[0]
        q = q_of(rid)
        idx = np.nonzero(np.asarray(sel.masks[rec.chunk_id]))[0]
        if idx.size == 0:
            # the indexer chose nothing on this holder: the gather is
            # empty and the request's partial is the merge identity
            parts[rid].append(Partial.identity(
                q.shape[:-1], self.cfg.kv_lora_rank, device=q.device))
            return
        src_arr = self._array_on(store, rec.chunk_id, fetch_source(rec))
        gathered = src_arr.index_select(
            0, torch.as_tensor(idx, device=src_arr.device))
        parts[rid].append(absorbed_partial(self.cfg, q, gathered))
