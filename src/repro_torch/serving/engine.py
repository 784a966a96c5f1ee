"""Predicate-driven serving engine: the layer that CONSUMES the paper's
cost model (§5: "the serving system that consumes the rule").

A decode step runs through three layers:

  PLAN    (plan_step, this module) — residency resolution (chunk_store),
          ONE vectorized decide_batch() over every non-resident
          (request, chunk) pair (core.predicate: the closed-form §5
          predicate as numpy arrays, fabric picked per pair from the
          instance topology — probe latency, not peak bandwidth, §5.5),
          §8 link-subscription pricing with k_flows DERIVED from observed
          occupancy, per-(holder, chunk, fabric) dispatch batching (§5.3),
          fan-in capping at the N~8 elbow with replica spawns (§6.3),
          fetch persistence (the amortisation the predicate priced
          actually accrues) and LRU replica retirement under pool
          pressure. Output: a StepPlan (repro.serving.plan).
  EXECUTE (a pluggable ExecutionBackend, repro.serving.backends) — the
          AnalyticBackend schedules the plan on the overlap-aware
          transport timeline (repro.serving.timeline: wire stages
          serialize per (link, fabric), holder compute charged
          per-instance, StepStats.latency_s is the MAKESPAN); the
          JaxExecBackend additionally RUNS the planned attention on real
          c^KV arrays and returns actual decode outputs (§3.3 exactness,
          end-to-end through the scheduler).
  ACCOUNT (_account) — StepStats from the plan + the executed timeline.

Straggler backups past the p99 deadline and LOCAL re-homing of orphaned
chunks on holder failure are planned like any other dispatch.

run() drives the loop over a trace (see repro.serving.workload) and emits
per-step StepStats — the substrate benchmarks/bench_serving_steadystate.py
reports p50/p99 step latency and scheduler decisions/sec from.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import warnings
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core import constants as C
from repro_torch.core import cost_model as cm
from repro_torch.core import predicate as P
from repro_torch.core.chunk_store import ChunkStore
from repro_torch.core.constants import Fabric
from repro_torch.serving import timeline as TL
from repro_torch.serving.backends.base import (ExecutionBackend, StepExecution,
                                         StepTicket, await_step, submit_step)
# Plan-layer types live in repro.serving.plan; re-exported here so the
# historical `from repro.serving.engine import ...` imports keep working.
from repro_torch.serving.plan import (DispatchRecord, Request, ResidentPair,
                                StepPlan, StepPlanArrays, StepStats,
                                _critical_path, build_timeline,
                                transport_latencies)

# static stage-code rows for the template-priced dispatch kinds
_ROUTE_CODES = np.array([TL.STAGE_CODE[n]
                         for n in cm.StageTemplates.route_names], np.int64)
_FETCH_CODES = np.array([TL.STAGE_CODE[n]
                         for n in cm.StageTemplates.fetch_names], np.int64)
_LOCAL_CODES = np.array([TL.STAGE_CODE[n]
                         for n in cm.StageTemplates.local_names], np.int64)
_SELR_CODES = np.array([TL.STAGE_CODE[n]
                        for n in cm.StageTemplates.route_selected_names],
                       np.int64)
_SELF_CODES = np.array([TL.STAGE_CODE[n]
                        for n in cm.StageTemplates.fetch_selected_names],
                       np.int64)

__all__ = [
    "DispatchRecord", "EngineConfig", "Instance", "Request", "ResidentPair",
    "ServingEngine", "StepPlan", "StepStats", "build_timeline",
    "transport_latencies",
]


@dataclasses.dataclass
class Instance:
    idx: int
    pod: int = 0
    # simulated holder-side service-time scale (stragglers: > 1)
    slowdown: float = 1.0
    alive: bool = True


@dataclasses.dataclass
class EngineConfig:
    fanin_cap: int = C.HOLDER_COMPUTE_ELBOW_N      # §6.3 elbow
    staging_streams: int = C.STAGING_STREAMS_ELBOW_K  # §6.2 policy constant
    straggler_p99_factor: float = 3.0              # backup fire threshold
    intra_pod_fabric: str = "tpu_ici"
    cross_pod_fabric: str = "tpu_dcn"
    payload: cm.Payload = cm.MLA_PAYLOAD
    congestion_aware: bool = True                  # §8 link-subscription pricing
    persist_fetches: bool = True                   # fetched chunks stay resident
    # plan through the columnar array path (StepPlanArrays +
    # timeline.simulate_arrays). False forces the object oracle — the two
    # are bit-identical (tests/test_plan_arrays.py), so this is a kill
    # switch and an A/B handle, not a behavior choice.
    vectorized_plan: bool = True
    # exec mode: steps of decode-output history to retain (outputs hold
    # real arrays; keeping every step would grow memory linearly over a
    # run). < 0 keeps everything.
    retain_outputs: int = 8
    # max steps in flight between submit and account. 1 = the
    # historical lockstep plan->execute->account loop (the bit-identical
    # A/B oracle and the kill switch); >= 2 lets the engine plan step N+1
    # while step N's device work runs, hiding the planner wall under the
    # backend's deferred barrier.
    pipeline_depth: int = 1


# one resolved (request, chunk) access, pre-decision
@dataclasses.dataclass
class _Pair:
    rq: Request
    chunk_id: str
    holder: int
    fabric_idx: int
    c_t: int
    n_holders: int


# one submitted-but-not-accounted step in the engine's pipeline
@dataclasses.dataclass
class _InFlight:
    plan: StepPlan
    ticket: StepTicket
    t_plan0: float
    t_plan1: float
    t_submit1: float
    plan_wall_s: float
    # planner wall that ran between this step's submit and its await —
    # the wall the pipeline is trying to hide under the device barrier
    overlap_candidate_s: float = 0.0


# a plan produced ahead of its schedule_step call. Residency
# changes are plan-determined (plan_step commits promotions/evictions
# before execute runs), so a speculative plan advanced from the previous
# plan's own deltas is exact unless the world mutates in between — the
# epoch captures exactly the inputs a mutation would change.
@dataclasses.dataclass
class _Speculative:
    requests: List[Request]
    plan: StepPlan
    epoch: tuple
    plan_wall_s: float
    t_plan0: float
    t_plan1: float


# an await that returns faster than this never actually blocked on the
# device — treat the step as having hidden nothing (eager backends)
_AWAIT_BLOCK_EPS_S = 5e-5


class ServingEngine:
    def __init__(self, n_instances: int, pool_tokens: int,
                 cfg: EngineConfig = EngineConfig(),
                 instances_per_pod: int = 0,
                 backend: Optional[ExecutionBackend] = None,
                 selector=None, obs=None):
        self.cfg = cfg
        self.store = ChunkStore(n_instances, pool_tokens)
        ipp = instances_per_pod or n_instances
        self.instances = [Instance(i, pod=i // ipp)
                          for i in range(n_instances)]
        if backend is None:
            from repro_torch.serving.backends.analytic import AnalyticBackend
            backend = AnalyticBackend()
        self.backend: ExecutionBackend = backend
        # §5.4 selection regime: the indexer that turns a
        # request's k_selected budget into per-(request, holder) masks —
        # repro.serving.selection.IndexerService (live scoring) or
        # ReplaySelector (recorded trace). None: selection requests are
        # PRICED but executed dense, warn-once + counted in StepStats.
        self.selector = selector
        self._warned_selection_fallback = False
        self.log: List[DispatchRecord] = []
        self.stats: List[StepStats] = []
        self.plans: List[StepPlan] = []          # parallel to self.stats
        self.timelines: List[TL.Timeline] = []   # parallel to self.stats
        # exec-mode decode outputs per step: req_id -> merged Partial
        # (empty dicts under the analytic backend)
        self.step_outputs: List[Dict[int, object]] = []
        # measured-vs-analytic reports per step: a
        # timeline.MeasuredReport when the backend timed real collectives
        # (the shard_map backend), else None — parallel to self.stats
        self.measured_reports: List[Optional[TL.MeasuredReport]] = []
        self.step_idx = 0
        # fabric table shared by every decide_batch call: idx 0 = intra-pod,
        # idx 1 = cross-pod
        self._fa = cm.FabricArrays.from_fabrics(
            [C.fabric(cfg.intra_pod_fabric), C.fabric(cfg.cross_pod_fabric)])
        # broadcast-assembled §4 stage templates + the store's columnar
        # residency snapshot, cached on ChunkStore.version
        self._templates = cm.StageTemplates(self._fa, cfg.payload)
        self._mirror: Optional[dict] = None
        self._ntab: Optional[dict] = None
        # phase-1 cross-step cache: resolved pairs + grouping,
        # keyed on the residency epoch and the request-set signature
        self._p1: Optional[dict] = None
        # §5 decision memo: pricing-column combo -> costs + per-reuse codes,
        # and the §8 congested-route cost per (m_q, fabric, k_flows) point.
        # Both are pure functions of the cost model, never invalidated.
        self._dec_memo: Dict[tuple, list] = {}
        self._cong_memo: Dict[tuple, float] = {}
        # planner-cache effectiveness counters: plain ints bumped
        # on the hot path (one integer add each — cheap enough to keep
        # unconditionally), published through planner_cache_stats() and the
        # obs metrics registry. sig = per-request signature cache, step =
        # full-step column replay, p3 = phase-3/4 assembly replay, dec =
        # §5 decision memo, obj_fallback = array planner bailed to objects.
        self._n_sig_hit = 0
        self._n_sig_miss = 0
        self._n_step_replay_hit = 0
        self._n_step_replay_miss = 0
        self._n_p3_hit = 0
        self._n_dec_hit = 0
        self._n_dec_miss = 0
        self._n_obj_fallback = 0
        # pipeline state: FIFO of submitted-not-yet-accounted
        # steps (at most pipeline_depth - 1 after schedule_step returns),
        # plus at most one speculative plan for the step after that.
        self._inflight: List[_InFlight] = []
        self._spec: Optional[_Speculative] = None
        self.misspeculation_replans = 0
        # planner seconds that demonstrably ran under a blocked device
        # barrier (the pipelining win, published through obs)
        self.planner_overlap_s = 0.0
        # per accounted step, the wall plan_step took (speculative or not)
        self.plan_walls: List[float] = []
        # the flight recorder: NULL_OBS is an inert singleton —
        # the step path pays one identity comparison when observability is
        # off. A live Obs gets every accounted step via obs.on_step.
        from repro_torch.obs import NULL_OBS
        self.obs = NULL_OBS if obs is None else obs
        if self.obs.enabled:
            self.obs.bind_engine(self)

    # -- topology -------------------------------------------------------------

    def fabric_idx_between(self, a: int, b: int) -> int:
        """0 (intra-pod) or 1 (cross-pod); the probe, not peak BW, is what
        matters at decode (§5.5)."""
        return 0 if self.instances[a].pod == self.instances[b].pod else 1

    def fabric_between(self, a: int, b: int) -> Fabric:
        name = (self.cfg.intra_pod_fabric
                if self.fabric_idx_between(a, b) == 0
                else self.cfg.cross_pod_fabric)
        return C.fabric(name)

    # -- admission ------------------------------------------------------------

    def register_chunk(self, chunk_id: str, holder: int, length: int,
                       position_base: int = 0, data=None):
        return self.store.register(chunk_id, holder, length, position_base,
                                   data=data)

    # -- pool pressure ---------------------------------------------------------

    def _make_resident(self, chunk_id: str, instance: int) -> bool:
        """Replicate chunk onto instance, retiring cold replicas LRU under
        pool pressure. Returns False when it cannot fit (replication is an
        optimisation — never evict hotter data to force it)."""
        chunk = self.store.lookup(chunk_id)
        if self.store.resident_on(chunk_id, instance):
            return True
        need = chunk.length
        if self.store.capacity_left(instance) < need:
            victims = sorted(
                self.store.replicas_on(instance),
                key=lambda cid: self.store.lookup(cid).last_access)
            for vic in victims:
                if self.store.lookup(vic).last_access >= chunk.last_access:
                    break          # nothing colder than the newcomer
                self.store.evict_replica(vic, instance)
                self._evictions_this_step += 1
                if self.store.capacity_left(instance) >= need:
                    break
        if self.store.capacity_left(instance) < need:
            return False
        self.store.add_replica(chunk_id, instance)
        return True

    # -- PLAN: one decode step -------------------------------------------------

    def plan_step(self, requests: List[Request]) -> StepPlan:
        """Plan all transports for one global decode step: batched
        predicate, per-(holder, chunk, fabric) dispatch batching, link
        congestion pricing, fan-in capping, replica persistence. Planning
        COMMITS residency state (persisted fetches, replica spawns, LRU
        evictions); execution replays the plan without re-deciding.

        The hot path is `_plan_step_arrays` (columnar
        residency resolution + template-priced dispatch assembly); the
        original object planner survives verbatim as `_plan_step_objects`,
        the oracle the array path is pinned bit-identical to, and the
        fallback for the rare step shapes the array path does not carry
        (orphaned chunks on a dead holder)."""
        self.step_idx += 1
        self._evictions_this_step = 0
        selections, selection_fallbacks = self._plan_selections(requests)
        if self.cfg.vectorized_plan:
            plan = self._plan_step_arrays(requests, selections,
                                          selection_fallbacks)
            if plan is not None:
                return plan
            self._n_obj_fallback += 1
        return self._plan_step_objects(requests, selections,
                                       selection_fallbacks)

    def _plan_selections(self, requests: List[Request]):
        """Phase 0: the indexer's selections (§5.4). Score ->
        select happens BEFORE residency resolution: the masks are a
        per-request property (the global top-k over the request's chunks),
        independent of which holder ends up serving each shard."""
        selections: Dict[int, object] = {}
        selection_fallbacks = 0
        sel_reqs = [rq for rq in requests if rq.k_selected is not None]
        if sel_reqs:
            if self.selector is not None:
                selections = self.selector.select_step(self, sel_reqs,
                                                       self.step_idx)
            else:
                selection_fallbacks = len(sel_reqs)
                self._warn_selection_fallback()
        return selections, selection_fallbacks

    def _plan_step_objects(self, requests: List[Request],
                           selections: Dict[int, object],
                           selection_fallbacks: int) -> StepPlan:
        """The original per-request object planner — the exactness oracle
        for `_plan_step_arrays` and the fallback for orphaned-chunk steps."""
        replicas_spawned = 0
        records: List[DispatchRecord] = []
        resident_pairs: List[ResidentPair] = []
        pairs: List[_Pair] = []
        n_resident = 0
        n_pairs = 0
        # distinct instances a request's selection spans — the M of the
        # §5.4 fan-out/gather the predicate prices (resident shards count
        # their home)
        span: Dict[int, set] = {rid: set() for rid in selections}

        # -- phase 1: residency resolution ---------------------------------
        for rq in requests:
            selected = rq.req_id in selections
            for cid in rq.chunk_ids:
                n_pairs += 1
                chunk = self.store.lookup(cid)
                self.store.touch(cid, self.step_idx)
                holders = [h for h in self.store.holders_of(cid)
                           if self.instances[h].alive]
                if not holders:
                    # orphaned: LOCAL re-prefill, then re-home the chunk to
                    # the requester so subsequent steps serve it normally
                    sd = self.instances[rq.home].slowdown
                    records.append(DispatchRecord(
                        self.step_idx, rq.home, "local", cid, 1, rq.m_q,
                        cm.t_local(chunk.length,
                                   self.cfg.payload.n_layers) * sd,
                        home=rq.home,
                        stages=cm.scale_stages(
                            cm.local_stages(chunk.length,
                                            self.cfg.payload.n_layers), sd),
                        req_ids=(rq.req_id,)))
                    self.store.rehome(cid, rq.home)
                    if selected:
                        span[rq.req_id].add(rq.home)
                    continue
                # nearest live holder by fabric probe (home wins if resident)
                holder = min(holders, key=lambda h: 0.0 if h == rq.home
                             else self.fabric_between(rq.home, h).t_probe_s)
                if selected:
                    span[rq.req_id].add(holder)
                if holder == rq.home:
                    n_resident += 1    # resident: free local attention
                    resident_pairs.append(
                        ResidentPair(rq.req_id, cid, rq.home))
                    continue
                fi = self.fabric_idx_between(rq.home, holder)
                pairs.append(_Pair(rq, cid, holder, fi,
                                   chunk.length, len(holders)))

        # -- phase 2: one vectorized predicate over all pairs ---------------
        if pairs:
            # under an ACTIVE selection, the predicate's n_holders is the M
            # the request's selection SPANS (the §5.4 fan-out/gather width),
            # not the chunk's replica count; without a selector the historic
            # per-chunk count is kept so priced-only runs stay bit-stable
            def _n_holders(p: _Pair) -> int:
                if p.rq.req_id in selections:
                    return max(1, len(span[p.rq.req_id]))
                return p.n_holders
            batch = P.RequestBatch(
                fabrics=self._fa,
                m_q=np.array([p.rq.m_q for p in pairs], np.int64),
                c_t=np.array([p.c_t for p in pairs], np.int64),
                fabric_idx=np.array([p.fabric_idx for p in pairs], np.int64),
                expected_reuse_steps=np.array(
                    [p.rq.expected_reuse_steps for p in pairs], np.int64),
                k_selected=np.array(
                    [-1 if p.rq.k_selected is None else p.rq.k_selected
                     for p in pairs], np.int64),
                n_holders=np.array([_n_holders(p) for p in pairs], np.int64),
                position_delta=np.ones(len(pairs), np.int64),
                holder_can_compute=np.ones(len(pairs), bool),
                host_overhead=np.zeros(len(pairs), bool),
                payload=self.cfg.payload)
            # link subscription (§8): one batched dispatch per
            # (holder, chunk, fabric) group = one flow on the
            # (holder, fabric) link. The k_flows premium is DERIVED from
            # observed occupancy, not assumed from raw group counts: an
            # uncontended pass decides provisional primitives, only groups
            # that elect a transport (ROUTE/FETCH) occupy their link, and
            # the observed per-link flow count re-prices the batch. (One
            # relaxation round: a group the congested pass flips to LOCAL
            # still counts toward the occupancy its neighbours saw.)
            # selection pairs group PER REQUEST (4th key component): each
            # request's masks differ, and its indexer round trip + masked
            # partial is its own flow on the holder's link — dense pairs
            # keep the historic 3-way batching (srid = -1)
            group_keys = [(p.holder, p.chunk_id, p.fabric_idx,
                           p.rq.req_id if p.rq.req_id in selections else -1)
                          for p in pairs]
            if self.cfg.congestion_aware:
                dec0 = P.decide_batch(batch, None)
                k_flows = self._occupancy_k_flows(pairs, group_keys, dec0)
                # the §8 premium is flat through K<=2: re-pricing is the
                # identity unless some link is actually subscribed past
                # the knee — skip the second pass in the common case
                dec = (P.decide_batch(batch, k_flows)
                       if int(k_flows.max()) >= 3 else dec0)
            else:
                k_flows, dec = None, P.decide_batch(batch, None)
        else:
            group_keys, k_flows, dec = [], None, None

        # -- phase 3: dispatch batching + fan-in + persistence --------------
        groups: Dict[Tuple[int, str, int, int], List[int]] = defaultdict(list)
        for i, key in enumerate(group_keys):
            groups[key].append(i)
        # fan-in cap is a property of the HOLDER's compute elbow: per
        # (holder, chunk) at most fanin_cap requesters route, ACROSS fabric
        # sub-groups — a shared budget drained as dispatches are planned
        route_budget: Dict[Tuple[int, str], int] = defaultdict(
            lambda: self.cfg.fanin_cap)

        for (holder, cid, fi, srid), idxs in sorted(groups.items(),
                                                    key=lambda kv: kv[0][:2]):
            entries = [pairs[i] for i in idxs]
            votes = defaultdict(int)
            for i in idxs:
                votes[int(dec.code[i])] += 1
            code = max(votes, key=votes.get)
            primitive = P.PRIMITIVE_BY_CODE[code].value
            sel = selections.get(srid) if srid >= 0 else None
            # selection routes sit outside the §6.3 fan-in budget: the
            # elbow is a FULL-chunk batched-partial property, and selected
            # compute is scaled to the budget KB far below it
            if primitive == "route" and sel is None:
                keep = min(len(idxs), max(0, route_budget[(holder, cid)]))
                if keep < len(idxs):
                    # beyond the elbow: spawn a replica (amortised FETCH)
                    # for the overflow and rebalance (§6.3 boundary)
                    overflow, idxs = idxs[keep:], idxs[:keep]
                    rep = self._spawn_replica(
                        cid, [pairs[i] for i in overflow])
                    if rep is not None:
                        records.append(rep)
                        replicas_spawned += 1
                    else:          # no room anywhere: keep them on the batch
                        idxs = idxs + overflow
                    entries = [pairs[i] for i in idxs]
                    if not entries:
                        continue
                # clamp at 0: a failed replica spawn can overdraw the
                # budget, but a negative balance must not leak into the
                # NEXT sub-group's slice arithmetic
                route_budget[(holder, cid)] = max(
                    0, route_budget[(holder, cid)] - len(entries))
            n_req = len(entries)
            m_q_total = sum(p.rq.m_q for p in entries)
            fab = C.fabric(self._fa.names[fi])
            chunk = self.store.lookup(cid)
            if primitive == "local":
                # re-prefill runs at each REQUESTER, not the holder: one
                # dispatch per requesting home, at that home's speed, and
                # no transport => no straggler backup
                by_home: Dict[int, List[_Pair]] = defaultdict(list)
                for p in entries:
                    by_home[p.rq.home].append(p)
                for home, ps in sorted(by_home.items()):
                    sd = self.instances[home].slowdown
                    records.append(DispatchRecord(
                        self.step_idx, home, "local", cid, len(ps),
                        sum(p.rq.m_q for p in ps),
                        cm.t_local(chunk.length,
                                   self.cfg.payload.n_layers) * sd,
                        home=home,
                        stages=cm.scale_stages(
                            cm.local_stages(chunk.length,
                                            self.cfg.payload.n_layers), sd),
                        req_ids=tuple(p.rq.req_id for p in ps)))
                continue
            # timeline stage durations are UNCONTENDED (k=0): on the
            # timeline, §8 queueing is simulated — flows serialize on the
            # shared (link, fabric) resource — while est_cost_s keeps the
            # congested closed form the predicate priced the pairs with
            dest = self._busiest_home(entries)
            if sel is not None:
                # §5.4 selection dispatch: the indexer round trip leads the
                # stage chain, holder compute/gather scale with the budget
                # resident HERE (selected & resident — possibly 0: the
                # query still fans out, the partial merges as identity),
                # FETCH gathers scattered entries and never persists (the
                # selection is re-chosen next step), and no straggler
                # backup shadows it.
                rq0 = entries[0].rq
                bt = self.selector.block_tokens
                # candidates on the wire: the budget in blocks, capped by
                # what this holder could possibly return
                kb_wire = min(max(1, -(-int(rq0.k_selected) // bt)),
                              max(1, -(-chunk.length // bt)))
                k_local = sel.k_on(cid)
                d_index = self.selector.d_index
                if primitive == "route":
                    kf = (int(k_flows[idxs[0]])
                          if self.cfg.congestion_aware else 0)
                    frac = min(1.0, k_local / max(1, chunk.length))
                    cost = cm.t_route_selected_full(
                        fab, m_q_total, kf, frac, kb_wire, d_index,
                        self.cfg.payload)
                    stages = cm.route_selected_stages(
                        fab, m_q_total, 0, frac, kb_wire, d_index,
                        self.cfg.payload)
                else:          # fetch: scattered gather of the local picks
                    cost = cm.t_fetch_selected(
                        fab, k_local, m_q_total, kb_wire, d_index,
                        self.cfg.payload)
                    stages = cm.fetch_selected_stages(
                        fab, k_local, m_q_total, kb_wire, d_index,
                        self.cfg.payload)
                sd = self.instances[holder].slowdown
                records.append(DispatchRecord(
                    self.step_idx, holder, primitive, cid, n_req, m_q_total,
                    cost * sd, fabric_idx=fi, link_instance=holder,
                    home=dest, stages=cm.scale_stages(stages, sd),
                    req_ids=tuple(p.rq.req_id for p in entries)))
                continue
            if primitive == "route":
                kf = (int(k_flows[idxs[0]])
                      if self.cfg.congestion_aware else 0)
                # same formula the predicate priced the pairs with
                cost = cm.t_route_congested_full(fab, m_q_total, kf,
                                                 self.cfg.payload)
                stages = cm.route_stages(fab, m_q_total, 0, self.cfg.payload)
            else:                  # fetch
                raw = cm.t_fetch(fab, chunk.length, self.cfg.payload)
                persisted = False
                if self.cfg.persist_fetches:
                    persisted = self._make_resident(cid, dest)
                if persisted:
                    # amortised exactly as the predicate priced it (§5.5
                    # rule 2): the pull+splice is paid once and the copy
                    # stays resident for the reuse horizon
                    reuse = max(p.rq.expected_reuse_steps for p in entries)
                    cost = raw / max(1, reuse)
                else:
                    # the copy could not persist (pool pressure or
                    # persistence off): the pull+splice really is paid
                    # every time, so no amortisation discount
                    reuse = 1
                    cost = raw
                stages = cm.fetch_stages(fab, chunk.length, self.cfg.payload,
                                         reuse_steps=reuse)
            sd = self.instances[holder].slowdown
            cost *= sd
            records.append(DispatchRecord(
                self.step_idx, holder, primitive, cid, n_req, m_q_total,
                cost, fabric_idx=fi, link_instance=holder, home=dest,
                stages=cm.scale_stages(stages, sd),
                req_ids=tuple(p.rq.req_id for p in entries)))
            # straggler mitigation: fire a backup to a replica if the
            # holder's (simulated) latency blows the p99 deadline
            if (self.instances[holder].slowdown
                    >= self.cfg.straggler_p99_factor):
                alt = [h for h in self.store.holders_of(cid)
                       if h != holder and self.instances[h].alive]
                if alt:
                    # the least-loaded live replica — backing up onto
                    # another straggler helps nobody
                    tgt = min(alt, key=lambda h: self.instances[h].slowdown)
                    fab2 = self.fabric_between(entries[0].rq.home, tgt)
                    fi2 = self.fabric_idx_between(entries[0].rq.home, tgt)
                    sd2 = self.instances[tgt].slowdown
                    backup_cost = (
                        cm.t_route(fab2, m_q_total, self.cfg.payload)
                        if primitive == "route"
                        else cm.t_fetch(fab2, chunk.length, self.cfg.payload)
                    ) * sd2
                    backup_stages = (
                        cm.route_stages(fab2, m_q_total, 0, self.cfg.payload)
                        if primitive == "route"
                        else cm.fetch_stages(fab2, chunk.length,
                                             self.cfg.payload))
                    records.append(DispatchRecord(
                        self.step_idx, tgt, primitive, cid, n_req,
                        m_q_total, backup_cost, backup=True,
                        fabric_idx=fi2, link_instance=tgt, home=dest,
                        stages=cm.scale_stages(backup_stages, sd2),
                        req_ids=tuple(p.rq.req_id for p in entries)))

        return StepPlan(
            step=self.step_idx, requests=list(requests), records=records,
            resident_pairs=resident_pairs, n_pairs=n_pairs,
            n_priced=len(pairs), n_resident=n_resident,
            replicas_spawned=replicas_spawned,
            evictions=self._evictions_this_step,
            selections=selections,
            selection_fallbacks=selection_fallbacks)

    # -- the columnar planner ----------------------------------------

    def _residency_mirror(self) -> dict:
        """Columnar snapshot of the chunk store (ids in insertion order,
        lengths, [canonical] + replicas holder matrix), cached on
        ChunkStore.version so steady-state steps pay zero rebuild cost."""
        v = self.store.version
        mir = self._mirror
        if mir is None or mir["version"] != v:
            ids, length, holders, chunks = self.store.residency_columns()
            # rank[i] = position of ids[i] in sorted-by-chunk-id order, so
            # integer (holder, rank) sort keys reproduce the object
            # planner's (holder, chunk_id) string order exactly (ids are
            # unique, making rank a total order consistent with the string
            # order)
            rank = [0] * len(ids)
            for r, i in enumerate(sorted(range(len(ids)),
                                         key=ids.__getitem__)):
                rank[i] = r
            mir = {"version": v, "ids": ids, "length": length,
                   "length_l": length.tolist(), "rank": rank,
                   "holders": holders, "chunks": chunks,
                   "index": {cid: i for i, cid in enumerate(ids)}}
            self._mirror = mir
        return mir

    def _nearest_table(self, mir: dict) -> dict:
        """Per-(chunk, home) nearest-live-holder table, cached on the
        (store version, instance aliveness) epoch. One vectorized argmin
        over (chunk, home, holder-slot) replaces per-step per-pair probe
        pricing: resolving a pair becomes two nested-list lookups. The
        tie-break is argmin's first minimum over the [canonical] +
        replicas columns — exactly the object planner's min(). Entries
        for orphaned chunks (live == 0) are garbage; callers must check
        `live` first (the planner falls back to the object path)."""
        av = tuple(i.alive for i in self.instances)
        nt = self._ntab
        if (nt is not None and nt["version"] == mir["version"]
                and nt["alive"] == av):
            return nt
        Hm = mir["holders"]                          # (nc, W)
        nc = Hm.shape[0]
        if nc == 0:
            nt = {"version": mir["version"], "alive": av, "Hm": Hm,
                  "holder": [], "live": [], "fi": [], "changed": None}
            self._ntab = nt
            return nt
        # incremental rebuild: a version bump from a replica spawn /
        # persist / eviction touches a handful of chunks — when aliveness
        # and matrix shape are unchanged, recompute only the rows whose
        # holder sets differ and patch them in place. `changed` carries the
        # dirty chunk rows to the planner's epoch-delta splice (None means
        # everything may have moved).
        if (nt is not None and nt["alive"] == av and "Hm" in nt
                and nt["Hm"].shape == Hm.shape):
            rows = np.nonzero((nt["Hm"] != Hm).any(axis=1))[0]
            if rows.shape[0] <= (nc >> 2):
                sub = self._ntab_rows(Hm, av, rows)
                holder_l, live_l, fi_l_ = nt["holder"], nt["live"], nt["fi"]
                hs, ls, fs = (sub["holder"].tolist(), sub["live"].tolist(),
                              sub["fi"].tolist())
                for x, ci in enumerate(rows.tolist()):
                    holder_l[ci] = hs[x]
                    live_l[ci] = ls[x]
                    fi_l_[ci] = fs[x]
                nt["prev"] = nt["version"]
                nt["version"] = mir["version"]
                nt["Hm"] = Hm
                nt["changed"] = set(rows.tolist())
                return nt
        sub = self._ntab_rows(Hm, av, None)
        nt = {"version": mir["version"], "alive": av, "Hm": Hm,
              "holder": sub["holder"].tolist(), "live": sub["live"].tolist(),
              "fi": sub["fi"].tolist(), "changed": None}
        self._ntab = nt
        return nt

    def _ntab_rows(self, Hm: np.ndarray, av: tuple,
                   rows: Optional[np.ndarray]) -> dict:
        """The nearest-table argmin for a row subset (all rows when None)."""
        if rows is not None:
            Hm = Hm[rows]
        nc = Hm.shape[0]
        n_inst = len(self.instances)
        pod = np.fromiter((i.pod for i in self.instances), np.int64, n_inst)
        alive = np.asarray(av, bool)
        Hc = np.clip(Hm, 0, None)
        alive_m = (Hm >= 0) & alive[Hc]              # (nc, W)
        live = alive_m.sum(axis=1)
        inst = np.arange(n_inst)
        probe = np.where(pod[Hc][:, None, :] == pod[None, :, None],
                         self._fa.t_probe_s[0], self._fa.t_probe_s[1])
        keyc = np.where(Hm[:, None, :] == inst[None, :, None], 0.0, probe)
        keyc = np.where(alive_m[:, None, :], keyc, np.inf)
        am = np.argmin(keyc, axis=2)                 # (nc, n_inst)
        holder_tab = Hm[np.arange(nc)[:, None], am]
        fi_tab = (pod[np.clip(holder_tab, 0, None)]
                  != pod[None, :]).astype(np.int64)
        return {"holder": holder_tab, "live": live, "fi": fi_tab}

    def _pair_entry(self, mq: int, ct: int, fi: int, ksel: int,
                    nh: int) -> list:
        """Decision-memo entry for one pricing-column combo: the §5 costs
        that do not depend on the reuse countdown, evaluated once through
        the SAME cost-model batch functions the full-width predicate uses
        (1-element arrays — pure element-wise math, so each lane is bitwise
        what a wide pass produces). Layout: [t_route, t_local, fetch_core,
        is_selection, {reuse -> (code, t_fetch)}] where fetch_core is the
        scattered-gather cost under selection (reuse-independent, §5.4) or
        the UN-amortised bulk pull otherwise."""
        memo = self._dec_memo
        key = (mq, ct, fi, ksel, nh)
        ent = memo.get(key)
        if ent is not None:
            self._n_dec_hit += 1
        else:
            self._n_dec_miss += 1
        if ent is None:
            fa = self._fa
            pay = self.cfg.payload
            fi_a = np.array([fi], np.int64)
            mq_a = np.array([mq], np.int64)
            if ksel >= 0 and nh > 1:
                tr = cm.t_route_fanout_batch(
                    fa, fi_a, mq_a, np.array([max(nh, 1)], np.int64), pay)
            else:
                tr = cm.t_route_batch(fa, fi_a, mq_a, pay)
            tl = cm.t_local_batch(np.array([ct], np.int64), pay.n_layers,
                                  C.PREFILL_PER_TOKEN_LAYER_MID_S)
            if ksel >= 0:
                aux = cm.t_fetch_scattered_batch(
                    fa, fi_a, np.array([max(ksel, 0)], np.int64),
                    np.array([max(nh, 1)], np.int64), pay)
            else:
                aux = cm.t_fetch_batch(fa, fi_a, np.array([ct], np.int64),
                                       pay, np.array([True]))
            ent = memo[key] = [float(tr[0]), float(tl[0]), float(aux[0]),
                               ksel >= 0, {}]
        return ent

    def _plan_step_arrays(self, requests: List[Request],
                          selections: Dict[int, object],
                          selection_fallbacks: int) -> Optional[StepPlan]:
        """Columnar plan_step: one vectorized residency pass over
        all (request, chunk) pairs, one decide_batch (plus an incremental
        §8 repricing of only the pairs whose link crossed the congestion
        knee), and template-priced dispatch assembly straight into
        StepPlanArrays columns. The Python control pass that remains runs
        per GROUP (fan-in budget, persistence, backups — a handful per
        step), never per pair. Returns None when the step needs the object
        fallback: a chunk with no live holder (mid-step re-homing)."""
        step = self.step_idx
        cfg = self.cfg
        mir = self._residency_mirror()
        ids: Tuple[str, ...] = mir["ids"]
        idx_of = mir["index"]
        chunks = mir["chunks"]
        length_l = mir["length_l"]
        slowdown = [i.slowdown for i in self.instances]
        ntab = self._nearest_table(mir)
        holder_tab = ntab["holder"]
        live_tab = ntab["live"]
        fi_tab = ntab["fi"]

        # -- phase 1: residency resolution, one Python pass over pairs ------
        # (per-pair work is two table lookups; pair order == the object
        # planner's, so column order and group insertion order match it)
        #
        # Cross-step cache, two layers keyed on the (store version,
        # aliveness) residency epoch. A request's resolution — which pairs
        # are resident, each priced pair's holder / fabric / group key —
        # depends only on the epoch and the request's own fields MINUS the
        # reuse countdown, so it is cached per request and spliced into the
        # step columns; when the whole request SET repeats (no session
        # rolled over), the assembled columns themselves are reused and the
        # splice is skipped too. Reuse, the one per-step-varying column, is
        # rebuilt from the live requests either way.
        epoch = (mir["version"], ntab["alive"])
        p1 = self._p1
        force_k0 = -1      # first residency-dirty request under epoch delta
        if p1 is not None and p1["epoch"] != epoch:
            # Epoch delta: when the nearest table knows exactly which chunk
            # rows moved since the version this cache was built against
            # (and aliveness held), only cache entries touching those
            # chunks are stale — prune them and force the step splice to
            # restart at the first dirty request instead of discarding
            # everything.
            ch = (ntab["changed"]
                  if (ntab.get("prev"), ntab["alive"]) == p1["epoch"]
                  else None)
            if ch is None:
                p1 = None
            else:
                rc = p1["req"]
                for rk in [rk for rk, ent in rc.items()
                           if any(idx_of[c] in ch for c in ent[-1])]:
                    del rc[rk]
                stp = p1["step"]
                if stp is not None:
                    sg = stp["sig"]
                    force_k0 = len(sg)
                    for k in range(len(sg)):
                        if any(idx_of[c] in ch for c in sg[k][5]):
                            force_k0 = k
                            break
                p1["epoch"] = epoch
        if p1 is None:
            p1 = self._p1 = {"epoch": epoch, "req": {}, "step": None}
        rcache: Dict[tuple, tuple] = p1["req"]
        st = p1["step"]
        nreq = len(requests)
        k0 = -1                        # first request needing a (re)splice
        if st is not None and len(st["sig"]) == nreq:
            sig = st["sig"]
            k0 = nreq
            for k, rq in enumerate(requests):
                s = sig[k]
                if (s[0] != rq.req_id or s[1] != rq.home
                        or s[2] != rq.m_q or s[3] != rq.k_selected
                        or s[4] != (rq.req_id in selections)
                        or s[5] != rq.chunk_ids):
                    k0 = k
                    break
            if 0 <= force_k0 < k0:
                k0 = force_k0
        full_hit = k0 == nreq
        if full_hit:
            self._n_step_replay_hit += 1
        else:
            self._n_step_replay_miss += 1
        if full_hit:                                 # whole step repeated
            for c in st["touch"]:            # replica-LRU touch, idempotent
                c.last_access = step
            resident_pairs = st["resident"]
            n_pairs = st["n_pairs"]
            pair_req = st["pair_req"]
            (mq_l, ct_l, fi_l, ksel_l, nh_l, home_l, rid_l, hold_l,
             groups, pkey_l, dec_l) = st["cols"]
        else:
            if k0 < 0:                               # no reusable prefix
                k0 = 0
                # cols: mq, ct, fi, ksel, nh, home, rid, hold, then the
                # (holder, chunk idx, fabric idx, selection req) ->
                # priced-pair-rows dict in first-occurrence order (the
                # object planner's group key), pair -> group key, and
                # pair -> decision-memo entry
                st = p1["step"] = {
                    "sig": [], "touch": [], "pair_req": [], "resident": [],
                    "n_pairs": 0,
                    # per-request cumulative offsets into pairs / priced
                    # pairs / residents / touches — the delta-splice cut
                    # points
                    "np_off": [0], "p_off": [0], "r_off": [0], "t_off": [0],
                    "cols": ([], [], [], [], [], [], [], [], {}, [], [])}
            sig = st["sig"]
            touch = st["touch"]
            pair_req = st["pair_req"]
            resident_pairs = st["resident"]
            np_off = st["np_off"]
            p_off = st["p_off"]
            r_off = st["r_off"]
            t_off = st["t_off"]
            (mq_l, ct_l, fi_l, ksel_l, nh_l, home_l, rid_l, hold_l,
             groups, pkey_l, dec_l) = st["cols"]
            # Delta splice: requests before k0 verified unchanged, so their
            # column rows are already right — truncate everything past
            # their boundary and replay only the suffix. Group member
            # lists hold pair rows in ascending order, so each suffix pair
            # sits at its group's tail; popping in reverse pair order and
            # deleting emptied groups restores exactly the dict state
            # (insertion order included) a prefix-only build would have
            # produced, and the replay then re-inserts suffix-first groups
            # at the end — the fresh-build order.
            cut_p = p_off[k0]
            for j in range(len(pkey_l) - 1, cut_p - 1, -1):
                g = groups[pkey_l[j]]
                g.pop()
                if not g:
                    del groups[pkey_l[j]]
            del mq_l[cut_p:]
            del ct_l[cut_p:]
            del fi_l[cut_p:]
            del ksel_l[cut_p:]
            del nh_l[cut_p:]
            del home_l[cut_p:]
            del rid_l[cut_p:]
            del hold_l[cut_p:]
            del pkey_l[cut_p:]
            del dec_l[cut_p:]
            del pair_req[cut_p:]
            del sig[k0:]
            del resident_pairs[r_off[k0]:]
            del touch[t_off[k0]:]
            del np_off[k0 + 1:]
            del p_off[k0 + 1:]
            del r_off[k0 + 1:]
            del t_off[k0 + 1:]
            n_pairs = np_off[k0]
            st.pop("order_g", None)       # derived caches are now stale
            st.pop("lid", None)
            st.pop("p3", None)
            for c in touch:               # prefix replica-LRU touch
                c.last_access = step
            for k in range(k0, nreq):
                rq = requests[k]
                rid = rq.req_id
                home = rq.home
                mq = rq.m_q
                selflag = rid in selections
                cids = rq.chunk_ids
                # scalar cache key; the chunk-id list is checked by equality
                # against the cached copy (identity-equal string elements
                # make the compare a pointer scan, far cheaper than hashing
                # a 12-string tuple every step)
                rkey = (rid, home, mq, rq.k_selected, selflag)
                ent = rcache.get(rkey)
                if ent is not None and ent[-1] != cids:
                    ent = None
                if ent is not None:
                    self._n_sig_hit += 1
                else:
                    self._n_sig_miss += 1
                if ent is None:
                    srid = rid if selflag else -1
                    span: Optional[set] = set() if selflag else None
                    ksel = -1 if rq.k_selected is None else rq.k_selected
                    s_res: List[ResidentPair] = []
                    s_touch: List[object] = []
                    s_ct: List[int] = []
                    s_fi: List[int] = []
                    s_nh: List[int] = []
                    s_hold: List[int] = []
                    s_key: List[tuple] = []
                    for cid in cids:
                        ci = idx_of[cid]
                        s_touch.append(chunks[ci])
                        live = live_tab[ci]
                        if not live:
                            # orphaned chunk -> object fallback; the half-
                            # replayed step cache must not survive
                            p1["step"] = None
                            return None
                        h = holder_tab[ci][home]
                        if span is not None:
                            span.add(h)
                        if h == home:
                            s_res.append(ResidentPair(rid, cid, home))
                            continue
                        s_ct.append(length_l[ci])
                        s_fi.append(fi_tab[ci][home])
                        s_nh.append(live)
                        s_hold.append(h)
                        s_key.append((h, ci, s_fi[-1], srid))
                    if span is not None:
                        # under an active selection the predicate's
                        # n_holders is the M the request's selection SPANS
                        # (§5.4) — distinct chosen holders over ALL its
                        # pairs, resident shards counting their home — not
                        # the chunk's replica count
                        s_nh = [max(1, len(span))] * len(s_nh)
                    seg = len(s_ct)
                    s_dec = [self._pair_entry(mq, s_ct[x], s_fi[x], ksel,
                                              s_nh[x]) for x in range(seg)]
                    ent = (len(cids), s_touch, s_res, seg, [mq] * seg,
                           s_ct, s_fi, [ksel] * seg, s_nh, [home] * seg,
                           [rid] * seg, s_hold, s_key, s_dec, list(cids))
                    rcache[rkey] = ent
                (ncids, s_touch, s_res, seg, s_mq, s_ct, s_fi, s_ksel,
                 s_nh, s_home, s_rid, s_hold, s_key, s_dec, _) = ent
                sig.append((rid, home, mq, rq.k_selected, selflag,
                            list(cids)))
                n_pairs += ncids
                touch.extend(s_touch)
                for c in s_touch:
                    c.last_access = step     # replica-LRU touch
                if s_res:
                    resident_pairs.extend(s_res)
                if seg:
                    i = len(mq_l)
                    mq_l.extend(s_mq)
                    ct_l.extend(s_ct)
                    fi_l.extend(s_fi)
                    ksel_l.extend(s_ksel)
                    nh_l.extend(s_nh)
                    home_l.extend(s_home)
                    rid_l.extend(s_rid)
                    hold_l.extend(s_hold)
                    pair_req.extend([k] * seg)
                    pkey_l.extend(s_key)
                    dec_l.extend(s_dec)
                    for gk in s_key:
                        g = groups.get(gk)
                        if g is None:
                            groups[gk] = [i]
                        else:
                            g.append(i)
                        i += 1
                np_off.append(n_pairs)
                p_off.append(len(mq_l))
                r_off.append(len(resident_pairs))
                t_off.append(len(touch))
            st["n_pairs"] = n_pairs
        # reuse, the one per-step-varying pricing column, is rebuilt from
        # the live requests every step
        reuse_l = [requests[k].expected_reuse_steps for k in pair_req]
        n_resident = len(resident_pairs)
        n_priced = len(mq_l)
        replicas_spawned = 0

        if n_pairs == 0:
            return StepPlan(
                step=step, requests=list(requests), records=[],
                resident_pairs=[], n_pairs=0, n_priced=0, n_resident=0,
                replicas_spawned=0, evictions=self._evictions_this_step,
                selections=selections,
                selection_fallbacks=selection_fallbacks,
                arrays=StepPlanArrays.from_records(step, []))

        # record rows under construction (row order == the object planner's
        # record order; unzipped into columns at assembly) + per-pricing-
        # kind row buckets
        rows: List[tuple] = []
        kr_i: List[int] = []
        kr_kf: List[int] = []
        kfh_i: List[int] = []
        kfh_reuse: List[int] = []
        kfh_p3: List[tuple] = []   # (persisted, m0, mem|None) per fetch row
        kl_i: List[int] = []
        ksr_i: List[int] = []
        ksr_kf: List[int] = []
        ksr_frac: List[float] = []
        ksr_kb: List[int] = []
        ksf_i: List[int] = []
        ksf_kl: List[int] = []
        ksf_kb: List[int] = []
        ex_i: List[int] = []
        ex_est: List[float] = []
        ex_stages: List[tuple] = []

        def _row(prim, holder_, cidx_, nreq, mqt, fi_, link, home_, sd,
                 scnt, rids, backup=False):
            rows.append((prim, holder_, cidx_, nreq, mqt, backup, fi_,
                         link, home_, sd, scnt, rids))
            return len(rows) - 1

        if n_priced:
            # -- phase 2: the §5 predicate per pair via the decision memo.
            # A pair's three costs depend only on its pricing columns plus
            # the reuse countdown, and the distinct column combos number a
            # few hundred over a whole run — so each (columns, reuse) point
            # is priced once (through the cm batch functions on 1-element
            # arrays, bitwise the lane a full-width pass would produce) and
            # every later occurrence is a dict probe.
            code_l: List[int] = []
            tf_l: List[float] = []
            for E, re_ in zip(dec_l, reuse_l):
                rd = E[4]
                v = rd.get(re_)
                if v is None:
                    # dense fetch amortises bulk over reuse; the selection
                    # scattered gather never amortises (§5.4)
                    tf = E[2] if E[3] else E[2] / (re_ if re_ > 1 else 1)
                    tr = E[0]
                    tl = E[1]
                    cdd = 0 if (tr <= tf and tr <= tl) else \
                        (1 if tf <= tl else 2)
                    v = rd[re_] = (cdd, tf)
                code_l.append(v[0])
                tf_l.append(v[1])

            def _maj(mem: List[int]) -> int:
                # max(votes, key=votes.get) returns the first-INSERTED code
                # among tied maxima — the object planner's tie-break,
                # expression for expression
                if len(mem) == 1:
                    return code_l[mem[0]]
                votes: Dict[int, int] = {}
                for j in mem:
                    cj = code_l[j]
                    votes[cj] = votes.get(cj, 0) + 1
                return max(votes, key=votes.get)

            gmaj = {key: (code_l[mem[0]] if len(mem) == 1 else _maj(mem))
                    for key, mem in groups.items()}
            kf_l: Optional[List[int]] = None
            if cfg.congestion_aware:
                # §8 link occupancy: transport-majority groups each put one
                # flow on their (holder, fabric) link. Links are dense small
                # ints (holder * 2 + fabric), so the per-pair occupancy is
                # a plain-list scatter + gather (the arrays here are far
                # below numpy's break-even); the pair -> link map is
                # epoch-stable and cached with the step columns.
                lid = st.get("lid")
                if lid is None:
                    lid = st["lid"] = [h * 2 + f
                                       for h, f in zip(hold_l, fi_l)]
                lcnt = [0] * (2 * len(self.instances))
                for key, mj in gmaj.items():
                    if mj != P.LOCAL_CODE:
                        lcnt[key[0] * 2 + key[2]] += 1
                kf_l = [lcnt[x] for x in lid]
                hot = [i for i, v in enumerate(kf_l) if v >= 3] \
                    if max(lcnt) >= 3 else []
                if hot:
                    # incremental repricing: the §8 premium is flat through
                    # K<=2, so only pairs on links past the knee can price
                    # differently — and congestion only enters the ROUTE
                    # term, so reprice that one cost on the knee slice
                    # (memoized per (m_q, fabric, k_flows) point) and re-run
                    # the argmin against the uncontended fetch/local
                    cong = self._cong_memo
                    pay = cfg.payload
                    for j in hot:
                        E = dec_l[j]
                        if E[3] and nh_l[j] > 1:
                            trh = E[0]  # fan-out ROUTE is kf-independent
                        else:
                            ck = (mq_l[j], fi_l[j], kf_l[j])
                            trh = cong.get(ck)
                            if trh is None:
                                trh = cong[ck] = float(
                                    cm.t_route_congested_full_batch(
                                        self._fa,
                                        np.array([fi_l[j]], np.int64),
                                        np.array([mq_l[j]], np.int64),
                                        np.array([kf_l[j]], np.int64),
                                        pay)[0])
                        tf = tf_l[j]
                        tl = E[1]
                        code_l[j] = 2 if (tl < trh and tl < tf) else \
                            (1 if tf < trh else 0)
                    # only groups holding a repriced pair can change their
                    # majority; every other group's votes are untouched
                    for key in {pkey_l[j] for j in hot}:
                        gmaj[key] = _maj(groups[key])

            # -- phase-3/4 cache: when the whole step repeated AND the
            # post-congestion codes, slowdowns, and fetch amortisations all
            # match the step that built the cached assembly, the group walk
            # is a pure replay — every row, stage, and est is bitwise the
            # cached one (mutating walks — spawns, persists, evictions —
            # bump the store version, which resets the epoch and this
            # cache with it). Only the step stamp differs.
            p3 = st.get("p3") if full_hit and not selections else None
            if (p3 is not None and p3["code"] == code_l
                    and p3["slow"] == slowdown):
                new_kfh = [
                    (reuse_l[m0] if mem is None
                     else max(reuse_l[j] for j in mem)) if persisted else 1
                    for persisted, m0, mem in p3["kfh_rows"]]
                if new_kfh == p3["kfh_reuse"]:
                    self._n_p3_hit += 1
                    arr0 = p3["arrays"]
                    arrays = dataclasses.replace(arr0, step=step)
                    fa_memo = getattr(arr0, "_fa_memo", None)
                    if fa_memo is not None:
                        arrays._fa_memo = fa_memo
                    return StepPlan(
                        step=step, requests=list(requests), records=None,
                        resident_pairs=resident_pairs, n_pairs=n_pairs,
                        n_priced=n_priced, n_resident=n_resident,
                        replicas_spawned=0,
                        evictions=self._evictions_this_step,
                        selections=selections,
                        selection_fallbacks=selection_fallbacks,
                        arrays=arrays)
            # phase-3 iteration order: the object planner sorts first-
            # occurrence group order stably by (holder, chunk_id) — dict
            # insertion order IS first-occurrence order, and the stable
            # sort preserves it between equal (holder, chunk_id) keys.
            # Integer (holder, rank) keys stand in for the string pair
            # (rank is the chunk-id sort rank, see _residency_mirror), and
            # the sorted order is cached with the step's columns since it
            # is a pure function of them.
            order_g = st.get("order_g")
            if order_g is None:
                rank_l = mir["rank"]
                order_g = st["order_g"] = sorted(
                    groups.items(),
                    key=lambda kv: (kv[0][0], rank_l[kv[0][1]]))
            route_budget: Dict[Tuple[int, int], int] = {}
            sel_get = selections.get
            fanin_cap = cfg.fanin_cap
            p99 = cfg.straggler_p99_factor
            persist = cfg.persist_fetches

            for key, mem in order_g:
                hld, cidx_g, fi, srid = key
                sel = sel_get(srid) if srid >= 0 else None
                mj = gmaj[key]            # 0 ROUTE / 1 FETCH / 2 LOCAL
                if mj == 0 and sel is None:
                    budget = route_budget.get(key[:2], fanin_cap)
                    keep = min(len(mem), max(0, budget))
                    if keep < len(mem):
                        overflow, mem = mem[keep:], mem[:keep]
                        rep = self._spawn_replica_cols(
                            ids[cidx_g], [home_l[j] for j in overflow],
                            [mq_l[j] for j in overflow],
                            [rid_l[j] for j in overflow])
                        if rep is not None:
                            i = _row(3, rep.holder, cidx_g,
                                     rep.n_requesters, rep.m_q_total,
                                     rep.fabric_idx, rep.link_instance,
                                     rep.home, 1.0, len(rep.stages),
                                     rep.req_ids)
                            ex_i.append(i)
                            ex_est.append(rep.est_cost_s)
                            ex_stages.append(rep.stages)
                            replicas_spawned += 1
                        else:
                            mem = mem + overflow
                        if not mem:
                            continue
                    route_budget[key[:2]] = max(0, budget - len(mem))
                m0 = mem[0]
                nreq = len(mem)
                if nreq == 1:
                    mqt = mq_l[m0]
                else:
                    mqt = 0
                    for j in mem:
                        mqt += mq_l[j]
                if mj == 2:
                    if nreq == 1:
                        hm = home_l[m0]
                        kl_i.append(_row(2, hm, cidx_g, 1, mqt, -1, -1,
                                         hm, slowdown[hm], 1,
                                         (rid_l[m0],)))
                        continue
                    by_home: Dict[int, List[int]] = {}
                    for j in mem:
                        by_home.setdefault(home_l[j], []).append(j)
                    for hm in sorted(by_home):
                        ps = by_home[hm]
                        kl_i.append(_row(
                            2, hm, cidx_g, len(ps),
                            sum(mq_l[j] for j in ps), -1, -1, hm,
                            slowdown[hm], 1, tuple(rid_l[j] for j in ps)))
                    continue
                if nreq == 1:
                    dest = home_l[m0]
                    rids = (rid_l[m0],)
                else:
                    dest = self._busiest_home_cols(
                        [home_l[j] for j in mem], [mq_l[j] for j in mem])
                    rids = tuple([rid_l[j] for j in mem])
                sd = slowdown[hld]
                if sel is not None:
                    bt = self.selector.block_tokens
                    ct = ct_l[m0]
                    kb_wire = min(max(1, -(-int(ksel_l[m0]) // bt)),
                                  max(1, -(-ct // bt)))
                    k_local = sel.k_on(ids[cidx_g])
                    if mj == 0:
                        ksr_i.append(_row(0, hld, cidx_g, nreq, mqt, fi,
                                          hld, dest, sd, 6, rids))
                        ksr_kf.append(kf_l[m0]
                                      if kf_l is not None else 0)
                        ksr_frac.append(min(1.0, k_local / max(1, ct)))
                        ksr_kb.append(kb_wire)
                    else:
                        ksf_i.append(_row(1, hld, cidx_g, nreq, mqt, fi,
                                          hld, dest, sd, 2, rids))
                        ksf_kl.append(k_local)
                        ksf_kb.append(kb_wire)
                    continue
                if mj == 0:
                    kr_i.append(_row(0, hld, cidx_g, nreq, mqt, fi, hld,
                                     dest, sd, 5, rids))
                    kr_kf.append(kf_l[m0] if kf_l is not None else 0)
                else:
                    persisted = False
                    if persist:
                        persisted = self._make_resident(ids[cidx_g], dest)
                    kfh_i.append(_row(1, hld, cidx_g, nreq, mqt, fi, hld,
                                      dest, sd, 2, rids))
                    kfh_reuse.append(
                        (reuse_l[m0] if nreq == 1
                         else max(reuse_l[j] for j in mem))
                        if persisted else 1)
                    kfh_p3.append((persisted, m0,
                                   None if nreq == 1 else mem))
                # straggler backup shadows dense route/fetch only
                if sd >= p99:
                    cid = ids[cidx_g]
                    alt = [h for h in self.store.holders_of(cid)
                           if h != hld and self.instances[h].alive]
                    if alt:
                        tgt = min(alt, key=lambda h: slowdown[h])
                        h0 = home_l[m0]
                        fab2 = self.fabric_between(h0, tgt)
                        fi2 = self.fabric_idx_between(h0, tgt)
                        sd2 = slowdown[tgt]
                        if mj == 0:
                            bcost = cm.t_route(fab2, mqt,
                                               cfg.payload) * sd2
                            bstages = cm.route_stages(fab2, mqt, 0,
                                                      cfg.payload)
                        else:
                            ct = ct_l[m0]
                            bcost = cm.t_fetch(fab2, ct,
                                               cfg.payload) * sd2
                            bstages = cm.fetch_stages(fab2, ct,
                                                      cfg.payload)
                        bstages = cm.scale_stages(bstages, sd2)
                        bi = _row(mj, tgt,
                                  cidx_g, nreq, mqt, fi2, tgt, dest, sd2,
                                  len(bstages), rids, backup=True)
                        ex_i.append(bi)
                        ex_est.append(bcost)
                        ex_stages.append(bstages)

        # -- broadcast pricing: one template call per dispatch kind ---------
        R = len(rows)
        if R:
            (r_prim, r_holder, r_cidx, r_nreq, r_mqt, r_backup, r_fi,
             r_link, r_home, r_sd, r_scnt, r_rids) = zip(*rows)
        else:
            r_prim = r_holder = r_cidx = r_nreq = r_mqt = r_backup = \
                r_fi = r_link = r_home = r_sd = r_scnt = r_rids = ()
        # every row lands in exactly one pricing bucket and every stage slot
        # is filled by its bucket's _fill (or the explicit-stage loop), so
        # uninitialised allocation is safe here
        est = np.empty(R, np.float64)
        stage_off = np.zeros(R + 1, np.int64)
        np.cumsum(np.asarray(r_scnt, np.int64), out=stage_off[1:])
        S = int(stage_off[-1])
        stage_code = np.empty(S, np.int64)
        stage_dur = np.empty(S, np.float64)
        fi_col = np.asarray(r_fi, np.int64)
        mqt_col = np.asarray(r_mqt, np.int64)
        cidx_col = np.asarray(r_cidx, np.int64)
        sd_col = np.asarray(r_sd, np.float64)
        length = mir["length"]
        T = self._templates

        def _fill(rows, codes, dur):
            pos = stage_off[rows][:, None] + np.arange(codes.shape[0])
            stage_code[pos] = codes
            stage_dur[pos] = dur

        if kr_i:
            rows = np.asarray(kr_i, np.intp)
            sd = sd_col[rows]
            est[rows] = T.route_est(fi_col[rows], mqt_col[rows],
                                    np.asarray(kr_kf, np.int64)) * sd
            _fill(rows, _ROUTE_CODES,
                  T.route(fi_col[rows], mqt_col[rows]) * sd[:, None])
        if kfh_i:
            rows = np.asarray(kfh_i, np.intp)
            sd = sd_col[rows]
            reuse = np.asarray(kfh_reuse, np.int64)
            ct = length[cidx_col[rows]]
            est[rows] = T.fetch_est(fi_col[rows], ct, reuse) * sd
            _fill(rows, _FETCH_CODES,
                  T.fetch(fi_col[rows], ct, reuse) * sd[:, None])
        if kl_i:
            rows = np.asarray(kl_i, np.intp)
            sd = sd_col[rows]
            ct = length[cidx_col[rows]]
            est[rows] = T.local_est(ct) * sd
            _fill(rows, _LOCAL_CODES, T.local(ct) * sd[:, None])
        if ksr_i:
            rows = np.asarray(ksr_i, np.intp)
            sd = sd_col[rows]
            frac = np.asarray(ksr_frac, np.float64)
            kb = np.asarray(ksr_kb, np.int64)
            kf = np.asarray(ksr_kf, np.int64)
            d_index = self.selector.d_index
            est[rows] = T.route_selected_est(
                fi_col[rows], mqt_col[rows], kf, frac, kb, d_index) * sd
            _fill(rows, _SELR_CODES,
                  T.route_selected(fi_col[rows], mqt_col[rows], frac, kb,
                                   d_index) * sd[:, None])
        if ksf_i:
            rows = np.asarray(ksf_i, np.intp)
            sd = sd_col[rows]
            kl = np.asarray(ksf_kl, np.int64)
            kb = np.asarray(ksf_kb, np.int64)
            d_index = self.selector.d_index
            est[rows] = T.fetch_selected_est(
                fi_col[rows], kl, mqt_col[rows], kb, d_index) * sd
            _fill(rows, _SELF_CODES,
                  T.fetch_selected(fi_col[rows], kl, mqt_col[rows], kb,
                                   d_index) * sd[:, None])
        for i, e, stages in zip(ex_i, ex_est, ex_stages):
            est[i] = e
            o = int(stage_off[i])
            for j, (name, dur) in enumerate(stages):
                stage_code[o + j] = TL.STAGE_CODE[name]
                stage_dur[o + j] = dur

        req_off = np.zeros(R + 1, np.int64)
        np.cumsum(np.asarray([len(t) for t in r_rids], np.int64),
                  out=req_off[1:])
        arrays = StepPlanArrays(
            step=step, chunk_ids=ids, prim=np.asarray(r_prim, np.int64),
            holder=np.asarray(r_holder, np.int64), chunk=cidx_col,
            n_requesters=np.asarray(r_nreq, np.int64), m_q_total=mqt_col,
            est_cost_s=est, backup=np.asarray(r_backup, bool),
            fabric_idx=fi_col, link_instance=np.asarray(r_link, np.int64),
            home=np.asarray(r_home, np.int64), stage_off=stage_off,
            stage_code=stage_code, stage_dur=stage_dur, req_off=req_off,
            req_ids=np.asarray([q for t in r_rids for q in t], np.int64))
        if n_priced and not selections and replicas_spawned == 0:
            # the phase-3/4 replay cache (see the hit check above); a step
            # with spawns mutated the store, so its assembly can never be
            # replayed under the same epoch
            st["p3"] = {"code": list(code_l), "slow": list(slowdown),
                        "kfh_rows": kfh_p3, "kfh_reuse": list(kfh_reuse),
                        "arrays": arrays}
        return StepPlan(
            step=step, requests=list(requests),
            records=None, resident_pairs=resident_pairs,
            n_pairs=n_pairs, n_priced=n_priced, n_resident=n_resident,
            replicas_spawned=replicas_spawned,
            evictions=self._evictions_this_step, selections=selections,
            selection_fallbacks=selection_fallbacks, arrays=arrays)

    def _warn_selection_fallback(self) -> None:
        """A request carried k_selected but no selector is configured: the
        predicate PRICES the §5.4 selection regime while both backends
        execute dense full-chunk attention. Warn once per engine and count
        every occurrence in StepStats.selection_fallbacks, so priced-vs-
        executed regimes can never diverge silently."""
        if self._warned_selection_fallback:
            return
        self._warned_selection_fallback = True
        warnings.warn(
            "requests carry k_selected but the engine has no selection "
            "service: the selection regime is priced but executed as dense "
            "full-chunk attention (recorded in StepStats.selection_"
            "fallbacks). Pass selector=IndexerService() "
            "(repro.serving.selection) or a ReplaySelector to run the "
            "indexer.", RuntimeWarning, stacklevel=3)

    # -- PLAN -> EXECUTE -> ACCOUNT --------------------------------------------

    def schedule_step(self, requests: List[Request]) -> List[DispatchRecord]:
        """One decode step: plan the transports (or claim a speculative
        plan, see speculate_step), submit them to the backend, and drain
        completed steps down to cfg.pipeline_depth - 1 in flight. At
        depth 1 (the default) the step is accounted before this returns —
        the historical lockstep plan->execute->account loop, bit-for-bit.
        Returns the planned records (the engine's historical contract)."""
        depth = max(1, self.cfg.pipeline_depth)
        t_plan0 = time.perf_counter()
        spec = self._claim_speculative(requests)
        if spec is not None:
            plan = spec.plan
            t_plan0, t_plan1 = spec.t_plan0, spec.t_plan1
            plan_wall = spec.plan_wall_s
        else:
            plan = self.plan_step(requests)
            t_plan1 = time.perf_counter()
            plan_wall = t_plan1 - t_plan0
            if self._inflight:
                # this plan ran while the oldest submitted step's device
                # work was still un-awaited: it is overlap if that step's
                # await turns out to actually block
                self._inflight[0].overlap_candidate_s += plan_wall
        ticket = submit_step(self.backend, self, plan)
        t_submit1 = time.perf_counter()
        self._inflight.append(_InFlight(
            plan=plan, ticket=ticket, t_plan0=t_plan0, t_plan1=t_plan1,
            t_submit1=t_submit1, plan_wall_s=plan_wall))
        while len(self._inflight) > depth - 1:
            self._drain_one()
        return plan.records

    def speculate_step(self, requests: List[Request]) -> None:
        """Plan the NEXT step now, while submitted device work is in
        flight. plan_step commits its own promotion/eviction deltas, so
        the plan produced here is exactly the plan schedule_step would
        have produced later — unless the world mutates first, in which
        case _claim_speculative discards it and replans (counted in
        misspeculation_replans). No-op at depth 1 or when a speculative
        plan is already parked."""
        if max(1, self.cfg.pipeline_depth) < 2 or self._spec is not None:
            return
        t0 = time.perf_counter()
        plan = self.plan_step(requests)
        t1 = time.perf_counter()
        if self._inflight:
            self._inflight[0].overlap_candidate_s += t1 - t0
        self._spec = _Speculative(
            requests=list(requests), plan=plan, epoch=self._world_epoch(),
            plan_wall_s=t1 - t0, t_plan0=t0, t_plan1=t1)

    def _world_epoch(self) -> tuple:
        """Everything a between-steps mutation can change that planning
        reads: residency structure (store.version — set_replica_data
        deliberately does NOT bump it, so in-flight byte persistence
        can't fault a speculation), liveness, and straggler factors."""
        return (self.store.version,
                tuple(i.alive for i in self.instances),
                tuple(i.slowdown for i in self.instances))

    def _claim_speculative(self,
                           requests: List[Request]) -> Optional[_Speculative]:
        """Return the parked speculative plan iff it matches this call's
        requests and the world has not mutated since it was planned;
        otherwise discard it, rewind step_idx, and count the replan. The
        discarded plan's residency commits are NOT rolled back: promoted
        replicas are delta-0 (content-identical to canonical), so a
        superseding replan against the post-speculation mirror prices the
        same bytes and the chosen plan's outputs stay §3.3-exact — the
        replan simply re-decides against what is actually resident."""
        spec, self._spec = self._spec, None
        if spec is None:
            return None
        if spec.epoch == self._world_epoch() \
                and spec.requests == list(requests):
            return spec
        self.misspeculation_replans += 1
        self.step_idx = spec.plan.step - 1
        return None

    def _invalidate_speculation(self) -> bool:
        """Drop the parked speculative plan (mutation incoming). The next
        schedule_step replans from scratch against the mutated world."""
        spec, self._spec = self._spec, None
        if spec is None:
            return False
        self.misspeculation_replans += 1
        self.step_idx = spec.plan.step - 1
        return True

    def _drain_one(self) -> None:
        """Await + account the oldest in-flight step (FIFO — submit
        order, which the backends require)."""
        entry = self._inflight.pop(0)
        t_await0 = time.perf_counter()
        execution = await_step(self.backend, self, entry.ticket)
        t_await1 = time.perf_counter()
        await_wall = t_await1 - t_await0
        # the await blocked => the device was busy from submit straight
        # through it, so every planner second that ran in between was
        # fully hidden; an instant return means there was nothing to hide
        # under (eager backend, or the device finished long ago)
        hidden = entry.overlap_candidate_s \
            if (entry.overlap_candidate_s > 0.0
                and await_wall > _AWAIT_BLOCK_EPS_S) else 0.0
        self.planner_overlap_s += hidden
        wall = entry.plan_wall_s + (entry.t_submit1 - entry.t_plan1) \
            + await_wall
        self._account(entry.plan, execution, wall)
        self.plan_walls.append(entry.plan_wall_s)
        obs = self.obs
        if obs.enabled:
            # everything observability-heavy happens HERE — after
            # sched_wall_s was measured, outside the planner wall
            obs.on_step(self, entry.plan, execution, self.stats[-1],
                        (entry.t_plan0, entry.t_plan1, t_await1,
                         time.perf_counter()),
                        overlap_s=hidden,
                        replans=self.misspeculation_replans)
            if self._spec is not None and obs.drift is not None \
                    and obs.drift.tripped():
                # a drift trip between plan and account invalidates the
                # speculative plan exactly like an explicit mutation
                self._invalidate_speculation()

    def flush(self) -> None:
        """Drain every in-flight step (await + account). Call after the
        last schedule_step of a pipelined run — run() does. Leaves any
        speculative plan parked for the next schedule_step."""
        while self._inflight:
            self._drain_one()

    def planner_cache_stats(self) -> Dict[str, int]:
        """Cumulative planner-cache effectiveness counters:
        hit/miss for the per-request signature cache, the full-step column
        replay, the phase-3/4 assembly replay, the §5 decision memo, and
        array->object planner fallbacks. (The timeline's schedule-memo
        counters live in timeline.sim_memo_stats() — module-global, like
        the memo itself.)"""
        return {
            "sig_hit": self._n_sig_hit,
            "sig_miss": self._n_sig_miss,
            "step_replay_hit": self._n_step_replay_hit,
            "step_replay_miss": self._n_step_replay_miss,
            "p3_replay_hit": self._n_p3_hit,
            "dec_memo_hit": self._n_dec_hit,
            "dec_memo_miss": self._n_dec_miss,
            "object_fallbacks": self._n_obj_fallback,
        }

    def _account(self, plan: StepPlan, execution: StepExecution,
                 wall_s: float) -> None:
        """Fold one planned + executed step into the engine's telemetry."""
        self.log.extend(plan.records)
        self.plans.append(plan)
        self.step_outputs.append(execution.outputs)
        self.measured_reports.append(getattr(execution, "measured", None))
        if self.cfg.retain_outputs >= 0:
            # exactly one step falls out of the window per step
            idx = len(self.step_outputs) - self.cfg.retain_outputs - 1
            if idx >= 0:
                self.step_outputs[idx] = {}
        prim_counts: Dict[str, int] = defaultdict(int)
        for r in plan.records:
            if not r.backup:
                prim_counts[r.primitive] += 1
        timeline = execution.timeline
        self.timelines.append(timeline)
        self.stats.append(StepStats(
            step=plan.step, n_requests=len(plan.requests),
            n_pairs=plan.n_pairs, n_priced=plan.n_priced,
            n_resident=plan.n_resident,
            n_dispatches=sum(1 for r in plan.records if not r.backup),
            primitives=dict(prim_counts),
            latency_s=timeline.makespan_s,
            sched_wall_s=wall_s,
            replicas_spawned=plan.replicas_spawned,
            evictions=plan.evictions,
            max_dispatch_s=(plan.arrays.critical_path_s()
                            if plan.arrays is not None
                            else _critical_path(plan.records)),
            serial_stage_s=timeline.serial_s,
            stage_totals=timeline.stage_totals(),
            n_selected=sum(len(rq.chunk_ids) for rq in plan.requests
                           if rq.req_id in plan.selections),
            selection_fallbacks=plan.selection_fallbacks))

    # -- multi-step driver -----------------------------------------------------

    def run(self, trace: Iterable[List[Request]],
            max_steps: Optional[int] = None) -> List[StepStats]:
        """Drive the scheduler over a trace (an iterable of per-step request
        lists, e.g. repro.serving.workload.agentic_trace). Returns the
        StepStats of the steps executed this call.

        islice bounds the pull count exactly: a generator-backed trace is
        never advanced past max_steps items (the old loop peeked one
        extra element before breaking). At pipeline_depth >= 2 each
        scheduled step's successor is planned speculatively while the
        step's device work is in flight, and the pipeline is flushed
        before returning — the trace is still pulled one item at a time,
        after the previous step was scheduled, so generator side effects
        interleave exactly as they do at depth 1."""
        start = len(self.stats)
        it = iter(trace) if max_steps is None \
            else itertools.islice(trace, max_steps)
        if max(1, self.cfg.pipeline_depth) < 2:
            for step_requests in it:
                self.schedule_step(step_requests)
            return self.stats[start:]
        sentinel = object()
        pending = next(it, sentinel)
        while pending is not sentinel:
            self.schedule_step(pending)
            pending = next(it, sentinel)
            if pending is not sentinel:
                self.speculate_step(pending)
        self.flush()
        return self.stats[start:]

    # -- internals -------------------------------------------------------------

    def _busiest_home(self, entries: List[_Pair]) -> int:
        return self._busiest_home_cols([p.rq.home for p in entries],
                                       [p.rq.m_q for p in entries])

    def _busiest_home_cols(self, homes: List[int], m_qs: List[int]) -> int:
        if len(homes) == 1:
            return homes[0]
        by_home: Dict[int, int] = defaultdict(int)
        for h, m in zip(homes, m_qs):
            by_home[h] += m
        return max(by_home, key=by_home.get)

    def _occupancy_k_flows(self, pairs: List[_Pair],
                           group_keys: List[Tuple[int, str, int]],
                           dec: "P.DecisionBatch") -> np.ndarray:
        """Per-pair §8 k_flows from OBSERVED link occupancy: each
        (holder, chunk, fabric) group whose (uncontended) majority vote is a
        transport — ROUTE or FETCH both put wire stages on the link — counts
        as one flow on its (holder, fabric) link; LOCAL groups never touch
        the wire and must not inflate their neighbours' premium."""
        groups: Dict[Tuple[int, str, int], List[int]] = defaultdict(list)
        for i, key in enumerate(group_keys):
            groups[key].append(i)
        flows_per_link: Dict[Tuple[int, int], int] = defaultdict(int)
        for key, idxs in groups.items():
            votes: Dict[int, int] = defaultdict(int)
            for i in idxs:
                votes[int(dec.code[i])] += 1
            if max(votes, key=votes.get) != P.LOCAL_CODE:
                flows_per_link[(key[0], key[2])] += 1
        return np.array(
            [flows_per_link.get((p.holder, p.fabric_idx), 0) for p in pairs],
            np.int64)

    def _spawn_replica(self, cid: str,
                       overflow: List[_Pair]) -> Optional[DispatchRecord]:
        """Amortised FETCH: replicate the chunk onto the requester instance
        with the most overflow demand. None when pool pressure wins."""
        return self._spawn_replica_cols(
            cid, [p.rq.home for p in overflow],
            [p.rq.m_q for p in overflow],
            [p.rq.req_id for p in overflow])

    def _spawn_replica_cols(self, cid: str, homes: List[int],
                            m_qs: List[int],
                            rids: List[int]) -> Optional[DispatchRecord]:
        target = self._busiest_home_cols(homes, m_qs)
        chunk = self.store.lookup(cid)
        fab = self.fabric_between(target, chunk.holder)
        if not self._make_resident(cid, target):
            return None
        return DispatchRecord(
            self.step_idx, target, "fetch_replica", cid, len(homes),
            sum(m_qs),
            cm.t_fetch(fab, chunk.length, self.cfg.payload),
            fabric_idx=self.fabric_idx_between(target, chunk.holder),
            link_instance=chunk.holder, home=target,
            stages=cm.fetch_stages(fab, chunk.length, self.cfg.payload),
            req_ids=tuple(rids))

    # -- faults ---------------------------------------------------------------

    def fail_instance(self, idx: int) -> List[str]:
        # a mid-pipeline fault invalidates any speculative plan (it was
        # planned against the pre-fault world) and drains in-flight steps
        # — their plans predate the fault, and the store mutation below
        # must not race their merge. Both are no-ops at depth 1.
        self._invalidate_speculation()
        self.flush()
        self.instances[idx].alive = False
        return self.store.drop_holder(idx)

    def set_straggler(self, idx: int, slowdown: float):
        self._invalidate_speculation()
        self.flush()
        self.instances[idx].slowdown = slowdown

    # -- metrics ---------------------------------------------------------------

    def step_latency(self, step: int) -> float:
        """Timeline makespan of a past step (0.0 for a fully-resident step
        — see transport_latencies() for why aggregation must skip those).
        Step ids are sequential and 1-based, so this is a direct index."""
        if 1 <= step <= len(self.stats) and self.stats[step - 1].step == step:
            return self.stats[step - 1].latency_s
        return _critical_path([r for r in self.log if r.step == step])

    def timeline_of(self, step: int) -> TL.Timeline:
        """The overlap-aware schedule of a past step (1-based sequential
        step ids, parallel to self.stats)."""
        if 1 <= step <= len(self.timelines) \
                and self.stats[step - 1].step == step:
            return self.timelines[step - 1]
        raise KeyError(f"no timeline recorded for step {step}")

    def outputs_of(self, step: int) -> Dict[int, object]:
        """Exec-backend decode outputs of a past step: req_id -> merged
        Partial ({} under the analytic backend, and {} once the step falls
        out of the cfg.retain_outputs window — outputs hold real arrays,
        so only a bounded history stays live)."""
        if 1 <= step <= len(self.step_outputs) \
                and self.stats[step - 1].step == step:
            return self.step_outputs[step - 1]
        raise KeyError(f"no outputs recorded for step {step}")

    def measured_overview(self) -> Optional[str]:
        """One-line aggregate of the run's measured-vs-analytic reports
        (None when no backend produced any): median/max makespan ratio
        over transporting steps, median overlap efficiency, and the
        committed-copy pool's final population."""
        reps = [r for r in self.measured_reports if r is not None]
        if not reps:
            return None
        ratios = sorted(r.makespan_ratio for r in reps
                        if r.analytic.makespan_s > 0)
        if not ratios:
            return None
        eff = sorted(r.overlap_efficiency for r in reps
                     if r.analytic.makespan_s > 0)
        last = reps[-1]
        return (f"measured/analytic ratio p50 x{ratios[len(ratios)//2]:.1f} "
                f"max x{ratios[-1]:.1f} over {len(ratios)} transporting "
                f"steps ({last.mode}); overlap efficiency p50 "
                f"{eff[len(eff)//2]:.2f}; pool {last.pool_entries} entries/"
                f"{last.pool_bytes}B; {sum(r.stage_fills for r in reps)} "
                f"stage fills")
