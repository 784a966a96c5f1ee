"""The PLAN layer of the serving engine (plan / execute / account).

A decode step flows through three layers:

  plan    — residency resolution, one vectorized decide_batch() over every
            non-resident (request, chunk) pair, per-(holder, chunk, fabric)
            dispatch batching, fan-in capping, fetch persistence. Output: a
            StepPlan — the full transport schedule for the step, expressed
            as DispatchRecords plus the residency telemetry.
  execute — an ExecutionBackend (repro.serving.backends) consumes the plan:
            the AnalyticBackend schedules it on the overlap timeline
            (pure simulation, today's numbers); the JaxExecBackend ALSO
            runs the planned attention on real c^KV arrays and returns the
            decode outputs.
  account — StepStats built from the plan + the executed timeline.

This module holds the data types the three layers share (and the timeline
construction both backends use), so engine and backends can import it
without importing each other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.serving import timeline as TL


@dataclasses.dataclass
class Request:
    req_id: int
    home: int                      # requester instance
    chunk_ids: List[str]
    m_q: int = 1                   # query rows per chunk this step
    expected_reuse_steps: int = 1
    k_selected: Optional[int] = None
    # deterministic seed for this request's query tensor (exec backend);
    # None lets the backend derive one from req_id. The ANALYTIC path never
    # reads it, so traces stay backend-agnostic.
    query_seed: Optional[int] = None


@dataclasses.dataclass
class DispatchRecord:
    step: int
    holder: int
    primitive: str
    chunk_id: str
    n_requesters: int
    m_q_total: int
    est_cost_s: float
    backup: bool = False
    # timeline inputs: which wire the dispatch occupies (link_instance < 0
    # means no wire — LOCAL), the requester-side instance for merge/splice,
    # and the §4 per-stage breakdown the est_cost_s sums over
    fabric_idx: int = -1
    link_instance: int = -1
    home: int = -1
    stages: cm.StageList = ()
    # the requests batched into this dispatch (plan -> execute handoff: the
    # exec backend stacks their query tensors into one holder-side partial)
    req_ids: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class ResidentPair:
    """A (request, chunk) access served by local attention — no transport,
    so no DispatchRecord; the exec backend still computes its partial."""
    req_id: int
    chunk_id: str
    instance: int


@dataclasses.dataclass
class StepPlan:
    """One planned decode step: every transport as a DispatchRecord, every
    free local access as a ResidentPair, plus the planning telemetry the
    account layer folds into StepStats. Planning COMMITS residency (fetch
    persistence, replica spawns, LRU evictions) — execution replays the
    already-decided schedule, it never re-plans.

    `records` is LAZY when the plan carries its columnar form: the array
    planner passes records=None and the DispatchRecord objects are
    materialized from `arrays` on first access (telemetry / logging), off
    the scheduler's timed critical path. The object planner still passes
    them eagerly — for it the records ARE the plan."""
    step: int
    requests: List[Request]
    records: dataclasses.InitVar[Optional[List[DispatchRecord]]]
    resident_pairs: List[ResidentPair]
    n_pairs: int                   # (request, chunk) accesses resolved
    n_priced: int                  # pairs that reached decide_batch
    n_resident: int                # served by local attention, no transport
    replicas_spawned: int = 0
    evictions: int = 0
    # selection regime: the indexer's per-request verdicts
    # (req_id -> RequestSelection, repro.serving.selection.types) — the
    # plan->execute handoff of the §5.4 masks; empty when no selector ran
    selections: Dict[int, object] = dataclasses.field(default_factory=dict)
    # requests that carried k_selected but had NO selector to run: priced
    # as selection, executed dense — counted so the regimes cannot diverge
    # silently (the engine also warns once)
    selection_fallbacks: int = 0
    # the columnar form of `records`, set by the array planner.
    # When present it is authoritative for the hot path (the analytic
    # backend schedules straight from it); `records` is materialized from
    # it and stays the cross-backend / telemetry contract.
    arrays: Optional["StepPlanArrays"] = None

    def __post_init__(self, records: Optional[List[DispatchRecord]]):
        self._records = records


def _steplan_records(self: "StepPlan") -> List["DispatchRecord"]:
    if self._records is None:
        self._records = self.arrays.to_records()
    return self._records


# attached after class creation: a plain `records` property in the class
# body would be mistaken for the InitVar's default by @dataclass
StepPlan.records = property(_steplan_records)


@dataclasses.dataclass
class StepStats:
    """Per-step scheduler telemetry (the benchmark's raw material)."""
    step: int
    n_requests: int
    n_pairs: int                   # (request, chunk) accesses resolved
    n_priced: int                  # pairs that reached decide_batch
    n_resident: int                # served by local attention, no transport
    n_dispatches: int              # primary dispatches issued
    primitives: Dict[str, int]
    latency_s: float               # makespan of the step's transport timeline
    sched_wall_s: float            # scheduler wall-clock for this step
    replicas_spawned: int = 0
    evictions: int = 0
    # timeline telemetry: the old independent max-reduce price (what the engine
    # reported as latency), the serial sum of every stage, and the summed
    # duration per stage name
    max_dispatch_s: float = 0.0
    serial_stage_s: float = 0.0
    stage_totals: Dict[str, float] = dataclasses.field(default_factory=dict)
    # selection regime: pairs served under an ACTIVE indexer
    # selection this step, and requests that were priced as selection but
    # executed dense because no selector was configured (warn-once +
    # recorded here, so the divergence is always visible in telemetry)
    n_selected: int = 0
    selection_fallbacks: int = 0

    def comparable(self) -> Dict[str, object]:
        """Everything deterministic about the step: the full dataclass
        minus sched_wall_s (host wall clock — the one field that may
        legitimately differ between two runs of the same plan). A/B
        identity checks (pipelined vs lockstep, obs on vs off) compare
        this dict."""
        d = dataclasses.asdict(self)
        d.pop("sched_wall_s")
        return d

    @property
    def decisions_per_sec(self) -> float:
        """Predicate evaluations per wall-clock second (resident pairs skip
        the predicate and are excluded)."""
        return self.n_priced / self.sched_wall_s if self.sched_wall_s else 0.0

    @property
    def has_transport(self) -> bool:
        """False for a fully-resident step: nothing was scheduled, so the
        0.0 makespan is not a latency any request experienced."""
        return self.n_dispatches > 0

    @property
    def overlap_efficiency(self) -> float:
        """makespan / sum-of-stages (1.0 = fully serial, 1/n = n flows
        perfectly overlapped; 1.0 for an empty step)."""
        return (self.latency_s / self.serial_stage_s
                if self.serial_stage_s > 0 else 1.0)


def transport_latencies(stats: Iterable[StepStats]) -> np.ndarray:
    """Latencies of the steps that actually dispatched work. Fully-resident
    steps have an empty schedule (latency 0.0); including them would deflate
    p50/p99 with zeros nobody waited for — aggregation must skip them."""
    return np.array([s.latency_s for s in stats if s.has_transport],
                    np.float64)


def _backup_of(records: List["DispatchRecord"],
               i: int) -> Optional["DispatchRecord"]:
    """The straggler backup shadowing records[i], if any. The planner
    emits a backup IMMEDIATELY after its primary, so adjacency — not
    chunk_id alone — is the association: two fabric groups of one chunk
    each carry their own backup and must not cap each other."""
    nxt = i + 1
    if nxt < len(records) and records[nxt].backup \
            and records[nxt].chunk_id == records[i].chunk_id:
        return records[nxt]
    return None


def _critical_path(records: List["DispatchRecord"]) -> float:
    """Independent max-reduce price of one step's records: max over primary
    dispatches, where a backup caps its own primary's contribution. Once
    this WAS the step latency; it is kept as StepStats.max_dispatch_s —
    the no-contention floor the timeline makespan is compared against."""
    worst = 0.0
    for i, r in enumerate(records):
        if r.backup:
            continue
        cost = r.est_cost_s
        b = _backup_of(records, i)
        if b is not None:
            cost = min(cost, b.est_cost_s)
        worst = max(worst, cost)
    return worst


# ---------------------------------------------------------------------------
# Columnar plan: the step's records as flat numpy columns.
# ---------------------------------------------------------------------------

PRIM_NAMES: Tuple[str, ...] = ("route", "fetch", "local", "fetch_replica")
PRIM_CODE: Dict[str, int] = {n: i for i, n in enumerate(PRIM_NAMES)}

# flow resource ids, packed per instance: slot 0 = the instance's SM,
# slots 2 + fabric_idx = its (link, fabric) wires (fabric_idx in {0, 1})
_RES_SLOTS = 4


_RES_MEMO: dict = {}


def _decode_res(code: int) -> TL.Resource:
    r = _RES_MEMO.get(code)
    if r is None:
        inst, slot = divmod(code, _RES_SLOTS)
        r = TL.sm(inst) if slot == 0 else TL.link(inst, slot - 2)
        _RES_MEMO[code] = r
    return r


@dataclasses.dataclass
class StepPlanArrays:
    """One step's DispatchRecords as struct-of-arrays: fixed-width record
    columns plus two ragged columns (per-record stage chains and batched
    req_ids). chunk ids are interned in `chunk_ids`; stage names in
    timeline.STAGE_NAMES. to_records() round-trips to the object form
    exactly (tests/test_plan_arrays.py pins it on the golden traces)."""
    step: int
    chunk_ids: Tuple[str, ...]           # intern table for `chunk`
    prim: np.ndarray                     # (R,) int64 PRIM_NAMES code
    holder: np.ndarray                   # (R,) int64
    chunk: np.ndarray                    # (R,) int64 -> chunk_ids
    n_requesters: np.ndarray             # (R,) int64
    m_q_total: np.ndarray                # (R,) int64
    est_cost_s: np.ndarray               # (R,) float64
    backup: np.ndarray                   # (R,) bool
    fabric_idx: np.ndarray               # (R,) int64, -1 = no wire
    link_instance: np.ndarray            # (R,) int64, -1 = no wire
    home: np.ndarray                     # (R,) int64, -1 = unset
    stage_off: np.ndarray                # (R+1,) int64 ragged bounds
    stage_code: np.ndarray               # (S,) int64 timeline.STAGE_NAMES
    stage_dur: np.ndarray                # (S,) float64
    req_off: np.ndarray                  # (R+1,) int64 ragged bounds
    req_ids: np.ndarray                  # (Q,) int64 batched request ids

    @property
    def n_records(self) -> int:
        return int(self.prim.shape[0])

    @classmethod
    def from_records(cls, step: int,
                     records: List["DispatchRecord"]) -> "StepPlanArrays":
        """Columnarize object records (conversion path — tests and the
        round-trip contract; the array planner builds columns directly)."""
        cid_index: Dict[str, int] = {}
        stage_off, stage_code, stage_dur = [0], [], []
        req_off, req_ids = [0], []
        cols = ([], [], [], [], [], [], [], [], [], [])
        for r in records:
            cols[0].append(PRIM_CODE[r.primitive])
            cols[1].append(r.holder)
            cols[2].append(cid_index.setdefault(r.chunk_id, len(cid_index)))
            cols[3].append(r.n_requesters)
            cols[4].append(r.m_q_total)
            cols[5].append(r.est_cost_s)
            cols[6].append(r.backup)
            cols[7].append(r.fabric_idx)
            cols[8].append(r.link_instance)
            cols[9].append(r.home)
            for name, dur in r.stages:
                stage_code.append(TL.STAGE_CODE[name])
                stage_dur.append(dur)
            stage_off.append(len(stage_code))
            req_ids.extend(r.req_ids)
            req_off.append(len(req_ids))
        return cls(
            step=step, chunk_ids=tuple(cid_index),
            prim=np.asarray(cols[0], np.int64),
            holder=np.asarray(cols[1], np.int64),
            chunk=np.asarray(cols[2], np.int64),
            n_requesters=np.asarray(cols[3], np.int64),
            m_q_total=np.asarray(cols[4], np.int64),
            est_cost_s=np.asarray(cols[5], np.float64),
            backup=np.asarray(cols[6], bool),
            fabric_idx=np.asarray(cols[7], np.int64),
            link_instance=np.asarray(cols[8], np.int64),
            home=np.asarray(cols[9], np.int64),
            stage_off=np.asarray(stage_off, np.int64),
            stage_code=np.asarray(stage_code, np.int64),
            stage_dur=np.asarray(stage_dur, np.float64),
            req_off=np.asarray(req_off, np.int64),
            req_ids=np.asarray(req_ids, np.int64))

    def to_records(self) -> List[DispatchRecord]:
        """Materialize object DispatchRecords (the telemetry / exec-backend
        contract). Values round-trip bitwise: columns never re-derive.
        Every column is pulled down with .tolist() once (native Python
        scalars, same bits as item-wise int()/float()) so the per-record
        work is pure slicing."""
        so = self.stage_off.tolist()
        pairs = list(zip((TL.STAGE_NAMES[c] for c in self.stage_code.tolist()),
                         self.stage_dur.tolist()))
        ro = self.req_off.tolist()
        rid = self.req_ids.tolist()
        prim = [PRIM_NAMES[c] for c in self.prim.tolist()]
        cid = [self.chunk_ids[c] for c in self.chunk.tolist()]
        holder, nreq = self.holder.tolist(), self.n_requesters.tolist()
        mqt, est = self.m_q_total.tolist(), self.est_cost_s.tolist()
        backup, fi = self.backup.tolist(), self.fabric_idx.tolist()
        link, home = self.link_instance.tolist(), self.home.tolist()
        step = self.step
        return [
            DispatchRecord(
                step, holder[i], prim[i], cid[i], nreq[i], mqt[i], est[i],
                backup=backup[i], fabric_idx=fi[i], link_instance=link[i],
                home=home[i], stages=tuple(pairs[so[i]:so[i + 1]]),
                req_ids=tuple(rid[ro[i]:ro[i + 1]]))
            for i in range(self.n_records)]

    def _effective(self):
        """Primary record ids + the effective record serving each (its
        adjacent backup when that is cheaper — build_timeline's rule)."""
        R = self.n_records
        primary = np.nonzero(~self.backup)[0]
        if primary.size == 0:
            return primary, primary, np.zeros(0, bool)
        nxt = np.minimum(primary + 1, R - 1)
        shadowed = ((primary + 1 < R) & self.backup[nxt]
                    & (self.chunk[nxt] == self.chunk[primary]))
        eff = np.where(shadowed & (self.est_cost_s[nxt]
                                   < self.est_cost_s[primary]), nxt, primary)
        return primary, eff, shadowed

    def critical_path_s(self) -> float:
        """_critical_path over the columns: max over primaries, a backup
        capping its own primary."""
        primary, _, shadowed = self._effective()
        if primary.size == 0:
            return 0.0
        R = self.n_records
        nxt = np.minimum(primary + 1, R - 1)
        cost = np.where(shadowed,
                        np.minimum(self.est_cost_s[primary],
                                   self.est_cost_s[nxt]),
                        self.est_cost_s[primary])
        return max(0.0, float(cost.max()))

    def flow_arrays(self) -> TL.FlowArrays:
        """The step's flow set for timeline.simulate_arrays — the columnar
        image of build_timeline(): one flow per primary record (its backup
        substituted when cheaper), wire stages bound to the record's
        (link_instance, fabric) resource, compute to the holder's SM, the
        rest to the requester's. Memoized per instance (columns are never
        mutated); the planner's step-replay cache forwards the memo so a
        repeated step skips the rebuild too."""
        fa = getattr(self, "_fa_memo", None)
        if fa is not None:
            return fa
        counts = np.diff(self.stage_off)
        if self.n_records and not self.backup.any() and counts.all():
            # fast path (the steady state: no straggler backups, every
            # record carries stages): flows ARE the records in order, so
            # the stage table is reused as-is — no gather, no compaction
            primary = eff = None
            F = self.n_records
            offsets = self.stage_off
            code = self.stage_code
            dur = self.stage_dur
            link_inst, fab = self.link_instance, self.fabric_idx
            hold, home = self.holder, self.home
        else:
            primary, eff, _ = self._effective()
            counts = self.stage_off[eff + 1] - self.stage_off[eff]
            keep = counts > 0
            primary, eff, counts = primary[keep], eff[keep], counts[keep]
            F = eff.shape[0]
            offsets = np.zeros(F + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            # ragged gather of the effective records' stage rows
            flat = np.repeat(self.stage_off[eff] - offsets[:-1], counts) \
                + np.arange(offsets[-1])
            code = self.stage_code[flat]
            dur = self.stage_dur[flat]
            link_inst, fab = self.link_instance[eff], self.fabric_idx[eff]
            hold, home = self.holder[eff], self.home[eff]
        # per-flow resource codes (packed ints), then per-stage by class
        link_code = np.where(link_inst >= 0,
                             link_inst * _RES_SLOTS + 2 + fab, -1)
        holder_code = hold * _RES_SLOTS
        req_code = np.where(home >= 0, home, hold) * _RES_SLOTS
        fl = np.repeat(np.arange(F), counts)
        wire = TL.WIRE_CODE_MASK[code]
        holdm = TL.HOLDER_CODE_MASK[code]
        res_packed = np.where(wire, link_code[fl],
                              np.where(holdm, holder_code[fl], req_code[fl]))
        bound = res_packed >= 0
        uniq = np.unique(res_packed[bound])
        res = np.where(bound, np.searchsorted(uniq, res_packed), -1)

        def _meta() -> tuple:
            # reporting-only strings, built on first access (FlowArrays
            # materializes them lazily — the scheduler never reads them)
            e = np.arange(self.n_records) if eff is None else eff
            p = e if primary is None else primary
            prim_s = [PRIM_NAMES[c] for c in self.prim[e]]
            cid_s = [self.chunk_ids[c] for c in self.chunk[e]]
            keys = tuple(
                f"{pp}:{c}@{h}#{i}" for pp, c, h, i in
                zip(prim_s, cid_s, self.holder[e].tolist(), p.tolist()))
            return keys, tuple(prim_s), tuple(cid_s)

        fa = TL.FlowArrays(
            offsets=offsets, code=code, dur=dur, res=res,
            resources=tuple(_decode_res(int(c)) for c in uniq),
            meta_builder=_meta)
        self._fa_memo = fa
        return fa


def build_timeline(records: List["DispatchRecord"]) -> TL.Timeline:
    """One step's dispatch records as an overlap-aware schedule.

    A straggler backup replaces its own primary (adjacent record) when it
    is the cheaper path (the engine cancels the primary at the p99
    deadline — modeled as the faster of the two serving the chunk),
    mirroring _critical_path's min. Wire stages bind to the dispatch's
    (link_instance, fabric) resource, compute to the holder's SM,
    merge/splice/prefill to the requester's."""
    flows: List[TL.Flow] = []
    for i, r in enumerate(records):
        if r.backup:
            continue
        b = _backup_of(records, i)
        eff = b if b is not None and b.est_cost_s < r.est_cost_s else r
        if not eff.stages:
            continue
        link_res = (TL.link(eff.link_instance, eff.fabric_idx)
                    if eff.link_instance >= 0 else None)
        requester = eff.home if eff.home >= 0 else eff.holder
        flows.append(TL.transport_flow(
            f"{eff.primitive}:{eff.chunk_id}@{eff.holder}#{i}",
            eff.stages, link_res=link_res,
            holder_sm=TL.sm(eff.holder), requester_sm=TL.sm(requester),
            primitive=eff.primitive, chunk_id=eff.chunk_id))
    return TL.simulate(flows)
