"""Overlap-aware transport timeline for one decode step.

The cost model prices a dispatch as probe / transfer / compute / return /
merge stages (§4); a real NIC overlaps those stages ACROSS concurrent
flows while serializing the wire itself. The max-reduce the engine used
earlier prices each dispatch independently and takes the max, which
makes fabric sharing invisible: four flows on one link cost the same as
one. This module is the event simulator that replaces it:

  * every dispatch becomes a Flow — an ordered list of Stages;
  * a wire stage (probe / transfer / return / pull / gather / index) occupies the
    flow's ("link", instance, fabric) resource EXCLUSIVELY: two flows never
    overlap on the same link — queueing is simulated, not priced (§8);
  * a compute stage occupies the holder's ("sm", instance) resource, so
    holder-side compute is charged per-instance occupancy (the §6.3 elbow's
    other half: a busy holder serializes its chunk groups);
  * requester-side stages (merge / splice / prefill / host) occupy the
    requester's SM;
  * stages of DIFFERENT flows on DIFFERENT resources overlap freely — the
    probe of flow B rides under the transfer of flow A.

simulate() runs greedy earliest-start list scheduling (deterministic:
ties break toward the earlier flow), which is work-conserving, so the
makespan is bracketed by

    max(flow serial time)  <=  makespan  <=  sum(all stage durations)

and a single flow's makespan IS the scalar cost-model price (the stage
durations come from cost_model.route_stages/fetch_stages/local_stages,
which sum to the closed forms exactly). tests/test_timeline.py and
tests/test_timeline_props.py pin these invariants down.

overlap_efficiency = makespan / sum-of-stages: 1.0 means the schedule is
fully serial (no overlap harvested); 1/n means n flows overlapped
perfectly. Lower is better.

The hot path is ARRAY-based: FlowArrays is the columnar
flow set (flat stage columns + ragged per-flow offsets), and
simulate_arrays() runs the SAME greedy earliest-start policy as an
event loop over a lazy-reevaluation heap — one candidate per flow keyed
by a lower-bound start estimate, refreshed on pop when stale. Ties pop
the smaller flow index first, exactly the object scheduler's scan
order, so the two schedules are identical stage-for-stage for all
non-negative durations (tests/test_plan_arrays.py asserts bit-equality
on randomized flow sets, zero durations included); negative durations —
never emitted by the cost model — fall back to the object oracle.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# ("link", instance, fabric_idx) — the shared wire anchored at an instance
# ("sm", instance, 0)            — an instance's compute occupancy
Resource = Tuple[str, int, int]

WIRE_STAGES = frozenset({"probe", "transfer", "return", "pull", "gather",
                         "index"})
HOLDER_STAGES = frozenset({"compute"})
# merge / splice / prefill / host (and anything unknown) land requester-side

# Stage-name interning for the array scheduler: every stage the
# cost model emits, by a stable small-int code. FlowArrays carries codes,
# not strings; names reappear only at the reporting boundary
# (stage_totals / gantt).
STAGE_NAMES: Tuple[str, ...] = (
    "probe", "transfer", "compute", "return", "merge", "host",
    "pull", "splice", "gather", "index", "prefill")
STAGE_CODE: Dict[str, int] = {n: i for i, n in enumerate(STAGE_NAMES)}
# per-code resource class, aligned with the frozensets above
WIRE_CODE_MASK = np.array([n in WIRE_STAGES for n in STAGE_NAMES])
HOLDER_CODE_MASK = np.array([n in HOLDER_STAGES for n in STAGE_NAMES])


def link(instance: int, fabric_idx: int) -> Resource:
    """The (link, fabric) wire resource anchored at `instance` (§8: the
    holder's NIC is what concurrent flows subscribe)."""
    return ("link", instance, fabric_idx)


def sm(instance: int) -> Resource:
    """An instance's compute-occupancy resource."""
    return ("sm", instance, 0)


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    duration_s: float
    resource: Optional[Resource] = None   # None: no shared resource


@dataclasses.dataclass(frozen=True)
class Flow:
    """One dispatch as an ordered stage chain (stages run sequentially
    within a flow; overlap happens only across flows)."""
    key: str
    stages: Tuple[Stage, ...]
    primitive: str = ""
    chunk_id: str = ""

    @property
    def serial_s(self) -> float:
        """The flow's independent (no-contention) price: what the old
        max-reduce charged it."""
        return sum(s.duration_s for s in self.stages)


def transport_flow(key: str, stages: Sequence[Tuple[str, float]], *,
                   link_res: Optional[Resource] = None,
                   holder_sm: Optional[Resource] = None,
                   requester_sm: Optional[Resource] = None,
                   primitive: str = "", chunk_id: str = "") -> Flow:
    """Build a Flow from a cost_model stage breakdown ((name, seconds)
    pairs), binding each stage to the wire / holder-SM / requester-SM
    resource by stage-name class."""
    bound: List[Stage] = []
    for name, dur in stages:
        if name in WIRE_STAGES:
            res = link_res
        elif name in HOLDER_STAGES:
            res = holder_sm
        else:
            res = requester_sm
        bound.append(Stage(name, float(dur), res))
    return Flow(key, tuple(bound), primitive, chunk_id)


@dataclasses.dataclass(frozen=True)
class ScheduledStage:
    flow_key: str
    stage: str
    resource: Optional[Resource]
    start_s: float
    end_s: float

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s


@dataclasses.dataclass
class Timeline:
    """One step's schedule: where every stage landed, and the makespan.

    The schedule is immutable once simulate() returns it; the per-flow and
    per-resource aggregates below are computed in ONE pass over `scheduled`
    on first use and memoized (flow_end_s /
    link_flow_counts used to rescan every stage per call — O(n^2) across a
    step report)."""
    flows: Tuple[Flow, ...]
    scheduled: List[ScheduledStage]
    makespan_s: float
    serial_s: float                    # sum of every stage duration
    _agg: Optional[dict] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def _aggregates(self) -> dict:
        if self._agg is None:
            busy: Dict[Resource, float] = defaultdict(float)
            seen: Dict[Resource, set] = defaultdict(set)
            totals: Dict[str, float] = defaultdict(float)
            ends: Dict[str, float] = {}
            for s in self.scheduled:
                totals[s.stage] += s.duration_s
                if s.end_s > ends.get(s.flow_key, 0.0):
                    ends[s.flow_key] = s.end_s
                if s.resource is not None:
                    busy[s.resource] += s.duration_s
                    if s.resource[0] == "link":
                        seen[s.resource].add(s.flow_key)
            self._agg = {
                "busy": dict(busy),
                "link_counts": {r: len(ks) for r, ks in seen.items()},
                "stage_totals": dict(totals),
                "flow_ends": ends,
            }
        return self._agg

    @property
    def overlap_efficiency(self) -> float:
        """makespan / sum-of-stages; 1.0 = fully serial, 1/n = n flows
        perfectly overlapped. 1.0 for an empty timeline."""
        return self.makespan_s / self.serial_s if self.serial_s > 0 else 1.0

    @property
    def max_flow_serial_s(self) -> float:
        """The old max-reduce price of this flow set."""
        return max((f.serial_s for f in self.flows), default=0.0)

    def busy_s(self) -> Dict[Resource, float]:
        """Total occupied seconds per shared resource."""
        return dict(self._aggregates()["busy"])

    def link_flow_counts(self) -> Dict[Resource, int]:
        """Distinct flows that touched each (link, fabric) resource — the
        OBSERVED per-link subscription the §8 k_flows premium models."""
        return dict(self._aggregates()["link_counts"])

    def utilization(self, resource: Resource) -> float:
        """Busy fraction of one resource over the makespan."""
        if self.makespan_s <= 0:
            return 0.0
        return self._aggregates()["busy"].get(resource, 0.0) / self.makespan_s

    def stage_totals(self) -> Dict[str, float]:
        """Summed duration per stage name (the step's cost anatomy)."""
        return dict(self._aggregates()["stage_totals"])

    def flow_end_s(self, key: str) -> float:
        return self._aggregates()["flow_ends"].get(key, 0.0)

    def gantt(self, max_flows: int = 12) -> str:
        """Per-flow stage spans in microseconds, earliest flow first."""
        by_flow: Dict[str, List[ScheduledStage]] = defaultdict(list)
        for s in self.scheduled:
            by_flow[s.flow_key].append(s)
        rows = sorted(by_flow.items(),
                      key=lambda kv: min(s.start_s for s in kv[1]))
        lines = []
        for key, stages in rows[:max_flows]:
            spans = " ".join(
                f"{s.stage}[{s.start_s * 1e6:.0f}-{s.end_s * 1e6:.0f}us]"
                for s in sorted(stages, key=lambda s: s.start_s))
            lines.append(f"  {key:<32} {spans}")
        if len(rows) > max_flows:
            lines.append(f"  ... {len(rows) - max_flows} more flows")
        return "\n".join(lines)


def simulate(flows: Sequence[Flow]) -> Timeline:
    """Greedy earliest-start list scheduling over capacity-1 resources.

    Repeatedly schedules the ready stage (its flow's predecessors done)
    with the earliest feasible start = max(flow ready, resource free);
    ties break toward the earlier flow in input order, so the schedule is
    deterministic. Work-conserving: the machine is never idle while a
    stage could run, which gives makespan <= sum of all durations."""
    flows = tuple(flows)
    nxt = [0] * len(flows)                 # next stage index per flow
    ready = [0.0] * len(flows)             # flow's predecessor finish time
    free: Dict[Resource, float] = defaultdict(float)
    scheduled: List[ScheduledStage] = []
    remaining = sum(len(f.stages) for f in flows)
    serial = sum(f.serial_s for f in flows)
    makespan = 0.0
    while remaining:
        best_i, best_start = -1, None
        for i, f in enumerate(flows):
            if nxt[i] >= len(f.stages):
                continue
            st = f.stages[nxt[i]]
            start = (ready[i] if st.resource is None
                     else max(ready[i], free[st.resource]))
            if best_start is None or start < best_start:
                best_i, best_start = i, start
        f = flows[best_i]
        st = f.stages[nxt[best_i]]
        end = best_start + st.duration_s
        scheduled.append(ScheduledStage(f.key, st.name, st.resource,
                                        best_start, end))
        ready[best_i] = end
        if st.resource is not None:
            free[st.resource] = end
        nxt[best_i] += 1
        remaining -= 1
        makespan = max(makespan, end)
    return Timeline(flows, scheduled, makespan, serial)


# ---------------------------------------------------------------------------
# Array scheduler: the same greedy policy, vectorized.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FlowArrays:
    """Columnar flow set: one flat stage table (code / duration / resource
    id) plus ragged per-flow offsets. Resource ids index `resources`
    (-1 = no shared resource); flow order is schedule-tie order, exactly as
    a Flow sequence's input order is for simulate().

    keys / primitives / chunk_ids are reporting-only strings the scheduler
    never reads; a builder may defer them via `meta_builder` — a zero-arg
    callable returning the (keys, primitives, chunk_ids) triple — so the
    hot path skips string construction entirely (they materialize on
    first access)."""
    offsets: np.ndarray                  # (F+1,) int64 stage ranges
    code: np.ndarray                     # (S,) int64 STAGE_NAMES index
    dur: np.ndarray                      # (S,) float64 stage durations
    res: np.ndarray                      # (S,) int64 -> resources, -1 none
    resources: Tuple[Resource, ...]
    keys: dataclasses.InitVar[Optional[Tuple[str, ...]]] = None
    primitives: dataclasses.InitVar[Tuple[str, ...]] = ()
    chunk_ids: dataclasses.InitVar[Tuple[str, ...]] = ()
    meta_builder: Optional[Callable[[], tuple]] = None

    def __post_init__(self, keys, primitives, chunk_ids):
        self._keys = keys
        self._primitives = primitives
        self._chunk_ids = chunk_ids

    def _meta(self) -> None:
        self._keys, self._primitives, self._chunk_ids = self.meta_builder()

    @property
    def n_flows(self) -> int:
        return len(self.offsets) - 1

    def flow_of_stage(self) -> np.ndarray:
        """(S,) flow index per flat stage."""
        return np.repeat(np.arange(self.n_flows), np.diff(self.offsets))

    @classmethod
    def from_flows(cls, flows: Sequence[Flow]) -> "FlowArrays":
        flows = tuple(flows)
        res_index: Dict[Resource, int] = {}
        offsets = [0]
        code: List[int] = []
        dur: List[float] = []
        res: List[int] = []
        for f in flows:
            for s in f.stages:
                code.append(STAGE_CODE[s.name])
                dur.append(s.duration_s)
                if s.resource is None:
                    res.append(-1)
                else:
                    res.append(res_index.setdefault(s.resource,
                                                    len(res_index)))
            offsets.append(len(code))
        return cls(
            offsets=np.asarray(offsets, np.int64),
            code=np.asarray(code, np.int64),
            dur=np.asarray(dur, np.float64),
            res=np.asarray(res, np.int64),
            resources=tuple(res_index),
            keys=tuple(f.key for f in flows),
            primitives=tuple(f.primitive for f in flows),
            chunk_ids=tuple(f.chunk_id for f in flows))

    def to_flows(self) -> Tuple[Flow, ...]:
        """Object flows (the oracle scheduler's input form)."""
        prims = self.primitives or ("",) * self.n_flows
        cids = self.chunk_ids or ("",) * self.n_flows
        flows = []
        for i in range(self.n_flows):
            lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
            stages = tuple(
                Stage(STAGE_NAMES[int(self.code[j])], float(self.dur[j]),
                      None if self.res[j] < 0
                      else self.resources[int(self.res[j])])
                for j in range(lo, hi))
            flows.append(Flow(self.keys[i], stages, prims[i], cids[i]))
        return tuple(flows)


def _fa_keys(self: "FlowArrays") -> Tuple[str, ...]:
    if self._keys is None and self.meta_builder is not None:
        self._meta()
    return self._keys


def _fa_primitives(self: "FlowArrays") -> Tuple[str, ...]:
    if self._keys is None and self.meta_builder is not None:
        self._meta()
    return self._primitives


def _fa_chunk_ids(self: "FlowArrays") -> Tuple[str, ...]:
    if self._keys is None and self.meta_builder is not None:
        self._meta()
    return self._chunk_ids


# attached after class creation: plain properties in the class body would
# be mistaken for the InitVar defaults by @dataclass (same pattern as
# StepPlan.records in serving/plan.py)
FlowArrays.keys = property(_fa_keys)
FlowArrays.primitives = property(_fa_primitives)
FlowArrays.chunk_ids = property(_fa_chunk_ids)


@dataclasses.dataclass
class ArrayTimeline:
    """simulate_arrays()' result: the same schedule simulate() produces,
    kept columnar. Duck-types Timeline's reporting surface (makespan_s,
    serial_s, stage_totals, busy_s, link_flow_counts, flow_end_s,
    utilization, overlap_efficiency, max_flow_serial_s, gantt); aggregates
    are computed once from the arrays at construction."""
    arrays: FlowArrays
    start_s: np.ndarray                  # (S,) per flat stage
    end_s: np.ndarray
    order: np.ndarray                    # flat stage ids, schedule order
    makespan_s: float
    serial_s: float
    _stage_totals: Dict[str, float]
    _busy: Dict[Resource, float]
    _link_counts: Dict[Resource, int]
    _flow_serial: np.ndarray             # (F,) per-flow serial price
    _flow_end: np.ndarray                # (F,) per-flow finish time
    _key_index: Optional[Dict[str, int]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _flows: Optional[Tuple[Flow, ...]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _scheduled: Optional[List[ScheduledStage]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def flows(self) -> Tuple[Flow, ...]:
        """Object-form flows, materialized on demand (inspection surface —
        the hot path never touches this)."""
        if self._flows is None:
            self._flows = tuple(self.arrays.to_flows())
        return self._flows

    @property
    def scheduled(self) -> List[ScheduledStage]:
        """Object-form schedule in scheduled order, materialized on demand
        (matches Timeline.scheduled entry-for-entry)."""
        if self._scheduled is None:
            fa = self.arrays
            flow_of = fa.flow_of_stage()
            res = fa.res
            self._scheduled = [
                ScheduledStage(
                    fa.keys[int(flow_of[j])], STAGE_NAMES[int(fa.code[j])],
                    fa.resources[res[j]] if res[j] >= 0 else None,
                    float(self.start_s[j]), float(self.end_s[j]))
                for j in self.order.tolist()]
        return self._scheduled

    @property
    def overlap_efficiency(self) -> float:
        return self.makespan_s / self.serial_s if self.serial_s > 0 else 1.0

    @property
    def max_flow_serial_s(self) -> float:
        return float(self._flow_serial.max()) if self._flow_serial.size \
            else 0.0

    def busy_s(self) -> Dict[Resource, float]:
        return dict(self._busy)

    def link_flow_counts(self) -> Dict[Resource, int]:
        return dict(self._link_counts)

    def utilization(self, resource: Resource) -> float:
        if self.makespan_s <= 0:
            return 0.0
        return self._busy.get(resource, 0.0) / self.makespan_s

    def stage_totals(self) -> Dict[str, float]:
        return dict(self._stage_totals)

    def flow_end_s(self, key: str) -> float:
        if self._key_index is None:
            self._key_index = {k: i for i, k in enumerate(self.arrays.keys)}
        i = self._key_index.get(key)
        return float(self._flow_end[i]) if i is not None else 0.0

    def gantt(self, max_flows: int = 12) -> str:
        """Per-flow stage spans in microseconds, earliest flow first
        (matches Timeline.gantt — stages within a flow are sequential, so
        flat order is start order)."""
        fa = self.arrays
        rows = sorted(
            (i for i in range(fa.n_flows)
             if fa.offsets[i] < fa.offsets[i + 1]),
            key=lambda i: float(self.start_s[fa.offsets[i]]))
        lines = []
        for i in rows[:max_flows]:
            spans = " ".join(
                f"{STAGE_NAMES[int(fa.code[j])]}"
                f"[{self.start_s[j] * 1e6:.0f}-{self.end_s[j] * 1e6:.0f}us]"
                for j in range(int(fa.offsets[i]), int(fa.offsets[i + 1])))
            lines.append(f"  {fa.keys[i]:<32} {spans}")
        if len(rows) > max_flows:
            lines.append(f"  ... {len(rows) - max_flows} more flows")
        return "\n".join(lines)


def _seq_sum(values: np.ndarray) -> float:
    """Left-to-right float64 sum — the accumulation order Python's sum()
    uses. np.sum pairwise-reduces, which rounds DIFFERENTLY; bit-parity
    with the object oracle needs the sequential order."""
    acc = np.zeros(1, np.float64)
    np.add.at(acc, np.zeros(len(values), np.intp), values)
    return float(acc[0])


# schedule memo: simulate_arrays is a pure function of the flow STRUCTURE
# (offsets / durations / resource binding / stage codes) — requester
# identity lives only in the lazy metadata, so steady-state steps whose
# transports repeat bit-for-bit (same groups, same durations) reuse the
# computed schedule outright. The fingerprint covers every input the
# scheduler reads, so a hit is exact by construction.
_SIM_MEMO: Dict[tuple, tuple] = {}
_SIM_MEMO_CAP = 512

# schedule-memo effectiveness counters: module-global like the
# memo itself. inst_hit = the planner handed back the SAME FlowArrays
# object (step replay), memo_hit = structure-fingerprint hit, miss = the
# heap scheduler actually ran. Published via the obs metrics registry.
_SIM_STATS = {"inst_hit": 0, "memo_hit": 0, "miss": 0}


def sim_memo_stats() -> Dict[str, int]:
    """Snapshot of the _SIM_MEMO hit/miss counters."""
    return dict(_SIM_STATS)


# ---------------------------------------------------------------------------
# Measured-vs-analytic report: the shard_map exec backend records
# WALL-CLOCK per-stage durations for every dispatch it executes on the real
# device mesh; re-scheduling those measured flows through the same greedy
# simulator yields a measured timeline directly comparable to the analytic
# one — the paper's §7 model-validation loop, in-repo and continuous.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeasuredReport:
    """One step's measured-vs-analytic comparison.

    analytic — the schedule the cost model priced (fabric constants of the
        PLANNED hardware: probe floors, link bandwidths, HBM sweeps);
    measured — the SAME flow structure (keys, resource binding, stage
        order) re-simulated with per-stage wall-clock durations recorded
        around the real collectives. Absolute ratios are only meaningful
        when the fabric table was calibrated for the executing hardware
        (benchmarks/calibrate_fabric.py); on forced host devices the value
        of the report is the SHAPE agreement — which stages dominate,
        how much overlap the schedule harvests — and the machinery itself.
    """
    step: int
    analytic: Union[Timeline, "ArrayTimeline"]
    measured: Timeline
    wall_s: float = 0.0                 # end-to-end execute() wall clock
    # execution-path telemetry: how the measured side ran
    mode: str = "serial"                # "serial" per-stage | "fused" overlap
    pool_entries: int = 0               # committed-copy cache population
    pool_bytes: int = 0                 # ... and its device-buffer bytes
    stage_fills: int = 0                # stage measurements apportioning had
    #                                     to invent (planned durations all 0
    #                                     or a serial stage went unmeasured)

    def stage_rows(self) -> List[Tuple[str, float, float, float]]:
        """(stage, analytic_s, measured_s, measured/analytic) per stage
        name, in STAGE_NAMES order; ratio is inf when analytic is 0."""
        a, m = self.analytic.stage_totals(), self.measured.stage_totals()
        rows = []
        for name in STAGE_NAMES:
            if name not in a and name not in m:
                continue
            av, mv = a.get(name, 0.0), m.get(name, 0.0)
            rows.append((name, av, mv, mv / av if av > 0 else float("inf")))
        return rows

    @property
    def makespan_ratio(self) -> float:
        a = self.analytic.makespan_s
        return self.measured.makespan_s / a if a > 0 else float("inf")

    @property
    def overlap_efficiency(self) -> float:
        """Measured makespan / sum of measured group walls: < 1.0 means
        the executor actually ran independent groups concurrently."""
        total = sum(self.measured.stage_totals().values())
        return self.measured.makespan_s / total if total > 0 else 1.0

    def summary(self) -> str:
        lines = [
            f"step {self.step}: makespan analytic "
            f"{self.analytic.makespan_s * 1e6:9.1f}us  measured "
            f"{self.measured.makespan_s * 1e6:9.1f}us  "
            f"(x{self.makespan_ratio:.2f}, exec wall "
            f"{self.wall_s * 1e3:.1f}ms, {self.mode}, "
            f"pool {self.pool_entries}/{self.pool_bytes}B"
            + (f", {self.stage_fills} stage fills" if self.stage_fills
               else "") + ")"]
        for name, av, mv, ratio in self.stage_rows():
            lines.append(f"  {name:<9} analytic {av * 1e6:9.1f}us  "
                         f"measured {mv * 1e6:9.1f}us  (x{ratio:.2f})")
        return "\n".join(lines)


def measured_vs_analytic(step: int,
                         analytic: Union[Timeline, "ArrayTimeline"],
                         measured_flows: Sequence[Flow],
                         wall_s: float = 0.0, *, mode: str = "serial",
                         pool_entries: int = 0, pool_bytes: int = 0,
                         stage_fills: int = 0) -> MeasuredReport:
    """Schedule the measured flows (same greedy policy as the analytic
    side) and pair the two timelines into a MeasuredReport."""
    return MeasuredReport(step, analytic, simulate(measured_flows), wall_s,
                          mode=mode, pool_entries=pool_entries,
                          pool_bytes=pool_bytes, stage_fills=stage_fills)


def simulate_arrays(fa: FlowArrays) -> Union["ArrayTimeline", Timeline]:
    """Greedy earliest-start list scheduling via a lazy-reevaluation heap.

    One candidate per flow lives in the heap, keyed (start_estimate,
    flow_index). An estimate is computed from resource-free times at push
    time; free times only move forward, so every key is a LOWER bound on
    the candidate's true start. Popping the heap minimum and recomputing:
    if the true start equals the key, every other candidate's true start
    is >= its key >= ours, and equal-key ties pop the smaller flow index
    first — exactly the object scheduler's scan order — so scheduling it
    IS the greedy choice. If the key went stale, re-push with the fresh
    start and continue. Stage-for-stage identical to simulate() for any
    non-negative durations (zero-duration stages included — the selection
    regime emits them when sel_frac is 0); negative durations would break
    free-time monotonicity, so that never-emitted corner is delegated to
    the object oracle.

    The loop is plain Python over pre-extracted lists: per stage it costs
    a heappop, two list reads and at most one heappush — ~10x fewer
    interpreter-level operations than one numpy round of the previous
    round-based scheduler, and the bench's per-step flow sets (tens of
    flows, hundreds of stages) are far below numpy's vectorization
    break-even."""
    # instance memo first: the planner's step-replay cache hands the SAME
    # FlowArrays object back for a repeated step, so not even the byte
    # fingerprint needs recomputing
    inst_cached = getattr(fa, "_sim_memo", None)
    if inst_cached is not None:
        _SIM_STATS["inst_hit"] += 1
        return ArrayTimeline(fa, *inst_cached)
    S = int(fa.dur.shape[0])
    F = fa.n_flows
    if S and float(fa.dur.min()) < 0.0:
        return simulate(fa.to_flows())
    memo_key = (F, fa.offsets.tobytes(), fa.dur.tobytes(), fa.res.tobytes(),
                fa.code.tobytes(), fa.resources)
    cached = _SIM_MEMO.get(memo_key)
    if cached is not None:
        _SIM_STATS["memo_hit"] += 1
        fa._sim_memo = cached
        return ArrayTimeline(fa, *cached)
    _SIM_STATS["miss"] += 1
    off_l = fa.offsets.tolist()
    dur_l = fa.dur.tolist()
    res_l = fa.res.tolist()
    code_l = fa.code.tolist()
    is_link_l = [rsc[0] == "link" for rsc in fa.resources]
    free = [0.0] * max(1, len(fa.resources))
    start_l = [0.0] * S
    end_l = [0.0] * S
    order_l = [0] * S
    n_done = 0
    makespan = 0.0
    # aggregates, accumulated inline in the oracle's order: stage totals
    # and resource busy as left-to-right float adds in SCHEDULE order
    # (exactly np.add.at over the order array), flow end as an
    # order-independent max
    tot = [0.0] * len(STAGE_NAMES)
    code_seen = [False] * len(STAGE_NAMES)
    busy_l = [0.0] * max(1, len(fa.resources))
    flow_end_l = [0.0] * F
    link_seen: set = set()               # distinct (link res, flow) pairs
    flow_serial_l = [0.0] * F
    # heap entries are (start_estimate, flow); flow is unique per entry
    # (exactly one candidate per unfinished flow), so the 2-tuple orders
    # identically to any longer key — the candidate's flat stage and
    # flow-ready time live in the ptr / rdyf side lists instead
    ptr = off_l[:F]                      # next flat stage per flow
    rdyf = [0.0] * F                     # flow-ready (prev stage end)
    heap = [(0.0, f) for f in range(F) if off_l[f] < off_l[f + 1]]
    push, pop = heapq.heappush, heapq.heappop
    while heap:
        s, f = pop(heap)
        j = ptr[f]
        r = res_l[j]
        if r >= 0:
            fr = free[r]
            rdy = rdyf[f]
            true_s = fr if fr > rdy else rdy
            if true_s > s:                   # stale estimate — refresh
                push(heap, (true_s, f))
                continue
        dj = dur_l[j]
        e = s + dj
        start_l[j] = s
        end_l[j] = e
        order_l[n_done] = j
        n_done += 1
        d = e - s                        # == ScheduledStage.duration_s
        c = code_l[j]
        tot[c] += d
        code_seen[c] = True
        # per-flow serial accumulates raw durations in stage order (a
        # flow's stages schedule in order, so this IS left-to-right)
        flow_serial_l[f] += dj
        if r >= 0:
            free[r] = e
            busy_l[r] += d
            if is_link_l[r]:
                link_seen.add((r, f))
        # a flow's stage ends are monotone (non-negative durations), so the
        # last write wins and the makespan is recovered post-loop as the
        # max over flow ends — both exact float maxes, no arithmetic
        flow_end_l[f] = e
        nj = j + 1
        if nj < off_l[f + 1]:
            ptr[f] = nj
            rdyf[f] = e
            nr = res_l[nj]
            if nr >= 0:
                fr = free[nr]
                push(heap, (fr if fr > e else e, f))
            else:
                push(heap, (e, f))
    if flow_end_l:
        makespan = max(flow_end_l)
    start_s = np.array(start_l, np.float64)
    end_s = np.array(end_l, np.float64)
    order = np.array(order_l, np.int64)

    # cross-flow serial sum in flow order — the oracle's accumulation
    serial = 0.0
    for fs in flow_serial_l:
        serial += fs
    stage_totals = {STAGE_NAMES[c]: tot[c]
                    for c in range(len(STAGE_NAMES)) if code_seen[c]}
    busy = {rsc: busy_l[i] for i, rsc in enumerate(fa.resources)}
    # distinct flows per link: unique (resource, flow) pairs, counted
    link_counts: Dict[Resource, int] = {}
    if any(is_link_l):
        lcnt = [0] * len(fa.resources)
        for r, _ in link_seen:
            lcnt[r] += 1
        link_counts = {rsc: lcnt[i] for i, rsc in enumerate(fa.resources)
                       if is_link_l[i]}
    out = (start_s, end_s, order, makespan, serial, stage_totals, busy,
           link_counts, np.array(flow_serial_l, np.float64),
           np.array(flow_end_l, np.float64))
    if len(_SIM_MEMO) >= _SIM_MEMO_CAP:
        _SIM_MEMO.clear()
    _SIM_MEMO[memo_key] = out
    fa._sim_memo = out
    return ArrayTimeline(fa, *out)
