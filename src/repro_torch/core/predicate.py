"""The closed-form ROUTE / FETCH / LOCAL primitive-selection predicate (§5).

Per (chunk, request), evaluate the three costs of cost_model.py and take the
argmin — in microseconds of scheduler time, with no online profiling. The
serving engine (repro.serving) calls decide() per scheduled chunk access.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from repro_torch.core import constants as C
from repro_torch.core import cost_model as cm
from repro_torch.core.constants import Fabric


class Primitive(enum.Enum):
    ROUTE = "route"
    FETCH = "fetch"
    LOCAL = "local"


@dataclasses.dataclass(frozen=True)
class Request:
    """What the scheduler already tracks per (chunk, request) (§5.5)."""
    m_q: int                       # routed-query batch size
    c_t: int                       # chunk size in tokens
    fabric: Fabric                 # requester->holder fabric
    payload: cm.Payload = cm.MLA_PAYLOAD
    # Amortization: expected number of subsequent local decode steps on this
    # instance that would reuse a fetched copy (FETCH "only to amortise").
    expected_reuse_steps: int = 1
    # Selection regime (§5.4): if set, the chunk is a scattered top-k set
    # spread over n_holders; FETCH becomes a gather, splice is inadmissible.
    k_selected: Optional[int] = None
    n_holders: int = 1
    # True-prefix case (§6.3): chunk served at its cached offset => delta
    # rotation is the identity and the splice elides.
    position_delta: int = 1
    # Whether a route to the holder exists at all (disaggregated-prefill
    # corner: a model-agnostic byte store cannot run the partial, §6.3).
    holder_can_compute: bool = True
    # Host-overhead regime (§5.3): 0 for in-graph transport (TPU), or the
    # prototype's 3.5ms + 12.5us/row for validation against the paper.
    host_overhead: bool = False


@dataclasses.dataclass(frozen=True)
class Decision:
    primitive: Primitive
    t_route: float
    t_fetch: float
    t_local: float
    reason: str

    @property
    def costs(self):
        return {Primitive.ROUTE: self.t_route, Primitive.FETCH: self.t_fetch,
                Primitive.LOCAL: self.t_local}


def route_cost(req: Request) -> float:
    t_host = (C.HOST_OVERHEAD_BASE_S + C.HOST_OVERHEAD_PER_ROW_S * req.m_q
              if req.host_overhead else 0.0)
    if not req.holder_can_compute:
        return float("inf")
    if req.k_selected is not None and req.n_holders > 1:
        t = cm.t_route_fanout(req.fabric, req.m_q, req.n_holders, req.payload)
    else:
        t = cm.t_route(req.fabric, req.m_q, req.payload)
    return t + t_host


def fetch_cost(req: Request) -> float:
    if req.k_selected is not None:
        # Scattered gather; no splice (entries at canonical positions). A
        # fetched selection cannot amortise: it is re-chosen every step (§5.4).
        return cm.t_fetch_scattered(req.fabric, req.k_selected, req.n_holders,
                                    req.payload)
    contiguous = req.position_delta != 0
    t = cm.t_fetch(req.fabric, req.c_t, req.payload, contiguous=contiguous)
    # Amortise the one-time pull+splice over expected local reuse steps.
    return t / max(1, req.expected_reuse_steps)


def local_cost(req: Request,
               c_per_token_layer: float = C.PREFILL_PER_TOKEN_LAYER_MID_S) -> float:
    return cm.t_local(req.c_t, req.payload.n_layers, c_per_token_layer)


def decide(req: Request) -> Decision:
    """The closed-form predicate: argmin of the three instantiated costs."""
    tr, tf, tl = route_cost(req), fetch_cost(req), local_cost(req)
    best = min((tr, Primitive.ROUTE), (tf, Primitive.FETCH), (tl, Primitive.LOCAL),
               key=lambda x: x[0])[1]
    reason = _explain(req, tr, tf, tl, best)
    return Decision(best, tr, tf, tl, reason)


def _explain(req: Request, tr: float, tf: float, tl: float,
             best: Primitive) -> str:
    if best is Primitive.ROUTE:
        if req.k_selected is not None:
            return ("selection regime: route is the indexer's choice made "
                    "distributed; scattered gather would grow with holders")
        return (f"decode-shaped (M_q={req.m_q}): route RT "
                f"{tr*1e6:.0f}us vs fetch {tf*1e6:.0f}us / local {tl*1e6:.0f}us")
    if best is Primitive.FETCH:
        if req.expected_reuse_steps > 1:
            return (f"amortised over {req.expected_reuse_steps} local steps; "
                    "fetch pays the splice once")
        if req.m_q > req.c_t:
            return "query batch exceeds chunk: routing would ship more than the chunk"
        return "no cheaper primitive available"
    return f"small chunk (c_t={req.c_t}): re-prefill undercuts the flat splice"


# ---------------------------------------------------------------------------
# Vectorized predicate: one argmin over arrays for a whole decode step.
# The serving engine prices every (request, chunk) pair of a step in a
# handful of numpy expressions instead of a Python loop per pair.
# decide_batch() matches decide() element-wise by construction
# (tests/test_predicate_batch.py fuzzes the agreement).
# ---------------------------------------------------------------------------

PRIMITIVE_BY_CODE = (Primitive.ROUTE, Primitive.FETCH, Primitive.LOCAL)
ROUTE_CODE, FETCH_CODE, LOCAL_CODE = 0, 1, 2


@dataclasses.dataclass
class RequestBatch:
    """Struct-of-arrays form of Request over one scheduling batch.

    fabric_idx indexes into `fabrics`; k_selected uses -1 for "no selection
    regime" (None in the scalar form). All arrays share one shape."""
    fabrics: cm.FabricArrays
    m_q: np.ndarray
    c_t: np.ndarray
    fabric_idx: np.ndarray
    expected_reuse_steps: np.ndarray
    k_selected: np.ndarray            # -1 => None
    n_holders: np.ndarray
    position_delta: np.ndarray
    holder_can_compute: np.ndarray    # bool
    host_overhead: np.ndarray         # bool
    payload: cm.Payload = cm.MLA_PAYLOAD

    def __len__(self) -> int:
        return int(np.asarray(self.m_q).shape[0])

    def take(self, idx: np.ndarray) -> "RequestBatch":
        """Row subset sharing the fabric table — the engine's incremental
        §8 repricing re-runs the predicate only on pairs whose link crossed
        the congestion knee."""
        return RequestBatch(
            fabrics=self.fabrics, m_q=self.m_q[idx], c_t=self.c_t[idx],
            fabric_idx=self.fabric_idx[idx],
            expected_reuse_steps=self.expected_reuse_steps[idx],
            k_selected=self.k_selected[idx], n_holders=self.n_holders[idx],
            position_delta=self.position_delta[idx],
            holder_can_compute=self.holder_can_compute[idx],
            host_overhead=self.host_overhead[idx], payload=self.payload)

    @classmethod
    def from_requests(cls, reqs: "list[Request]") -> "RequestBatch":
        """Pack scalar Requests; fabrics are interned by object identity so
        fitted/ad-hoc Fabric rows work too."""
        uniq: list = []
        idx = []
        for r in reqs:
            try:
                idx.append(uniq.index(r.fabric))
            except ValueError:
                uniq.append(r.fabric)
                idx.append(len(uniq) - 1)
        payloads = {r.payload for r in reqs}
        if len(payloads) > 1:
            raise ValueError("one RequestBatch serves one payload geometry")
        return cls(
            fabrics=cm.FabricArrays.from_fabrics(uniq or [C.fabric("tpu_ici")]),
            m_q=np.array([r.m_q for r in reqs], np.int64),
            c_t=np.array([r.c_t for r in reqs], np.int64),
            fabric_idx=np.array(idx, np.int64),
            expected_reuse_steps=np.array(
                [r.expected_reuse_steps for r in reqs], np.int64),
            k_selected=np.array(
                [-1 if r.k_selected is None else r.k_selected for r in reqs],
                np.int64),
            n_holders=np.array([r.n_holders for r in reqs], np.int64),
            position_delta=np.array([r.position_delta for r in reqs],
                                    np.int64),
            holder_can_compute=np.array([r.holder_can_compute for r in reqs],
                                        bool),
            host_overhead=np.array([r.host_overhead for r in reqs], bool),
            payload=reqs[0].payload if reqs else cm.MLA_PAYLOAD)


@dataclasses.dataclass(frozen=True)
class DecisionBatch:
    """Array-of-decisions: per element the three costs + the argmin code."""
    code: np.ndarray                  # int8: 0 ROUTE / 1 FETCH / 2 LOCAL
    t_route: np.ndarray
    t_fetch: np.ndarray
    t_local: np.ndarray

    def primitive(self, i: int) -> Primitive:
        return PRIMITIVE_BY_CODE[int(self.code[i])]

    def primitives(self) -> "list[Primitive]":
        return [PRIMITIVE_BY_CODE[int(c)] for c in self.code]


def route_cost_batch(b: RequestBatch,
                     k_flows: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized route_cost(). With k_flows (per-element concurrent flows
    on the element's link), prices under §8 congestion instead of the
    uncontended transport — the engine's steady-state path."""
    fa = b.fabrics
    if k_flows is None:
        t = cm.t_route_batch(fa, b.fabric_idx, b.m_q, b.payload)
    else:
        t = cm.t_route_congested_full_batch(fa, b.fabric_idx, b.m_q,
                                            k_flows, b.payload)
    # selection fan-out / host overhead / dead-holder rows are priced on
    # their row subsets only (all three terms are element-wise, so the
    # scattered values are bitwise what the full-width pass produced)
    fanout = (b.k_selected >= 0) & (b.n_holders > 1)
    if fanout.any():
        idx = np.nonzero(fanout)[0]
        fan = cm.t_route_fanout_batch(fa, b.fabric_idx[idx], b.m_q[idx],
                                      np.maximum(b.n_holders[idx], 1),
                                      b.payload)
        t = t.copy()
        t[idx] = fan
    if b.host_overhead.any():
        t = t + np.where(
            b.host_overhead,
            C.HOST_OVERHEAD_BASE_S + C.HOST_OVERHEAD_PER_ROW_S * b.m_q, 0.0)
    if not b.holder_can_compute.all():
        t = np.where(b.holder_can_compute, t, np.inf)
    return t


def route_cost_rows(b: RequestBatch, idx: np.ndarray,
                    k_flows: np.ndarray) -> np.ndarray:
    """route_cost_batch on a row subset: bitwise what
    route_cost_batch(b.take(idx), k_flows) computes, without materialising
    the sub-batch. The engine's §8 incremental repricing only needs the
    ROUTE term on the over-knee rows — fetch/local costs are congestion-
    independent, so the uncontended pass already has them exactly."""
    fa = b.fabrics
    fi = b.fabric_idx[idx]
    mq = b.m_q[idx]
    t = cm.t_route_congested_full_batch(fa, fi, mq, k_flows, b.payload)
    ks = b.k_selected[idx]
    nh = b.n_holders[idx]
    fanout = (ks >= 0) & (nh > 1)
    if fanout.any():
        j = np.nonzero(fanout)[0]
        t[j] = cm.t_route_fanout_batch(fa, fi[j], mq[j],
                                       np.maximum(nh[j], 1), b.payload)
    ho = b.host_overhead[idx]
    if ho.any():
        t = t + np.where(
            ho, C.HOST_OVERHEAD_BASE_S + C.HOST_OVERHEAD_PER_ROW_S * mq, 0.0)
    hcc = b.holder_can_compute[idx]
    if not hcc.all():
        t = np.where(hcc, t, np.inf)
    return t


def fetch_cost_batch(b: RequestBatch) -> np.ndarray:
    """Vectorized fetch_cost(): scattered gather under selection (never
    amortised, §5.4); otherwise pull+splice amortised over expected reuse."""
    fa = b.fabrics
    contiguous = b.position_delta != 0
    bulk = cm.t_fetch_batch(fa, b.fabric_idx, b.c_t, b.payload, contiguous)
    bulk = bulk / np.maximum(1, b.expected_reuse_steps)
    has_sel = b.k_selected >= 0
    if not has_sel.any():
        return bulk
    # scattered-gather pricing on the selection rows only (element-wise,
    # so the scatter reproduces the full-width np.where bitwise)
    idx = np.nonzero(has_sel)[0]
    bulk[idx] = cm.t_fetch_scattered_batch(
        fa, b.fabric_idx[idx], np.maximum(b.k_selected[idx], 0),
        np.maximum(b.n_holders[idx], 1), b.payload)
    return bulk


def local_cost_batch(b: RequestBatch,
                     c_per_token_layer: float =
                     C.PREFILL_PER_TOKEN_LAYER_MID_S) -> np.ndarray:
    return cm.t_local_batch(b.c_t, b.payload.n_layers, c_per_token_layer)


def decide_batch(b: RequestBatch,
                 k_flows: Optional[np.ndarray] = None) -> DecisionBatch:
    """The closed-form predicate over a whole batch: element-wise argmin of
    the three vectorized costs. Tie-break order (ROUTE < FETCH < LOCAL)
    matches decide()'s min() ordering. k_flows (optional) prices ROUTE under
    link congestion — used by the engine's steady-state scheduler."""
    tr = route_cost_batch(b, k_flows)
    tf = fetch_cost_batch(b)
    tl = local_cost_batch(b)
    code = np.argmin(np.stack([tr, tf, tl], axis=0), axis=0).astype(np.int8)
    return DecisionBatch(code, tr, tf, tl)


# ---------------------------------------------------------------------------
# Serving rules of thumb (§5.5) as queryable helpers.
# ---------------------------------------------------------------------------

def fetch_local_crossover_ct(fabric: Fabric,
                             payload: cm.Payload = cm.MLA_PAYLOAD,
                             c_lo: float = C.PREFILL_PER_TOKEN_LAYER_S[0],
                             c_hi: float = C.PREFILL_PER_TOKEN_LAYER_S[1]) -> tuple:
    """Chunk size above which FETCH's flat splice undercuts LOCAL re-prefill.
    Paper: ~75-220 tokens for c in [0.5, 1.5] us/token-layer."""
    out = []
    for c in (c_hi, c_lo):      # c_hi gives the small end of the band
        # Solve c_t * L * c = t_fetch(c_t); pull term is tiny, iterate once.
        ct = np.array(1.0)
        for _ in range(50):
            ct = cm.t_fetch(fabric, float(ct), payload) / (payload.n_layers * c)
        out.append(float(ct))
    return tuple(out)


def holder_fanout_cap() -> int:
    """Per-holder concurrent-requester cap: both the copy- and compute-elbows
    sit near 8 (§6.2, §6.3)."""
    return C.HOLDER_COMPUTE_ELBOW_N


def replication_threshold(n_agents: int) -> bool:
    """Agentic fan-in (§6.3): beyond the elbow, added agents cost linearly and
    a second replica (an amortised FETCH) is warranted."""
    return n_agents > C.HOLDER_COMPUTE_ELBOW_N
