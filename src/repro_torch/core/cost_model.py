"""The topology-aware redistribution cost model (paper §4).

    T_redist(F, s, B) = T_probe(F) + T_transfer(F, s, B) + T_compute
                        + T_return(F, s, B') + T_merge

Instantiated per primitive:

    ROUTE : T_probe + M_q (q+p)/BW + T_compute + T_merge
    FETCH : T_pull + T_splice          (contiguous reuse)
            multi-holder scattered gather (selection regime, §5.4)
    LOCAL : c_t * L * c                (re-prefill)

All functions are pure closed-form (numpy-scalar) — the paper's point is that
a scheduler evaluates this *arithmetically*, with no online calibration
(§4.3: "evaluated, not profiled").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import constants as C
from repro_torch.core.constants import Fabric


@dataclasses.dataclass(frozen=True)
class Payload:
    """Wire payload geometry for one routed query row (model-dependent).

    Extending the predicate to a new architecture requires exactly the two
    coefficients the paper names (abstract): the routed payload here and
    FETCH's move-the-cache cost (b_kv/splice below).
    """
    q_bytes: int = C.Q_ROW_BYTES          # routed query row
    p_bytes: int = C.P_ROW_BYTES          # returned partial (o, m, l)
    b_kv_token_layer: int = C.B_KV_TOKEN_LAYER
    n_layers: int = C.V2_LITE_LAYERS

    @property
    def qp_bytes(self) -> int:
        return self.q_bytes + self.p_bytes

    @property
    def b_kv_token_all_layers(self) -> int:
        return self.b_kv_token_layer * self.n_layers


MLA_PAYLOAD = Payload()


def payload_for(d_qk: int, d_v: int, n_layers: int,
                kv_bytes_token_layer: Optional[int] = None) -> Payload:
    """Instantiate the wire payload from published model dimensions (§1)."""
    q = d_qk * C.BF16
    p = d_v * C.BF16 + 2 * C.FP32
    b_kv = kv_bytes_token_layer if kv_bytes_token_layer is not None else d_qk * C.BF16
    return Payload(q, p, b_kv, n_layers)


# ---------------------------------------------------------------------------
# ROUTE
# ---------------------------------------------------------------------------

def t_route_transport(fabric: Fabric, m_q: int, payload: Payload = MLA_PAYLOAD,
                      include_launch: bool = False) -> float:
    """Transport round trip: T_probe + M_q (q+p) / BW   [paper eq. §4.2].

    include_launch adds the fixed ~9 us kernel-turnaround residual the linear
    term omits (§4.3) — used when predicting small-M_q measurements.
    """
    t = fabric.t_probe_s + m_q * payload.qp_bytes / fabric.bw_Bps
    if include_launch:
        t += fabric.t_launch_s
    return t


def t_route(fabric: Fabric, m_q: int, payload: Payload = MLA_PAYLOAD,
            t_compute: float = np.mean(C.HOLDER_COMPUTE_DECODE_S),
            t_merge: float = C.MERGE_COST_S,
            t_host: float = 0.0,
            include_launch: bool = False) -> float:
    """Full ROUTE cost. t_host models the §5.3 prototype host overhead
    (3.5 ms + 12.5 us * M_q there); 0 for an in-graph transport."""
    return (t_route_transport(fabric, m_q, payload, include_launch)
            + t_compute + t_merge + t_host)


def t_route_fanout(fabric: Fabric, m_q: int, n_holders: int,
                   payload: Payload = MLA_PAYLOAD,
                   t_compute: float = np.mean(C.HOLDER_COMPUTE_DECODE_S),
                   t_merge_per_way: float = C.MERGE_COST_S / 8) -> float:
    """Scattered-selection fan-out (§5.4): the query ships once per holder
    (probe-bound), holders compute in parallel, M-way merge at requester.
    Stays flat in n_holders: the M sends are concurrent (probe-bound) and the
    merge is <= 25 us total."""
    sends = fabric.t_probe_s + m_q * payload.qp_bytes / fabric.bw_Bps
    return sends + t_compute + n_holders * t_merge_per_way


# ---------------------------------------------------------------------------
# FETCH
# ---------------------------------------------------------------------------

def t_splice(c_t: int) -> float:
    """Position-adaptation splice: flat ~3 ms, launch-bound (§2.2, §7)."""
    return C.SPLICE_BASE_S + C.SPLICE_PER_TOKEN_S * c_t


def t_pull(fabric: Fabric, c_t: int, payload: Payload = MLA_PAYLOAD) -> float:
    """Bulk all-layer c^KV pull, coalesced into one transfer => sees the link
    peak, not the dispatch ceiling (§8)."""
    return c_t * payload.b_kv_token_all_layers / fabric.link_peak_Bps


def t_fetch(fabric: Fabric, c_t: int, payload: Payload = MLA_PAYLOAD,
            contiguous: bool = True) -> float:
    """Move-the-cache. Contiguous reuse pays pull + splice; a true-prefix
    re-home (delta = 0) elides the splice (§6.3)."""
    t = t_pull(fabric, c_t, payload)
    if contiguous:
        t += t_splice(c_t)
    return t


def t_fetch_scattered(fabric: Fabric, k_selected: int, n_holders: int,
                      payload: Payload = MLA_PAYLOAD,
                      per_holder_handshake_s: float = 180e-6) -> float:
    """Scattered gather under selection (§5.4): per-holder separate transfers
    (scattering defeats bulk coalescing) + per-holder handshakes; no splice
    (entries stay at canonical positions). Grows linearly in n_holders;
    measured 1.3 -> 3.9 ms/layer for M=1->7 at k=2048. Returns the ALL-layer
    cost. The handshake constant is fit from Fig 4a.
    """
    per_layer_bytes = k_selected * payload.b_kv_token_layer
    # Serial per-holder pulls at the dispatch rate (prototype is host-copy
    # bound; we take the fabric dispatch rate as the optimistic bound).
    per_layer = (n_holders * per_holder_handshake_s
                 + per_layer_bytes / fabric.bw_Bps)
    return payload.n_layers * per_layer


# ---------------------------------------------------------------------------
# LOCAL
# ---------------------------------------------------------------------------

def t_local(c_t: int, n_layers: int = C.V2_LITE_LAYERS,
            c_per_token_layer: float = C.PREFILL_PER_TOKEN_LAYER_MID_S) -> float:
    """Fresh re-prefill of the chunk: c_t * L * c (§5.1)."""
    return c_t * n_layers * c_per_token_layer


# ---------------------------------------------------------------------------
# Wire bytes (§5.2) — the M_q x c_t crossover is on bytes alone.
# ---------------------------------------------------------------------------

def route_wire_bytes(m_q: int, payload: Payload = MLA_PAYLOAD) -> int:
    return m_q * payload.qp_bytes


def fetch_wire_bytes(c_t: int, payload: Payload = MLA_PAYLOAD,
                     all_layers: bool = False) -> int:
    b = payload.b_kv_token_all_layers if all_layers else payload.b_kv_token_layer
    return c_t * b


def byte_breakeven_mq(c_t: int, payload: Payload = MLA_PAYLOAD) -> float:
    """M_q* = c_t * b_KV / (q+p): ROUTE moves fewer bytes below this (§5.2).
    Per-layer on both sides (the L factor cancels)."""
    return c_t * payload.b_kv_token_layer / payload.qp_bytes


# ---------------------------------------------------------------------------
# Congestion (§8): flat until a link is fully subscribed.
# ---------------------------------------------------------------------------

def t_route_congested(fabric: Fabric, m_q: int, k_flows: int,
                      payload: Payload = MLA_PAYLOAD) -> float:
    """K concurrent route flows sharing one link. Measured behaviour: flat
    through K<=2; at K=3 queueing lands on probe and transfer alike."""
    probe_mult = C.CONGESTION_PROBE_MULT.get(min(k_flows, 3), 1.0)
    if k_flows >= 3:
        # Full subscription: each flow sees ~1/k of the dispatch bandwidth
        # plus probe queueing. Calibrated to the measured +119% at M_q=1024.
        bw = fabric.bw_Bps / (k_flows - 1)
    else:
        bw = fabric.bw_Bps
    return fabric.t_probe_s * probe_mult + m_q * payload.qp_bytes / bw


def t_route_congested_full(fabric: Fabric, m_q: int, k_flows: int,
                           payload: Payload = MLA_PAYLOAD,
                           t_compute: float = np.mean(
                               C.HOLDER_COMPUTE_DECODE_S),
                           t_merge: float = C.MERGE_COST_S) -> float:
    """End-to-end congested ROUTE: transport under K flows + holder compute
    + merge. The one formula both the predicate (batch form below) and the
    engine's dispatch pricing use — keep them in lockstep here."""
    return t_route_congested(fabric, m_q, k_flows, payload) \
        + t_compute + t_merge


# ---------------------------------------------------------------------------
# Vectorized (array-safe) forms. The scalar functions above ARE element-wise
# in their numeric arguments but take one Fabric object; the batch forms take
# a FabricArrays table + integer fabric indices so a scheduler can price a
# whole decode step in a handful of numpy expressions (the §4.3 point taken
# to throughput: "evaluated, not profiled" — and evaluated in bulk).
# Element-wise they match the scalar forms exactly (tests/test_predicate_batch).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FabricArrays:
    """Struct-of-arrays view of a fabric table, indexable by fabric id."""
    names: Tuple[str, ...]
    t_probe_s: np.ndarray
    bw_Bps: np.ndarray
    link_peak_Bps: np.ndarray
    t_launch_s: np.ndarray

    @classmethod
    def from_fabrics(cls, fabrics: Sequence[Fabric]) -> "FabricArrays":
        return cls(
            names=tuple(f.name for f in fabrics),
            t_probe_s=np.array([f.t_probe_s for f in fabrics], np.float64),
            bw_Bps=np.array([f.bw_Bps for f in fabrics], np.float64),
            link_peak_Bps=np.array([f.link_peak_Bps for f in fabrics],
                                   np.float64),
            t_launch_s=np.array([f.t_launch_s for f in fabrics], np.float64))

    def index_of(self, name: str) -> int:
        return self.names.index(name)


def fabric_arrays(names: Optional[Sequence[str]] = None) -> FabricArrays:
    """FabricArrays over the named rows of C.FABRICS (all rows by default,
    in sorted-name order so indices are stable)."""
    keys = list(names) if names is not None else sorted(C.FABRICS)
    return FabricArrays.from_fabrics([C.FABRICS[k] for k in keys])


def t_route_batch(fa: FabricArrays, fabric_idx: np.ndarray,
                  m_q: np.ndarray, payload: Payload = MLA_PAYLOAD,
                  t_compute: float = np.mean(C.HOLDER_COMPUTE_DECODE_S),
                  t_merge: float = C.MERGE_COST_S,
                  t_host: np.ndarray = 0.0,
                  include_launch: bool = False) -> np.ndarray:
    """Vectorized t_route over (fabric_idx, m_q) arrays."""
    fi = np.asarray(fabric_idx)
    t = (fa.t_probe_s[fi]
         + np.asarray(m_q, np.float64) * payload.qp_bytes / fa.bw_Bps[fi])
    if include_launch:
        t = t + fa.t_launch_s[fi]
    return t + t_compute + t_merge + np.asarray(t_host, np.float64)


def t_route_fanout_batch(fa: FabricArrays, fabric_idx: np.ndarray,
                         m_q: np.ndarray, n_holders: np.ndarray,
                         payload: Payload = MLA_PAYLOAD,
                         t_compute: float = np.mean(C.HOLDER_COMPUTE_DECODE_S),
                         t_merge_per_way: float = C.MERGE_COST_S / 8
                         ) -> np.ndarray:
    """Vectorized t_route_fanout (§5.4 scattered-selection fan-out)."""
    fi = np.asarray(fabric_idx)
    sends = (fa.t_probe_s[fi]
             + np.asarray(m_q, np.float64) * payload.qp_bytes / fa.bw_Bps[fi])
    return sends + t_compute + np.asarray(n_holders) * t_merge_per_way


def t_fetch_batch(fa: FabricArrays, fabric_idx: np.ndarray,
                  c_t: np.ndarray, payload: Payload = MLA_PAYLOAD,
                  contiguous: np.ndarray = True) -> np.ndarray:
    """Vectorized t_fetch: bulk pull at link peak + splice where contiguous."""
    fi = np.asarray(fabric_idx)
    ct = np.asarray(c_t, np.float64)
    pull = ct * payload.b_kv_token_all_layers / fa.link_peak_Bps[fi]
    splice = C.SPLICE_BASE_S + C.SPLICE_PER_TOKEN_S * ct
    return pull + np.where(np.asarray(contiguous), splice, 0.0)


def t_fetch_scattered_batch(fa: FabricArrays, fabric_idx: np.ndarray,
                            k_selected: np.ndarray, n_holders: np.ndarray,
                            payload: Payload = MLA_PAYLOAD,
                            per_holder_handshake_s: float = 180e-6
                            ) -> np.ndarray:
    """Vectorized t_fetch_scattered (§5.4 gather; linear in n_holders)."""
    fi = np.asarray(fabric_idx)
    per_layer_bytes = np.asarray(k_selected, np.float64) \
        * payload.b_kv_token_layer
    per_layer = (np.asarray(n_holders) * per_holder_handshake_s
                 + per_layer_bytes / fa.bw_Bps[fi])
    return payload.n_layers * per_layer


def t_local_batch(c_t: np.ndarray, n_layers: int = C.V2_LITE_LAYERS,
                  c_per_token_layer: float = C.PREFILL_PER_TOKEN_LAYER_MID_S
                  ) -> np.ndarray:
    """Vectorized t_local (already element-wise; named for symmetry)."""
    return np.asarray(c_t, np.float64) * n_layers * c_per_token_layer


def t_route_congested_batch(fa: FabricArrays, fabric_idx: np.ndarray,
                            m_q: np.ndarray, k_flows: np.ndarray,
                            payload: Payload = MLA_PAYLOAD) -> np.ndarray:
    """Vectorized t_route_congested (§8): flat through K<=2 concurrent
    flows on a link; at K>=3 probe queueing + 1/(K-1) dispatch bandwidth."""
    fi = np.asarray(fabric_idx)
    k = np.asarray(k_flows)
    probe_mult = np.where(k >= 3, C.CONGESTION_PROBE_MULT[3], 1.0)
    bw = np.where(k >= 3, fa.bw_Bps[fi] / np.maximum(k - 1, 1),
                  fa.bw_Bps[fi])
    return (fa.t_probe_s[fi] * probe_mult
            + np.asarray(m_q, np.float64) * payload.qp_bytes / bw)


def t_route_congested_full_batch(fa: FabricArrays, fabric_idx: np.ndarray,
                                 m_q: np.ndarray, k_flows: np.ndarray,
                                 payload: Payload = MLA_PAYLOAD,
                                 t_compute: float = np.mean(
                                     C.HOLDER_COMPUTE_DECODE_S),
                                 t_merge: float = C.MERGE_COST_S
                                 ) -> np.ndarray:
    """Vectorized t_route_congested_full (see scalar form above)."""
    return t_route_congested_batch(fa, fabric_idx, m_q, k_flows, payload) \
        + t_compute + t_merge


# ---------------------------------------------------------------------------
# Per-stage breakdowns (§4: T_probe / T_transfer / T_compute / T_return /
# T_merge). The serving timeline (repro.serving.timeline) consumes these:
# each breakdown is an ordered tuple of (stage_name, seconds) whose durations
# sum to the corresponding closed-form price above, so a one-flow timeline IS
# the scalar cost model. k_flows prices the wire stages under the §8 closed
# form; the timeline passes 0 (uncontended) because there queueing is
# *simulated* — flows serialize on the shared link — rather than priced.
# ---------------------------------------------------------------------------

StageList = Tuple[Tuple[str, float], ...]


def route_stages(fabric: Fabric, m_q: int, k_flows: int = 0,
                 payload: Payload = MLA_PAYLOAD,
                 t_compute: float = np.mean(C.HOLDER_COMPUTE_DECODE_S),
                 t_merge: float = C.MERGE_COST_S,
                 t_host: float = 0.0) -> StageList:
    """ROUTE as the paper's five stages. transfer carries the query rows out,
    return carries the partials back; together they are the t_route_transport
    round trip, so the stage sum equals t_route_congested_full + t_host."""
    probe_mult = C.CONGESTION_PROBE_MULT.get(min(k_flows, 3), 1.0)
    bw = fabric.bw_Bps / (k_flows - 1) if k_flows >= 3 else fabric.bw_Bps
    stages = [
        ("probe", fabric.t_probe_s * probe_mult),
        ("transfer", m_q * payload.q_bytes / bw),
        ("compute", float(t_compute)),
        ("return", m_q * payload.p_bytes / bw),
        ("merge", float(t_merge)),
    ]
    if t_host:
        stages.append(("host", float(t_host)))
    return tuple(stages)


def fetch_stages(fabric: Fabric, c_t: int, payload: Payload = MLA_PAYLOAD,
                 contiguous: bool = True, reuse_steps: int = 1) -> StageList:
    """FETCH as bulk pull + position splice, each amortised over the reuse
    horizon (§5.5 rule 2) so the stage sum equals t_fetch / reuse_steps."""
    r = max(1, reuse_steps)
    stages = [("pull", t_pull(fabric, c_t, payload) / r)]
    if contiguous:
        stages.append(("splice", t_splice(c_t) / r))
    return tuple(stages)


def fetch_scattered_stages(fabric: Fabric, k_selected: int, n_holders: int,
                           payload: Payload = MLA_PAYLOAD,
                           per_holder_handshake_s: float = 180e-6
                           ) -> StageList:
    """Scattered gather (§5.4) as one wire stage: the per-holder transfers
    are serial at the dispatch rate, so there is no overlap to expose."""
    return (("gather", t_fetch_scattered(fabric, k_selected, n_holders,
                                         payload, per_holder_handshake_s)),)


def local_stages(c_t: int, n_layers: int = C.V2_LITE_LAYERS,
                 c_per_token_layer: float = C.PREFILL_PER_TOKEN_LAYER_MID_S
                 ) -> StageList:
    """LOCAL re-prefill: one compute stage on the requester, no wire."""
    return (("prefill", t_local(c_t, n_layers, c_per_token_layer)),)


# ---------------------------------------------------------------------------
# Selection regime (§5.4): the distributed indexer service. Per decode step
# the requester broadcasts a NARROW indexer query (d_index columns, not the
# full d_qk row) to every holder of a selected chunk; each holder scores its
# resident index keys (the chunk store's sidecar) and returns its local
# top-k (block id, score) candidates; the requester merges them into the
# global top-k. The `index` stage below is one holder's share of that round
# trip — it rides the same (link, fabric) wire as the transport stages, and
# the planner prepends it to the ROUTE/FETCH stage chains of selection
# dispatches. Holder compute then scales with the selection budget resident
# on the holder (KB), not the store size.
# ---------------------------------------------------------------------------

INDEX_CANDIDATE_BYTES = 8          # returned (block id i32, score f32) pair


def t_index_roundtrip(fabric: Fabric, m_q: int, k_blocks: int,
                      d_index: int) -> float:
    """One holder's indexer round trip: ship m_q narrow query rows (d_index
    bf16 columns — the scoring projection, not the 1152-B wire row), get
    back <= k_blocks candidates. Scoring compute is folded into the
    attention compute stage (it is a rank-d_index dot, noise next to it)."""
    wire_bytes = m_q * d_index * C.BF16 + k_blocks * INDEX_CANDIDATE_BYTES
    return fabric.t_probe_s + wire_bytes / fabric.bw_Bps


def index_stages(fabric: Fabric, m_q: int, k_blocks: int,
                 d_index: int) -> StageList:
    """The indexer round trip as a timeline stage (wire class: it occupies
    the dispatch's (link, fabric) resource like probe/transfer do)."""
    return (("index", t_index_roundtrip(fabric, m_q, k_blocks, d_index)),)


def t_route_selected_full(fabric: Fabric, m_q: int, k_flows: int,
                          sel_frac: float, k_blocks: int, d_index: int,
                          payload: Payload = MLA_PAYLOAD,
                          t_compute: float = np.mean(
                              C.HOLDER_COMPUTE_DECODE_S),
                          t_merge: float = C.MERGE_COST_S) -> float:
    """End-to-end ROUTE under selection: indexer round trip + congested
    query transport + holder compute scaled by the fraction of the holder's
    store the selection touches (sel_frac = selected/resident tokens — the
    budget KB, not the store size) + merge."""
    return (t_index_roundtrip(fabric, m_q, k_blocks, d_index)
            + t_route_congested(fabric, m_q, k_flows, payload)
            + t_compute * sel_frac + t_merge)


def route_selected_stages(fabric: Fabric, m_q: int, k_flows: int,
                          sel_frac: float, k_blocks: int, d_index: int,
                          payload: Payload = MLA_PAYLOAD,
                          t_compute: float = np.mean(
                              C.HOLDER_COMPUTE_DECODE_S),
                          t_merge: float = C.MERGE_COST_S) -> StageList:
    """ROUTE under selection as stages: index + the five §4 stages with
    compute scaled to the selected fraction. Parameter order matches
    t_route_selected_full (the two must stay in lockstep): the stage sum
    equals it exactly at the same k_flows."""
    return index_stages(fabric, m_q, k_blocks, d_index) + route_stages(
        fabric, m_q, k_flows, payload, t_compute * sel_frac, t_merge)


def t_fetch_selected(fabric: Fabric, k_local: float, m_q: int, k_blocks: int,
                     d_index: int, payload: Payload = MLA_PAYLOAD) -> float:
    """End-to-end FETCH under selection, per holder: indexer round trip +
    scattered gather of the k_local entries chosen on this holder (no
    splice — canonical positions; never amortised — the selection is
    re-chosen every step, §5.4)."""
    return (t_index_roundtrip(fabric, m_q, k_blocks, d_index)
            + t_fetch_scattered(fabric, k_local, 1, payload))


def fetch_selected_stages(fabric: Fabric, k_local: float, m_q: int,
                          k_blocks: int, d_index: int,
                          payload: Payload = MLA_PAYLOAD) -> StageList:
    """FETCH under selection as stages: index + one gather wire stage.
    Summed over a selection's M holders, the gather stages reproduce the
    closed-form t_fetch_scattered(k_total, M) exactly (M handshakes + the
    budget's bytes) — bench_scatter_gather asserts the identity."""
    return index_stages(fabric, m_q, k_blocks, d_index) + (
        ("gather", t_fetch_scattered(fabric, k_local, 1, payload)),)


# ---------------------------------------------------------------------------
# Stage templates: the per-stage breakdowns above, assembled by
# broadcast for a whole dispatch column instead of per-dispatch function
# calls. One StageTemplates instance caches the per-(fabric, regime)
# coefficient columns of a FabricArrays + Payload pairing; each method
# returns an (R, n_stages) float64 duration matrix whose rows are
# element-wise bit-identical to the scalar *_stages tuples (the arithmetic
# mirrors the scalar expressions operation-for-operation — the array
# planner's golden parity depends on it). Stage names per kind are the
# class-level *_names tuples, in column order.
# ---------------------------------------------------------------------------


class StageTemplates:
    """Broadcast assembly of the §4 stage breakdowns for the array planner.

    Durations are UNCONTENDED (k_flows = 0), like the timeline inputs the
    engine builds — §8 queueing is simulated by the scheduler, while the
    *_est methods price the congested closed forms the predicate used."""

    route_names = ("probe", "transfer", "compute", "return", "merge")
    fetch_names = ("pull", "splice")
    local_names = ("prefill",)
    route_selected_names = ("index",) + route_names
    fetch_selected_names = ("index", "gather")

    def __init__(self, fa: FabricArrays, payload: Payload = MLA_PAYLOAD,
                 t_compute: float = np.mean(C.HOLDER_COMPUTE_DECODE_S),
                 t_merge: float = C.MERGE_COST_S):
        self.fa = fa
        self.payload = payload
        self.t_compute = t_compute
        self.t_merge = t_merge

    # -- dense ROUTE --------------------------------------------------------

    def route(self, fi: np.ndarray, m_q: np.ndarray) -> np.ndarray:
        fa, p = self.fa, self.payload
        mq = np.asarray(m_q, np.float64)
        bw = fa.bw_Bps[fi]
        out = np.empty((mq.shape[0], 5), np.float64)
        out[:, 0] = fa.t_probe_s[fi]             # probe_mult == 1 at k = 0
        out[:, 1] = mq * p.q_bytes / bw
        out[:, 2] = self.t_compute
        out[:, 3] = mq * p.p_bytes / bw
        out[:, 4] = self.t_merge
        return out

    def route_est(self, fi: np.ndarray, m_q: np.ndarray,
                  k_flows: np.ndarray) -> np.ndarray:
        """t_route_congested_full, the formula the predicate priced with."""
        return t_route_congested_full_batch(
            self.fa, fi, m_q, k_flows, self.payload,
            self.t_compute, self.t_merge)

    # -- dense FETCH --------------------------------------------------------

    def fetch(self, fi: np.ndarray, c_t: np.ndarray,
              reuse: np.ndarray) -> np.ndarray:
        fa, p = self.fa, self.payload
        ct = np.asarray(c_t, np.float64)
        r = np.asarray(reuse, np.float64)
        out = np.empty((ct.shape[0], 2), np.float64)
        out[:, 0] = ct * p.b_kv_token_all_layers / fa.link_peak_Bps[fi] / r
        out[:, 1] = (C.SPLICE_BASE_S + C.SPLICE_PER_TOKEN_S * ct) / r
        return out

    def fetch_est(self, fi: np.ndarray, c_t: np.ndarray,
                  reuse: np.ndarray) -> np.ndarray:
        fa, p = self.fa, self.payload
        ct = np.asarray(c_t, np.float64)
        pull = ct * p.b_kv_token_all_layers / fa.link_peak_Bps[fi]
        splice = C.SPLICE_BASE_S + C.SPLICE_PER_TOKEN_S * ct
        return (pull + splice) / np.asarray(reuse, np.float64)

    # -- LOCAL --------------------------------------------------------------

    def local(self, c_t: np.ndarray) -> np.ndarray:
        return t_local_batch(c_t, self.payload.n_layers)[:, None]

    def local_est(self, c_t: np.ndarray) -> np.ndarray:
        return t_local_batch(c_t, self.payload.n_layers)

    # -- selection regime (§5.4) --------------------------------------------

    def _index_rt(self, fi: np.ndarray, m_q: np.ndarray, k_blocks: np.ndarray,
                  d_index: int) -> np.ndarray:
        wire_bytes = (np.asarray(m_q, np.int64) * d_index * C.BF16
                      + np.asarray(k_blocks, np.int64)
                      * INDEX_CANDIDATE_BYTES)
        return self.fa.t_probe_s[fi] + wire_bytes / self.fa.bw_Bps[fi]

    def route_selected(self, fi: np.ndarray, m_q: np.ndarray,
                       sel_frac: np.ndarray, k_blocks: np.ndarray,
                       d_index: int) -> np.ndarray:
        out = np.empty((np.asarray(m_q).shape[0], 6), np.float64)
        out[:, 0] = self._index_rt(fi, m_q, k_blocks, d_index)
        out[:, 1:] = self.route(fi, m_q)
        out[:, 3] = self.t_compute * np.asarray(sel_frac, np.float64)
        return out

    def route_selected_est(self, fi: np.ndarray, m_q: np.ndarray,
                           k_flows: np.ndarray, sel_frac: np.ndarray,
                           k_blocks: np.ndarray, d_index: int) -> np.ndarray:
        cong = t_route_congested_batch(self.fa, fi, m_q, k_flows,
                                       self.payload)
        return (self._index_rt(fi, m_q, k_blocks, d_index) + cong
                + self.t_compute * np.asarray(sel_frac, np.float64)
                + self.t_merge)

    def fetch_selected(self, fi: np.ndarray, k_local: np.ndarray,
                       m_q: np.ndarray, k_blocks: np.ndarray,
                       d_index: int) -> np.ndarray:
        out = np.empty((np.asarray(m_q).shape[0], 2), np.float64)
        out[:, 0] = self._index_rt(fi, m_q, k_blocks, d_index)
        out[:, 1] = self._gather(fi, k_local)
        return out

    def fetch_selected_est(self, fi: np.ndarray, k_local: np.ndarray,
                           m_q: np.ndarray, k_blocks: np.ndarray,
                           d_index: int) -> np.ndarray:
        return self._index_rt(fi, m_q, k_blocks, d_index) \
            + self._gather(fi, k_local)

    def _gather(self, fi: np.ndarray, k_local: np.ndarray,
                per_holder_handshake_s: float = 180e-6) -> np.ndarray:
        """t_fetch_scattered at n_holders = 1 (per-holder gather)."""
        p = self.payload
        per_layer_bytes = np.asarray(k_local, np.int64) * p.b_kv_token_layer
        return p.n_layers * (per_holder_handshake_s
                             + per_layer_bytes / self.fa.bw_Bps[fi])


def scale_stages(stages: StageList, factor: float) -> StageList:
    """Scale every stage duration (holder/requester slowdown)."""
    if factor == 1.0:
        return stages
    return tuple((name, dur * factor) for name, dur in stages)


def stages_total_s(stages: StageList) -> float:
    return sum(d for _, d in stages)


# ---------------------------------------------------------------------------
# Model-fit diagnostics (§4.3): MAPE of the affine model vs measurements.
# ---------------------------------------------------------------------------

def mape(predicted: Sequence[float], measured: Sequence[float]) -> float:
    p = np.asarray(predicted, dtype=np.float64)
    m = np.asarray(measured, dtype=np.float64)
    return float(np.mean(np.abs(p - m) / m))


def fit_affine(m_qs: Sequence[int], rts: Sequence[float],
               payload: Payload = MLA_PAYLOAD) -> Fabric:
    """Least-squares re-fit of the two per-fabric constants (T_probe, BW)
    from a measured (M_q, round-trip) sweep — 'extending to a new fabric
    requires measuring just two coefficients'."""
    x = np.asarray(m_qs, dtype=np.float64) * payload.qp_bytes
    y = np.asarray(rts, dtype=np.float64)
    slope, intercept = np.polyfit(x, y, 1)
    bw = 1.0 / slope
    return Fabric("fitted", float(intercept), float(bw), float(bw))
