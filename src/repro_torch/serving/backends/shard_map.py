"""ShardMapExecBackend: run the plan over an instance mesh on the cards.

The JAX package partitions its chunk store across a mesh axis named
"instance", one device per serving instance, and executes every transport
the planner decided as a real collective inside shard_map. Here serving
instance i lives on card slot i % k of the mesh's placement (every visible
card by default; core/instance_mesh.py) with its own CUDA stream, and
every transport is a copy into a buffer the destination owns on its card
(InstanceMesh.pull: on one card issued on the destination's stream after
an event on the source's, between two cards a peer copy):

* ROUTE  — the staged core.routing decomposition: pairwise_ship /
  pairwise_return ppermutes when the dispatch group shares one home,
  fanout_gather / fanout_exchange when requesters span homes. The query
  crosses between instances; the cache never does. The holder's partial
  is mla_decode (sparse_select under a selection) on the holder's stream.
* FETCH  — core.splice.fetch_chunk: the holder's rows pulled into the
  requester's pool rows and spliced (delta 0) in one delta_rotate launch;
  the copy persists as the replica array where the planner made it
  resident. Under a selection, fetch_scattered_gather: the chosen rows at
  canonical positions, nothing persisted (§5.4).
* LOCAL  — re-prefill on the requester's own stream.

Resident pairs attend on the instance's own stream, and every partial of
a request lands on its home instance, where the request's partials merge
in one softmax_merge launch (TorchExecBackend._merge); the merged output
then lands on the backend's device, as the single-instance backend's do.
Outputs reproduce the single-instance oracles to float round-off (§3.3).

The store's arrays and the queries are made on the backend's device (the
first card). Before a step's timed window opens (mesh.begin), _prepare
puts what each instance reads on its card: the committed copy of a chunk,
pulled once per (chunk, instance) and pooled, the queries, and a LOCAL
re-prefill's array. Where the instance's card is the backend's own, each
is the array itself, so a one-slot mesh runs exactly as one card always
did.

Each wire / compute stage is timed and the measured durations are rebound
to the SAME flow structure the cost model priced; timeline.
measured_vs_analytic schedules them into a MeasuredReport per step, the
paper's §7 model-validation loop. The returned analytic timeline is
analytic_timeline(plan), AnalyticBackend's own, so StepStats are
bit-identical to an analytic run (sched_wall_s excepted).

Two execution modes:

* ``fused=True`` (default) — every dispatch group is issued on the
  instances' streams with event dependencies and no host synchronize;
  submit returns the StepTicket before the barrier, and await_result
  synchronizes once, attributes the walls and merges. A group's wall runs
  from a CUDA event at its first op to one at its last — device stamps,
  where the reference took host stamps around JAX's asynchronous dispatch
  — net of queueing behind groups that share a (link, fabric) wire or an
  SM, and is apportioned over the record's planned stage ratios. Each
  stamp is timed from the origin of its own slot (Origins.since); a ROUTE
  group that starts on the holder and stops on the requester of another
  slot adds the measured offset between the two origins where the slots
  share a card, and none between two cards (the origins follow one
  barrier; their skew there is not measured, and the wall is off by it).
* ``fused=False`` — one timed call per stage: after a warm run per
  (stage, shape) key (the kernels build at first use), the host wall from
  issue to the end of a synchronize of the stage's stream, the reference's
  block_until_ready wall. On the card the stage then runs once more with
  the instances' streams held behind one GPU spin per card that hides its
  issue, and CUDA events from each slot's gate (the spin's end) to that
  slot's last op give the stage's device time, the longest over the
  slots, kept beside the host wall (stage_log). The A/B kill switch and
  the serial baseline.

On the CPU the mesh has no streams: everything runs in order, the kernels
take their plain versions, and the stamps are the host clock.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from collections import defaultdict
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    TYPE_CHECKING)

import numpy as np
import torch

from repro_torch.core.chunk_store import ChunkStore
from repro_torch.core.instance_mesh import AXIS, InstanceMesh, Origins
from repro_torch.core.merge import Partial
from repro_torch.core.routing import (check_route_shards, fanout_exchange,
                                      fanout_gather, merge_on,
                                      pairwise_return, pairwise_ship)
from repro_torch.core.splice import (fetch_chunk, fetch_scattered_gather,
                                     splice_delta_rotate)
from repro_torch.models.mla import MLAConfig, absorbed_partial, \
    selected_partial
from repro_torch.serving import timeline as TL
from repro_torch.serving.backends.base import StepExecution, StepTicket
from repro_torch.serving.backends.torch_exec import (TINY_MLA, QuerySource,
                                                     TorchExecBackend,
                                                     analytic_timeline,
                                                     fetch_source)
from repro_torch.serving.plan import StepPlan

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.serving.engine import ServingEngine


# steps whose stage log the backend keeps (the newest)
STAGE_LOG_STEPS = 64


@dataclasses.dataclass(frozen=True)
class MeshFlow(TL.Flow):
    """A measured flow of the mesh (MeasuredReport.measured.flows), with
    where its transfers ran: "same slot" (every instance it moved data
    between sits on one card slot) or "peer" (they cross slots: cards,
    where the slots are distinct cards)."""
    placement: str = "same slot"


def peer_flows(report: TL.MeasuredReport) -> int:
    """The measured flows of a step whose transfers crossed card slots."""
    return sum(getattr(f, "placement", "") == "peer"
               for f in report.measured.flows)


def _sig(*xs) -> Tuple:
    """The shape signature of a stage's inputs, for its warm-run key."""
    return tuple(tuple(x.shape) if isinstance(x, torch.Tensor) else x
                 for x in xs)


class ShardMapExecBackend(TorchExecBackend):
    """TorchExecBackend semantics over an InstanceMesh, with measured stage
    timings. cfg is the execution geometry (the planner's cost payload is
    independent: analytic / exec planner parity is exact)."""

    name = "shard_map"
    _warned_fill = False               # process-wide warn-once

    def __init__(self, cfg: MLAConfig = TINY_MLA, dtype=torch.float32,
                 device="cuda", query_source: Optional[QuerySource] = None,
                 fused: bool = True, devices=None):
        super().__init__(cfg, dtype, device, query_source)
        self.fused = fused
        # the mesh's card slots (InstanceMesh); None: from `device` ("cuda"
        # = every visible card once, "cpu" = one CPU slot)
        self.devices = device if devices is None else devices
        self.mesh: Optional[InstanceMesh] = None
        self._pool: Dict[Tuple[str, int], torch.Tensor] = {}
        self._warm: set = set()
        self._tiny: List[torch.Tensor] = []
        self._listening_store = None
        self._fill_count = 0
        self._dev: Dict[str, float] = {}
        # per step (the newest STAGE_LOG_STEPS): each measured stage of
        # each dispatch group beside its analytic duration (measured_s: the
        # serial host wall or the fused group's apportioned device wall;
        # serial on the card adds device_s, the stage's CUDA-event time) —
        # read by chip_smoke.py
        self.stage_log: Dict[int, List[dict]] = {}
        # per-step / cumulative phase walls of the fused path (stack /
        # dispatch / barrier / merge): four host-clock probes per step
        self.phase_wall: Dict[str, float] = {}
        self.phase_wall_total: Dict[str, float] = {}
        # per step (the newest STAGE_LOG_STEPS): the spread of the slots'
        # origins, seconds (Origins.skew: None where not measured)
        self.slot_skew: Dict[int, Optional[float]] = {}

    # -- mesh binding -------------------------------------------------------

    def _bind(self, engine: "ServingEngine") -> None:
        ni = len(engine.instances)
        if self.mesh is None or self.mesh.n != ni:
            self.mesh = InstanceMesh(ni, self.devices)
            self._warm.clear()
            self._pool.clear()
            self._tiny = []
            for i in range(ni):
                with self.mesh.on(i):
                    self._tiny.append(torch.zeros(
                        1, device=self.mesh.device_of(i)))
        store = engine.store
        if self._listening_store is not store:
            # bounded committed-copy cache: when the engine retires a
            # replica (or a holder dies), its pooled buffer retires with it
            store.add_evict_listener(self._retire_pooled)
            self._listening_store = store

    def _retire_pooled(self, chunk_id: str, instance: int) -> None:
        self._pool.pop((chunk_id, instance), None)

    def _pool_bytes(self) -> int:
        return sum(int(b.nbytes) for b in self._pool.values())

    def _committed_copy(self, store: ChunkStore, chunk_id: str,
                        inst: int) -> torch.Tensor:
        """The copy instance `inst` attends, on its card. Cached per (chunk,
        instance): chunk bytes are canonical under delta-0 replication, so
        a cached copy can never go stale in content — only in shape, which
        re-keys. The store's array on another card is copied over once
        (in _prepare, before the step's window opens); on the store's own
        card it is pooled as it is."""
        arr = self._array_on(store, chunk_id, inst)
        key = (chunk_id, inst)
        buf = self._pool.get(key)
        if buf is None or buf.shape != arr.shape:
            buf = self._pool[key] = self._to_card(arr, inst)
        return buf

    def _to_card(self, t: torch.Tensor, inst: int) -> torch.Tensor:
        """t on instance inst's card: t itself where it lies there, else a
        copy, issued on the current streams (before mesh.begin, whose
        barrier the instances wait behind)."""
        dev = self.mesh.device_of(inst)
        return t if t.device == dev else t.to(dev, non_blocking=True)

    # -- shared pieces ------------------------------------------------------

    def _prepare(self, engine: "ServingEngine", plan: StepPlan) -> Dict:
        """Make every query and chunk array the step reads on the current
        streams, before the instances wait for them (mesh.begin), each on
        the card of the instance that reads it: the committed copies of
        resident pairs, ROUTE holders and FETCH sources, each request's
        queries where they are attended or stacked, and a LOCAL re-prefill's
        array on each requester's card. Returns the step's staged queries,
        keyed ("q", req_id, instance), and LOCAL arrays, ("arr", chunk_id,
        instance)."""
        store = engine.store
        reqs = {rq.req_id: rq for rq in plan.requests}
        for rq in plan.requests:
            self.query_of(rq, plan.step)
        for cid in {rp.chunk_id for rp in plan.resident_pairs} | {
                rec.chunk_id for rec in plan.records
                if not rec.backup and rec.req_ids}:
            self.ensure_chunk_data(store, cid)
        q_at, local_at = set(), set()
        for rp in plan.resident_pairs:
            self._committed_copy(store, rp.chunk_id, rp.instance)
            q_at.add((rp.req_id, rp.instance))
        for rec in plan.records:
            if rec.backup or not rec.req_ids:
                continue
            homes = {(rid, reqs[rid].home) for rid in rec.req_ids}
            if rec.primitive == "route":
                self._committed_copy(store, rec.chunk_id, rec.holder)
                q_at |= homes
            elif rec.primitive in ("fetch", "fetch_replica"):
                self._committed_copy(store, rec.chunk_id, fetch_source(rec))
                dst = rec.home if rec.home >= 0 else rec.holder
                q_at |= homes | {(rid, dst) for rid in rec.req_ids}
            else:
                q_at |= homes
                local_at |= {(rec.chunk_id, h) for _, h in homes}
        staged = {("q", rid, i): self._to_card(
            self.query_of(reqs[rid], plan.step), i) for rid, i in q_at}
        staged.update({("arr", cid, i): self._to_card(
            self.ensure_chunk_data(store, cid), i) for cid, i in local_at})
        return staged

    def _partial(self, inst: int, q: torch.Tensor, arr: torch.Tensor,
                 sel, chunk_id: str) -> Partial:
        """q's partial over arr on instance inst: dense (mla_decode) or over
        the selection's blocks of the chunk (sparse_select)."""
        with self.mesh.on(inst, q, arr):
            if sel is None:
                return absorbed_partial(self.cfg, q, arr)
            return selected_partial(self.cfg, q, arr, sel.blocks[chunk_id],
                                    sel.block_tokens)

    def _ride(self, p: Partial, src: int, dst: int) -> Partial:
        """A partial moves from instance src to dst (o, m and l)."""
        if src == dst:
            return p
        return Partial(*(self.mesh.pull(t, src, dst) for t in p))

    def _warmed(self, key: Tuple, fn: Callable[[], Any]) -> None:
        """The first call per (stage, shape) key runs fn once and waits for
        it, untimed: the kernels build and load at first use, and that must
        never land in a measured sample."""
        if key not in self._warm:
            fn()
            self.mesh.synchronize()
            self._warm.add(key)

    def _merge_requests(self, parts: Dict[int, List[Partial]],
                        reqs) -> Dict[int, Partial]:
        """Each request's partials, all on its home instance, merged there
        in one softmax_merge launch."""
        out = {}
        for rid, ps in parts.items():
            with self.mesh.on(reqs[rid].home):
                out[rid] = self._merge(ps)
        return out

    def _landed(self, outputs: Dict[int, Partial]) -> Dict[int, Partial]:
        """The merged outputs on the backend's device, after mesh.join (the
        current streams have waited for the instances). One on another
        card is copied over on that card's current stream, which its
        memory is recorded on first; the rest are returned as they are."""
        dev = self.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out = {}
        for rid, p in outputs.items():
            if p.o.device == dev:
                out[rid] = p
                continue
            for t in p:
                t.record_stream(torch.cuda.current_stream(t.device))
            out[rid] = Partial(*(t.to(self.device, non_blocking=True)
                                 for t in p))
        return out

    def _resident(self, store, plan, q_of, parts) -> None:
        """Resident accesses attend the instance's own copy on its stream
        (no transport planned, so no measured flow either)."""
        sels = plan.selections
        for rp in plan.resident_pairs:
            arr = self._committed_copy(store, rp.chunk_id, rp.instance)
            parts[rp.req_id].append(self._partial(
                rp.instance, q_of(rp.req_id, rp.instance), arr,
                sels.get(rp.req_id), rp.chunk_id))

    def _keep_log(self, step: int, log: List[dict],
                  origins: Origins) -> None:
        self.stage_log[step] = log
        self.slot_skew[step] = origins.skew()
        while len(self.stage_log) > STAGE_LOG_STEPS:
            del self.stage_log[next(iter(self.stage_log))]
            del self.slot_skew[next(iter(self.slot_skew))]

    @staticmethod
    def _label(rec, i: int) -> str:
        return f"{rec.primitive}:{rec.chunk_id}@{rec.holder}#{i}"

    @staticmethod
    def _kind(rec, plan: StepPlan) -> str:
        """The record's execution path, for the stage log: its primitive,
        and for a ROUTE its schedule (pairwise: one home; fanout: many)
        and whether it ran under a selection."""
        if rec.primitive != "route":
            return rec.primitive
        homes = {rq.home for rq in plan.requests if rq.req_id in rec.req_ids}
        kind = "route " + ("pairwise" if len(homes) == 1 else "fanout")
        return kind + (" selected" if rec.req_ids[0] in plan.selections
                       else "")

    def _log(self, rec, i: int, plan: StepPlan, meas: Dict[str, float],
             **by_stage: Dict[str, Optional[float]]) -> List[dict]:
        """The record's stages for the stage log: each with its analytic
        duration, the measured one, and any other times by stage, beside
        the record's requester instance and its placement (same slot or
        peer)."""
        base = {"record": self._label(rec, i), "primitive": rec.primitive,
                "kind": self._kind(rec, plan),
                "instance": rec.home if rec.home >= 0 else rec.holder,
                "placement": self._placement(rec, plan)}
        return [dict(base, stage=name, analytic_s=dur, measured_s=meas[name],
                     **{k: v.get(name) for k, v in by_stage.items()})
                for name, dur in rec.stages]

    # -- execution ----------------------------------------------------------

    def execute(self, engine: "ServingEngine",
                plan: StepPlan) -> StepExecution:
        return self.await_result(engine, self.submit(engine, plan))

    def submit(self, engine: "ServingEngine", plan: StepPlan) -> StepTicket:
        """Issue the step WITHOUT blocking: bind, stack the groups' inputs on
        their instances, dispatch every group on the instances' streams —
        everything up to (not including) the barrier. The engine plans the
        next step while the card works; await_result synchronizes and
        merges. The serial chain synchronizes after every stage, so
        fused=False stays eager: its ticket is already complete."""
        t_wall0 = time.perf_counter()
        self._bind(engine)
        if not self.fused:
            self._fill_count = 0
            return StepTicket(plan=plan, execution=self._execute_serial(
                engine, plan, t_wall0))
        return StepTicket(plan=plan,
                          state=self._submit_overlapped(engine, plan,
                                                        t_wall0))

    def await_result(self, engine: "ServingEngine",
                     ticket: StepTicket) -> StepExecution:
        if ticket.execution is not None:
            return ticket.execution
        return self._await_overlapped(engine, ticket.plan, ticket.state)

    def _placement(self, rec, plan: StepPlan) -> str:
        """"peer" where the record moves data between instances of two
        card slots (holder or FETCH source, requesters, homes), else "same
        slot"."""
        homes = {rq.home for rq in plan.requests if rq.req_id in rec.req_ids}
        ends = homes | {rec.holder, fetch_source(rec)} | (
            {rec.home} if rec.home >= 0 else set())
        if rec.primitive == "local":
            ends = homes
        slots = {self.mesh.slot_of(i) for i in ends}
        return "peer" if len(slots) > 1 else "same slot"

    def _report(self, plan: StepPlan, analytic, measured_flows,
                t_wall0: float, mode: str) -> TL.MeasuredReport:
        return TL.measured_vs_analytic(
            plan.step, analytic, measured_flows,
            time.perf_counter() - t_wall0, mode=mode,
            pool_entries=len(self._pool), pool_bytes=self._pool_bytes(),
            stage_fills=self._fill_count)

    def _count_fill(self, rec, n: int) -> None:
        """A stage duration had to be invented (a serial stage went
        unmeasured, or a fused wall apportioned over all-zero planned
        durations): count it on the step's MeasuredReport and warn ONCE
        per process."""
        self._fill_count += n
        cls = type(self)
        if not cls._warned_fill:
            cls._warned_fill = True
            print(f"[shard_map] warning: filled {n} unmeasured stage "
                  f"duration(s) on {rec.primitive}:{rec.chunk_id}; "
                  f"counted on MeasuredReport.stage_fills (warn-once)",
                  file=sys.stderr)

    def _measured_flow(self, rec, i: int, meas: Dict[str, float],
                       plan: StepPlan) -> TL.Flow:
        """Rebind the record's planned stage chain to measured durations:
        same key, same stage names/order, same resource binding as
        plan.build_timeline — so the measured schedule is comparable
        stage-for-stage with the analytic one."""
        missing = [name for name, _dur in rec.stages if name not in meas]
        if missing:
            self._count_fill(rec, len(missing))
        stages = [(name, float(meas.get(name, 0.0)))
                  for name, _dur in rec.stages]
        link_res = (TL.link(rec.link_instance, rec.fabric_idx)
                    if rec.link_instance >= 0 else None)
        requester = rec.home if rec.home >= 0 else rec.holder
        flow = TL.transport_flow(
            self._label(rec, i), stages,
            link_res=link_res, holder_sm=TL.sm(rec.holder),
            requester_sm=TL.sm(requester), primitive=rec.primitive,
            chunk_id=rec.chunk_id)
        return MeshFlow(flow.key, flow.stages, flow.primitive, flow.chunk_id,
                        self._placement(rec, plan))

    # =======================================================================
    # Serial: one timed call per stage.
    # =======================================================================

    def _staged(self, stage: str, key: Tuple, fn: Callable[[], Any],
                ends: Sequence[int]) -> Tuple[Any, float]:
        """Run one stage whose work ends on the streams of instances `ends`
        and return (output, host wall seconds): from issue to the end of a
        synchronize of those streams, after the key's warm run. On the card
        the stage then runs once more for its device time (self._dev)."""
        mesh = self.mesh
        self._warmed(key, fn)
        t0 = time.perf_counter()
        out = fn()
        issued = time.perf_counter() - t0
        mesh.synchronize(ends)
        wall = time.perf_counter() - t0
        if mesh.on_card:
            # the stage once more for its device time; its outputs (the
            # same values) replace the first run's, whose memory it reuses:
            # a new allocation would wait for the device
            del out
            out, dev = self._device_run(fn, ends, issued)
            self._dev[stage] = self._dev.get(stage, 0.0) + dev
        return out, wall

    def _device_run(self, fn: Callable[[], Any], ends: Sequence[int],
                    issued: float) -> Tuple[Any, float]:
        """fn's output and device time: fn issued with every instance's
        stream held behind one GPU spin on each card's current stream,
        long enough to hide the issue (twice the host's issue time at ~2e9
        cycles a second; mesh.begin), each slot timed from its gate (a
        CUDA event at its card's spin's end, which every instance waits
        for) to its own last event on the streams `ends` after the stage;
        the stage's device time is the longest."""
        mesh = self.mesh
        gates = mesh.begin(spin_cycles=int(2 * 2e9 * issued) + 1_000_000)
        out = fn()
        stops = [mesh.stamp(i) for i in ends]
        mesh.synchronize()
        return out, max(mesh.seconds(gates.stamps[e.slot], e) for e in stops)

    def _execute_serial(self, engine: "ServingEngine", plan: StepPlan,
                        t_wall0: float) -> StepExecution:
        store = engine.store
        mesh = self.mesh
        reqs = {rq.req_id: rq for rq in plan.requests}
        sels = plan.selections

        staged = self._prepare(engine, plan)

        def q_of(rid: int, inst: Optional[int] = None) -> torch.Tensor:
            """The request's queries on instance inst's card (its home's
            when None), as _prepare staged them."""
            return staged[("q", rid, reqs[rid].home if inst is None
                           else inst)]

        origins = mesh.begin()
        parts: Dict[int, List[Partial]] = defaultdict(list)
        self._resident(store, plan, q_of, parts)

        sel_times = getattr(engine.selector, "measured_index_s", None) or {}
        measured_flows: List[TL.Flow] = []
        log: List[dict] = []
        for i, rec in enumerate(plan.records):
            if rec.backup or not rec.req_ids:
                continue
            self._dev = {}
            if rec.primitive == "route":
                meas = self._exec_route_mesh(store, rec, q_of, parts, sels,
                                             reqs)
            elif rec.primitive in ("fetch", "fetch_replica"):
                if rec.req_ids[0] in sels:
                    meas = self._exec_fetch_selected_mesh(
                        store, rec, q_of, parts, sels[rec.req_ids[0]], reqs)
                else:
                    meas = self._exec_fetch_mesh(store, rec, q_of, parts,
                                                 reqs)
            else:
                meas = self._exec_local_mesh(rec, q_of, parts, sels, reqs,
                                             staged)
            if rec.stages and rec.stages[0][0] == "index":
                # the indexer round trip ran at PLAN time (the selector's
                # scoring collective); its measured wall lands here
                meas.setdefault("index", float(sel_times.get(
                    (plan.step, rec.req_ids[0], rec.chunk_id), 0.0)))
            if rec.stages:
                measured_flows.append(self._measured_flow(rec, i, meas,
                                                          plan))
                log += self._log(rec, i, plan, meas, device_s=self._dev)

        outputs = self._merge_requests(parts, reqs)
        mesh.synchronize()
        mesh.join()
        outputs = self._landed(outputs)
        self._keep_log(plan.step, log, origins)
        analytic = analytic_timeline(plan)
        report = self._report(plan, analytic, measured_flows, t_wall0,
                              "serial")
        return StepExecution(timeline=analytic, outputs=outputs,
                             backend=self.name, measured=report)

    # -- ROUTE --------------------------------------------------------------

    def _route_inputs(self, store, rec, q_of, sels, reqs):
        """The holder's copy, the selection (None when dense), and each
        request's (query, home), checked against the copy."""
        ckv = self._committed_copy(store, rec.chunk_id, rec.holder)
        sel = sels.get(rec.req_ids[0])
        qs = [q_of(rid) for rid in rec.req_ids]
        homes = [reqs[rid].home for rid in rec.req_ids]
        for q, home in zip(qs, homes):
            check_route_shards(AXIS, q, ckv, shard=home)
        return ckv, sel, qs, homes

    def _stack(self, inst: int, qs: List[torch.Tensor],
               rows: Optional[int] = None) -> torch.Tensor:
        """A group's query rows stacked on instance inst, zero-padded to
        `rows` (the fanout schedule pads every home to the widest)."""
        with self.mesh.on(inst, *qs):
            block = torch.cat(qs, dim=0) if len(qs) > 1 else qs[0]
            if rows is not None and block.shape[0] < rows:
                pad = torch.zeros((rows - block.shape[0],)
                                  + tuple(block.shape[1:]),
                                  dtype=block.dtype, device=block.device)
                block = torch.cat([block, pad], dim=0)
        return block

    def _fan_blocks(self, rec, qs, homes):
        """The fanout schedule's per-home blocks: every home's rows in one
        block, padded to the widest; slices[rid] = (home, start, rows)."""
        by_home: Dict[int, List[torch.Tensor]] = {}
        slices: Dict[int, Tuple[int, int, int]] = {}
        for rid, q, home in zip(rec.req_ids, qs, homes):
            blk = by_home.setdefault(home, [])
            start = sum(x.shape[0] for x in blk)
            blk.append(q)
            slices[rid] = (home, start, q.shape[0])
        b_pad = max(sum(x.shape[0] for x in blk) for blk in by_home.values())
        blocks = {home: self._stack(home, blk, b_pad)
                  for home, blk in by_home.items()}
        return blocks, slices

    @staticmethod
    def _slice(p: Partial, start: int, n: int) -> Partial:
        return Partial(o=p.o[start:start + n], m=p.m[start:start + n],
                       l=p.l[start:start + n])

    def _exec_route_mesh(self, store, rec, q_of, parts, sels,
                         reqs) -> Dict[str, float]:
        ckv, sel, qs, homes = self._route_inputs(store, rec, q_of, sels,
                                                 reqs)
        holder = rec.holder
        if len(set(homes)) == 1:
            stacked = self._stack(homes[0], qs)
            meas, merged = self._route_pairwise_staged(
                ckv, sel, rec.chunk_id, stacked, holder, homes[0])
            off = 0
            for rid, q in zip(rec.req_ids, qs):
                parts[rid].append(self._slice(merged, off, q.shape[0]))
                off += q.shape[0]
            return meas
        blocks, slices = self._fan_blocks(rec, qs, homes)
        meas, merged_by_home = self._route_fanout_staged(
            ckv, sel, rec.chunk_id, blocks, holder)
        for rid in rec.req_ids:
            home, start, n = slices[rid]
            parts[rid].append(self._slice(merged_by_home[home], start, n))
        return meas

    def _route_pairwise_staged(self, ckv, sel, chunk_id, q_stacked,
                               holder: int, requester: int):
        """ROUTE, one home: probe / transfer / compute / return around the
        staged core.routing ppermute decomposition; merge is landing the
        returned partial at the requester."""
        mesh = self.mesh
        meas: Dict[str, float] = {}
        pair = [(requester, holder)]
        tiny = [None] * mesh.n
        tiny[requester] = self._tiny[requester]
        _, meas["probe"] = self._staged(
            "probe", ("probe",), lambda: mesh.ppermute(tiny, pair), [holder])
        shards = [None] * mesh.n
        shards[requester] = q_stacked
        shipped, meas["transfer"] = self._staged(
            "transfer", ("pair-ship",) + _sig(q_stacked),
            lambda: pairwise_ship(mesh, shards, holder, requester), [holder])
        held = [None] * mesh.n
        held[holder], meas["compute"] = self._staged(
            "compute", ("route-compute", sel is None) + _sig(q_stacked, ckv),
            lambda: self._partial(holder, shipped[holder], ckv, sel,
                                  chunk_id), [holder])
        back, meas["return"] = self._staged(
            "return", ("pair-return",) + _sig(q_stacked),
            lambda: pairwise_return(mesh, held, holder, requester),
            [requester])
        # one home: the returned partial is the requester's as it landed;
        # its merge with the request's other partials is the request's one
        # softmax_merge launch after the step's groups
        merged, meas["merge"] = self._staged(
            "merge", ("pair-merge",), lambda: back[requester], [requester])
        return meas, merged

    def _route_fanout_staged(self, ckv, sel, chunk_id,
                             blocks: Dict[int, torch.Tensor], holder: int):
        """ROUTE, many homes: all_gather the padded query blocks to the
        holder, one holder-side batched partial over every visitor,
        all_to_all the partials home, merge the stack on each home."""
        mesh = self.mesh
        meas: Dict[str, float] = {}
        homes = sorted(blocks)
        _, meas["probe"] = self._staged(
            "probe", ("probe-fan",),
            lambda: mesh.all_gather(self._tiny, to=[holder]), [holder])
        shards = [blocks.get(i) for i in range(mesh.n)]
        sample = blocks[homes[0]]
        gathered, meas["transfer"] = self._staged(
            "transfer", ("fan-gather",) + _sig(sample),
            lambda: fanout_gather(mesh, shards, to=[holder]), [holder])
        held = [None] * mesh.n
        held[holder], meas["compute"] = self._staged(
            "compute", ("route-compute", sel is None)
            + _sig(gathered[holder], ckv),
            lambda: self._partial(holder, gathered[holder], ckv, sel,
                                  chunk_id), [holder])
        ex, meas["return"] = self._staged(
            "return", ("fan-exchange",) + _sig(sample),
            lambda: fanout_exchange(mesh, held, to=homes), homes)
        merged, meas["merge"] = self._staged(
            "merge", ("fan-merge",) + _sig(sample),
            lambda: {h: merge_on(mesh, h, ex[h]) for h in homes}, homes)
        return meas, merged

    # -- FETCH --------------------------------------------------------------

    def _exec_fetch_mesh(self, store, rec, q_of, parts,
                         reqs) -> Dict[str, float]:
        """Move the cache: pull the holder's rows into the requester's pool
        (fetch_chunk, delta elided: a copy), splice them there (delta 0, in
        place), persist the replica where the planner made it resident,
        then the group attends locally."""
        mesh = self.mesh
        meas: Dict[str, float] = {}
        src = fetch_source(rec)
        dst = rec.home if rec.home >= 0 else rec.holder
        ckv = self._committed_copy(store, rec.chunk_id, src)
        with mesh.on(dst):
            pool = torch.empty(ckv.shape, dtype=ckv.dtype,
                               device=mesh.device_of(dst))
        _, meas["pull"] = self._staged(
            "pull", ("fetch-pull",) + _sig(ckv),
            lambda: fetch_chunk(mesh, pool, ckv, None, 0, self.cfg, src,
                                dst), [dst])

        def splice():
            with mesh.on(dst):
                return splice_delta_rotate(pool, 0, self.cfg, out=pool)

        moved, meas["splice"] = self._staged(
            "splice", ("splice",) + _sig(ckv), splice, [dst])
        self._persist(store, rec, moved)
        for rid in rec.req_ids:
            p = self._partial(dst, q_of(rid, dst), moved, None, rec.chunk_id)
            parts[rid].append(self._ride(p, dst, reqs[rid].home))
        return meas

    def _persist(self, store, rec, moved: torch.Tensor) -> None:
        if rec.home >= 0 and store.resident_on(rec.chunk_id, rec.home):
            self._pool[(rec.chunk_id, rec.home)] = moved
            store.set_replica_data(rec.chunk_id, rec.home, moved)
            # the index sidecar moves with the cache bytes (keys derive
            # from the latent band only, which the splice leaves alone)
            keys = store.lookup(rec.chunk_id).index_keys
            if keys is not None:
                store.set_replica_index_keys(rec.chunk_id, rec.home, keys)

    def _gather_inputs(self, store, rec, sel):
        """FETCH under selection: (rows chosen, source, destination, the
        source's copy), or None when the indexer chose nothing here."""
        # fetch_replica under selection is unreachable by construction:
        # replica spawns batch only DENSE fan-in overflow
        if rec.primitive != "fetch":
            raise RuntimeError(
                f"selection fetch arrived as {rec.primitive!r}: replica "
                "spawns must never batch selected requests")
        idx = np.nonzero(np.asarray(sel.masks[rec.chunk_id]))[0]
        if idx.size == 0:
            return None
        src = fetch_source(rec)
        dst = rec.home if rec.home >= 0 else rec.holder
        return idx, src, dst, self._committed_copy(store, rec.chunk_id, src)

    def _identity_at(self, inst: int, q: torch.Tensor) -> Partial:
        with self.mesh.on(inst):
            return Partial.identity(q.shape[:-1], self.cfg.kv_lora_rank,
                                    device=self.mesh.device_of(inst))

    def _exec_fetch_selected_mesh(self, store, rec, q_of, parts, sel,
                                  reqs) -> Dict[str, float]:
        """FETCH under selection: core.splice.fetch_scattered_gather — pull
        ONLY the chosen rows at canonical positions (no splice), attend at
        the requester, persist nothing."""
        mesh = self.mesh
        rid = rec.req_ids[0]
        home = reqs[rid].home
        got = self._gather_inputs(store, rec, sel)
        if got is None:
            parts[rid].append(self._identity_at(home, q_of(rid)))
            return {"gather": 0.0}
        idx, src, dst, ckv = got
        ix = mesh.put(idx, src)
        with mesh.on(dst):
            pool = torch.empty((int(idx.size), ckv.shape[1]),
                               dtype=ckv.dtype, device=mesh.device_of(dst))
        gathered, dt = self._staged(
            "gather", ("fetch-gather",) + _sig(pool, ckv),
            lambda: fetch_scattered_gather(mesh, pool, ckv, ix, 0, self.cfg,
                                           src, dst), [dst])
        p = self._partial(dst, q_of(rid, dst), gathered, None, rec.chunk_id)
        parts[rid].append(self._ride(p, dst, home))
        return {"gather": dt}

    # -- LOCAL --------------------------------------------------------------

    def _exec_local_mesh(self, rec, q_of, parts, sels, reqs,
                         staged) -> Dict[str, float]:
        """Re-prefill on each requester's own instance (no wire), over the
        chunk's array on its card."""
        total = 0.0
        for rid in rec.req_ids:
            inst = reqs[rid].home
            arr = staged[("arr", rec.chunk_id, inst)]
            q, sel = q_of(rid), sels.get(rid)
            out, dt = self._staged(
                "prefill", ("prefill", sel is None) + _sig(q, arr),
                lambda: self._partial(inst, q, arr, sel, rec.chunk_id),
                [inst])
            total += dt
            parts[rid].append(out)
        return {"prefill": total}

    # =======================================================================
    # Fused: every group issued on the instances' streams, one barrier.
    # =======================================================================

    @staticmethod
    def _record_resources(rec) -> List:
        """The plan's resource bindings for one dispatch group — the same
        (link, fabric) wire and SM keys build_timeline binds. Two groups
        sharing any of these are ORDERED on the device; groups sharing
        none are independent and their queue wait must not be billed as
        execution."""
        res: List = []
        if rec.link_instance >= 0:
            res.append(TL.link(rec.link_instance, rec.fabric_idx))
        requester = rec.home if rec.home >= 0 else rec.holder
        res.append(TL.sm(rec.holder))
        if requester != rec.holder:
            res.append(TL.sm(requester))
        return res

    def _apportion(self, rec, wall: float, sel_times,
                   step: int) -> Dict[str, float]:
        """Spread one group's measured wall over the record's planned stage
        ratios, so the per-stage measured breakdown survives fusion. The
        "index" stage is excluded from the base — its wall was measured at
        PLAN time by the selector's scoring collective. An all-zero
        planned base falls back to an even split, counted as a fill."""
        names = [n for n, _ in rec.stages]
        meas: Dict[str, float] = {}
        if "index" in names:
            meas["index"] = float(sel_times.get(
                (step, rec.req_ids[0], rec.chunk_id), 0.0))
        rest = [(n, d) for n, d in rec.stages if n != "index"]
        total = sum(d for _, d in rest)
        if rest:
            if total > 0:
                for n, d in rest:
                    meas[n] = wall * (d / total)
            else:
                self._count_fill(rec, len(rest))
                for n, _ in rest:
                    meas[n] = wall / len(rest)
        if set(meas) != set(names):
            raise RuntimeError(f"apportioning {rec.primitive}:"
                               f"{rec.chunk_id} missed stages "
                               f"{set(names) ^ set(meas)}")
        return meas

    def _submit_overlapped(self, engine: "ServingEngine", plan: StepPlan,
                           t_wall0: float) -> dict:
        """STACK + DISPATCH of the fused path, detached from the barrier:
        returns the launch context _await_overlapped finishes. Everything
        here reads only plan-time state — residency was committed by
        plan_step, and replica bytes a prior in-flight step has not
        persisted yet resolve to canonical bytes via _array_on (identical
        content under delta-0 replication)."""
        store = engine.store
        mesh = self.mesh
        reqs = {rq.req_id: rq for rq in plan.requests}
        sels = plan.selections

        # -- STACK: every group's inputs, built on the instances they
        # belong to -------------------------------------------------------
        t0 = time.perf_counter()
        staged = self._prepare(engine, plan)

        def q_of(rid: int, inst: Optional[int] = None) -> torch.Tensor:
            """The request's queries on instance inst's card (its home's
            when None), as _prepare staged them."""
            return staged[("q", rid, reqs[rid].home if inst is None
                           else inst)]

        origins = mesh.begin()
        preps = []
        for i, rec in enumerate(plan.records):
            if rec.backup or not rec.req_ids:
                continue
            if rec.primitive == "route":
                prep = self._prep_route(store, rec, q_of, sels, reqs)
            elif rec.primitive in ("fetch", "fetch_replica"):
                if rec.req_ids[0] in sels:
                    prep = self._prep_fetch_selected(
                        store, rec, q_of, sels[rec.req_ids[0]], reqs)
                else:
                    prep = self._prep_fetch(store, rec, q_of, reqs)
            else:
                prep = self._prep_local(rec, q_of, sels, reqs, staged)
            preps.append((i, rec, prep))
        t_stack = time.perf_counter() - t0

        # -- DISPATCH: resident attends, then every group in record order,
        # with NO host synchronize ------------------------------------------
        t0 = time.perf_counter()
        parts: Dict[int, List[Partial]] = defaultdict(list)
        self._resident(store, plan, q_of, parts)
        tasks = []
        for i, rec, (key, issue, post) in preps:
            self._warmed(key, issue)
            starts, out, stops = issue()
            tasks.append((i, rec, out, post, starts, stops))
        t_dispatch = time.perf_counter() - t0
        return {"parts": parts, "tasks": tasks, "origins": origins,
                "reqs": reqs, "t_wall0": t_wall0, "t_stack": t_stack,
                "t_dispatch": t_dispatch}

    def _await_overlapped(self, engine: "ServingEngine", plan: StepPlan,
                          state: dict) -> StepExecution:
        """BARRIER (one synchronize) then MERGE/account: each group's wall,
        from the CUDA events at its first and last op, net of queueing
        behind groups that share a wire or an SM, apportioned over its
        planned stage ratios; the posts (slice, persist), then each
        request's merge on its home instance."""
        mesh = self.mesh
        parts, tasks = state["parts"], state["tasks"]
        origins: Origins = state["origins"]
        # fills only happen here, and the engine drains tickets FIFO, so
        # resetting keeps _report per-step with several submits in flight
        self._fill_count = 0

        t0 = time.perf_counter()
        mesh.synchronize()
        t_barrier = time.perf_counter() - t0

        t0 = time.perf_counter()
        sel_times = getattr(engine.selector, "measured_index_s",
                            None) or {}
        measured_flows: List[TL.Flow] = []
        log: List[dict] = []
        last_done: Dict[Any, float] = {}
        for i, rec, out, post, starts, stops in tasks:
            # each stamp from its own slot's origin (Origins.since): a ROUTE
            # group starts on the holder's slot and stops on the requesters'
            t_launch = min(origins.since(s) for s in starts)
            t_done = max(origins.since(s) for s in stops)
            resources = self._record_resources(rec)
            t_ready = max([t_launch]
                          + [last_done.get(r, 0.0) for r in resources])
            wall = max(t_done - t_ready, 1e-9)
            for r in resources:
                last_done[r] = max(last_done.get(r, 0.0), t_done)
            if rec.stages:
                meas = self._apportion(rec, wall, sel_times, plan.step)
                measured_flows.append(self._measured_flow(rec, i, meas,
                                                          plan))
                log += [dict(e, group_s=wall)
                        for e in self._log(rec, i, plan, meas)]
            post(out, parts)
        outputs = self._merge_requests(parts, state["reqs"])
        mesh.join()
        outputs = self._landed(outputs)
        self._keep_log(plan.step, log, origins)
        analytic = analytic_timeline(plan)
        report = self._report(plan, analytic, measured_flows,
                              state["t_wall0"], "fused")
        self.phase_wall = {"stack": state["t_stack"],
                           "dispatch": state["t_dispatch"],
                           "barrier": t_barrier,
                           "merge": time.perf_counter() - t0}
        for k, v in self.phase_wall.items():
            self.phase_wall_total[k] = self.phase_wall_total.get(k, 0.0) + v
        return StepExecution(timeline=analytic, outputs=outputs,
                             backend=self.name, measured=report)

    # -- fused per-primitive preps ------------------------------------------
    # Each returns (key, issue, post): issue() puts the group's device work
    # on the instances' streams and returns (start stamps, out, stop
    # stamps) — the events at its first and last ops; key names its warm
    # run; post(out, parts) runs after the barrier and only slices,
    # persists and appends.

    def _prep_route(self, store, rec, q_of, sels, reqs):
        mesh = self.mesh
        ckv, sel, qs, homes = self._route_inputs(store, rec, q_of, sels,
                                                 reqs)
        holder, chunk_id = rec.holder, rec.chunk_id

        if len(set(homes)) == 1:
            # one home: ship -> compute -> return back to back (the probe
            # existed only to time the wire floor; apportioning keeps its
            # share of the group's wall)
            requester = homes[0]
            stacked = self._stack(requester, qs)
            shards = [None] * mesh.n
            shards[requester] = stacked

            def issue():
                mesh.after(holder, requester)
                starts = [mesh.stamp(holder)]
                shipped = pairwise_ship(mesh, shards, holder, requester)
                held = [None] * mesh.n
                held[holder] = self._partial(holder, shipped[holder], ckv,
                                             sel, chunk_id)
                back = pairwise_return(mesh, held, holder, requester)
                return starts, back[requester], [mesh.stamp(requester)]

            def post(merged, parts):
                off = 0
                for rid, q in zip(rec.req_ids, qs):
                    parts[rid].append(self._slice(merged, off, q.shape[0]))
                    off += q.shape[0]
            return (("route-pair", sel is None) + _sig(stacked, ckv),
                    issue, post)

        # requesters span homes: gather -> compute -> exchange -> merge
        blocks, slices = self._fan_blocks(rec, qs, homes)
        fan_homes = sorted(blocks)
        shards = [blocks.get(i) for i in range(mesh.n)]

        def issue():
            for h in fan_homes:
                mesh.after(holder, h)
            starts = [mesh.stamp(holder)]
            gathered = fanout_gather(mesh, shards, to=[holder])
            held = [None] * mesh.n
            held[holder] = self._partial(holder, gathered[holder], ckv, sel,
                                         chunk_id)
            ex = fanout_exchange(mesh, held, to=fan_homes)
            merged = {h: merge_on(mesh, h, ex[h]) for h in fan_homes}
            return starts, merged, [mesh.stamp(h) for h in fan_homes]

        def post(merged, parts):
            for rid in rec.req_ids:
                home, start, n = slices[rid]
                parts[rid].append(self._slice(merged[home], start, n))
        return (("route-fan", sel is None) + _sig(blocks[fan_homes[0]], ckv),
                issue, post)

    def _prep_fetch(self, store, rec, q_of, reqs):
        mesh = self.mesh
        src = fetch_source(rec)
        dst = rec.home if rec.home >= 0 else rec.holder
        ckv = self._committed_copy(store, rec.chunk_id, src)
        with mesh.on(dst):
            pool = torch.empty(ckv.shape, dtype=ckv.dtype,
                               device=mesh.device_of(dst))

        def issue():
            mesh.after(dst, src)
            starts = [mesh.stamp(dst)]
            # the pull and the delta-0 splice: one delta_rotate launch from
            # the holder's rows into the requester's pool rows (within one
            # slot; between slots the pull, then the splice in place)
            moved = fetch_chunk(mesh, pool, ckv, 0, 0, self.cfg, src, dst)
            attends, stops = [], [None]
            for rid in rec.req_ids:
                p = self._partial(dst, q_of(rid, dst), moved, None,
                                  rec.chunk_id)
                home = reqs[rid].home
                if home != dst:
                    # the partial (not the cache) rides home, so every
                    # partial of a request merges on ONE instance
                    p = self._ride(p, dst, home)
                    stops.append(mesh.stamp(home))
                attends.append((rid, p))
            stops[0] = mesh.stamp(dst)
            return starts, (moved, attends), stops

        def post(out, parts):
            moved, attends = out
            self._persist(store, rec, moved)
            for rid, p in attends:
                parts[rid].append(p)
        return ("fetch",) + _sig(ckv), issue, post

    def _prep_fetch_selected(self, store, rec, q_of, sel, reqs):
        mesh = self.mesh
        rid = rec.req_ids[0]
        home = reqs[rid].home
        got = self._gather_inputs(store, rec, sel)
        if got is None:
            def empty():
                stamp = [mesh.stamp(home)]
                return stamp, self._identity_at(home, q_of(rid)), stamp
            return (("fetch-empty",), empty,
                    lambda p, parts: parts[rid].append(p))
        idx, src, dst, ckv = got
        ix = mesh.put(idx, src)
        with mesh.on(dst):
            pool = torch.empty((int(idx.size), ckv.shape[1]),
                               dtype=ckv.dtype, device=mesh.device_of(dst))

        def issue():
            starts = [mesh.stamp(src)]
            gathered = fetch_scattered_gather(mesh, pool, ckv, ix, 0,
                                              self.cfg, src, dst)
            p = self._ride(self._partial(dst, q_of(rid, dst), gathered, None,
                                         rec.chunk_id), dst, home)
            return starts, p, [mesh.stamp(home)]
        return (("fetch-gather",) + _sig(pool, ckv), issue,
                lambda p, parts: parts[rid].append(p))

    def _prep_local(self, rec, q_of, sels, reqs, staged):
        mesh = self.mesh
        items = [(rid, reqs[rid].home, q_of(rid), sels.get(rid))
                 for rid in rec.req_ids]
        arrs = {inst: staged[("arr", rec.chunk_id, inst)]
                for _, inst, _, _ in items}

        def issue():
            starts, outs, stops = [], [], []
            for rid, inst, q, sel in items:
                starts.append(mesh.stamp(inst))
                outs.append((rid, self._partial(inst, q, arrs[inst], sel,
                                                rec.chunk_id)))
                stops.append(mesh.stamp(inst))
            return starts, outs, stops

        def post(outs, parts):
            for rid, p in outs:
                parts[rid].append(p)
        key = ("prefill",) + tuple((sel is None,) + _sig(q)
                                   for _, _, q, sel in items) \
            + _sig(next(iter(arrs.values())))
        return key, issue, post
