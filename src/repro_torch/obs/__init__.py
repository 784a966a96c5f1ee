"""repro.obs — the flight recorder.

One bundle, three organs:

* :class:`~repro.obs.trace.Tracer` — Chrome trace-event / Perfetto JSON
  spans: engine wall phases + planned/measured timeline track groups.
* :class:`~repro.obs.metrics.MetricsRegistry` — counters / gauges /
  streaming-percentile histograms for everything that decides behavior
  (decisions by verdict, bytes by fabric, planner cache hit rates, pool
  occupancy, eviction/promotion churn, indexer roundtrips, ...).
* :class:`~repro.obs.drift.DriftMonitor` — per-(primitive, fabric,
  stage) EWMA of measured-vs-analytic residuals; the §7 "~7% tracking"
  claim as a loud invariant.

Hot-path contract: the planner NEVER calls into this package. The engine
keeps plain-int cache counters (free either way) and hands everything to
``Obs.on_step`` once per step, from ``_account``, behind a single
``obs is not NULL_OBS`` check in ``schedule_step``. A run constructed
without an Obs pays one identity comparison per step — that is the
"disabled tracer costs near-zero" guarantee the planner bench guards.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.obs.drift import (DriftConfig, DriftError,  # noqa: F401
                             DriftMonitor)
from repro_torch.obs.metrics import MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import Tracer, validate_trace  # noqa: F401


class _NullObs:
    """The disabled singleton: identity-compared on the step path, never
    called. ``enabled`` is False so library code can branch cheaply."""

    __slots__ = ()
    enabled = False
    tracer = None
    metrics = None
    drift = None

    def bind_engine(self, engine) -> None:  # pragma: no cover - trivial
        pass

    def on_step(self, engine, plan, execution, stats, walls=None,
                overlap_s=0.0, replans=0) -> None:  # pragma: no cover
        pass


NULL_OBS = _NullObs()


class Obs:
    """Live observability bundle. Construct with the organs you want:

    >>> obs = Obs()                       # metrics only
    >>> obs = Obs(tracer=Tracer(), drift=DriftMonitor())

    and pass it to ``ServingEngine(..., obs=obs)`` (or let
    ``repro.launch.serve`` build it from ``--trace-out`` /
    ``--metrics-out`` / ``--drift-threshold``).
    """

    enabled = True

    def __init__(self, tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 drift: Optional[DriftMonitor] = None) -> None:
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.drift = drift
        self._bound_stores: set = set()

    # -- wiring ---------------------------------------------------------------

    def bind_engine(self, engine) -> None:
        """Attach the store-churn listeners. Called by ServingEngine's
        constructor; idempotent per store."""
        store = engine.store
        if id(store) in self._bound_stores:
            return
        self._bound_stores.add(id(store))
        m = self.metrics

        def _on_copy_retired(chunk_id: str, instance: int) -> None:
            m.counter("store.copy_retirements", instance=instance).inc()

        store.add_evict_listener(_on_copy_retired)

    # -- the one per-step hook ------------------------------------------------

    def on_step(self, engine, plan, execution, stats, walls=None,
                overlap_s=0.0, replans=0) -> None:
        """Fold one accounted step into every organ. Runs AFTER the step's
        sched_wall_s was measured, so even heavy exports here never show
        up in planner-throughput numbers. ``overlap_s`` is the planner
        wall this step demonstrably hid under the device barrier and
        ``replans`` the engine's cumulative misspeculation count — both
        zero outside pipelined mode."""
        from repro_torch.serving import timeline as TL

        m = self.metrics
        report = getattr(execution, "measured", None)
        timeline = execution.timeline

        # -- engine: decisions, latency, selection fallbacks ------------------
        m.counter("engine.steps").inc()
        m.counter("engine.pairs").inc(stats.n_pairs)
        m.counter("engine.pairs_priced").inc(stats.n_priced)
        m.counter("engine.pairs_resident").inc(stats.n_resident)
        for prim, n in stats.primitives.items():
            m.counter("engine.dispatches", primitive=prim).inc(n)
        m.counter("engine.replicas_spawned").inc(stats.replicas_spawned)
        m.counter("engine.evictions").inc(stats.evictions)
        if stats.selection_fallbacks:
            # the priced-vs-executed divergence is a
            # per-run counter now, not a once-per-process warning
            m.counter("engine.selection_fallbacks").inc(
                stats.selection_fallbacks)
        m.histogram("engine.step_latency_s").observe(stats.latency_s)
        m.histogram("engine.sched_wall_s").observe(stats.sched_wall_s)

        # -- pipeline ----------------------------------------------
        depth = max(1, getattr(engine.cfg, "pipeline_depth", 1))
        m.gauge("engine.pipeline_depth").set(depth)
        if depth > 1:
            m.histogram("engine.planner_overlap_s").observe(overlap_s)
            m.counter("engine.planner_overlap_s_total").inc(overlap_s)
            m.gauge("engine.misspeculation_replans").set(replans)

        # -- engine: bytes by fabric/link + §8 congestion ---------------------
        # model-implied wire bytes: duration x fabric bandwidth for every
        # scheduled wire stage except the pure-latency probe (the index
        # stage keeps its probe floor — documented in README's glossary)
        bw = engine._fa.bw_Bps
        fabric_names = engine._fa.names
        for s in timeline.scheduled:
            res = s.resource
            if res is None or res[0] != "link" or s.stage == "probe":
                continue
            fi = res[2]
            nbytes = (s.end_s - s.start_s) * float(bw[fi])
            m.counter("engine.wire_bytes", fabric=fabric_names[fi]).inc(
                nbytes)
            m.counter("engine.link_wire_bytes", instance=res[1],
                      fabric=fabric_names[fi]).inc(nbytes)
        link_counts = timeline.link_flow_counts()
        for k in link_counts.values():
            m.histogram("engine.link_flows").observe(float(k))
        congested = sum(1 for k in link_counts.values() if k >= 3)
        if congested:
            m.counter("engine.congested_links").inc(congested)

        # -- planner caches (cumulative -> gauges) ----------------------------
        for name, v in engine.planner_cache_stats().items():
            m.gauge(f"planner.cache.{name}").set(v)
        for name, v in TL.sim_memo_stats().items():
            m.gauge(f"planner.sim_memo.{name}").set(v)

        # -- chunk store occupancy --------------------------------------------
        store = engine.store
        for i in range(store.n_instances):
            used = store.used(i)
            side = store.sidecar_tokens_used(i)
            m.gauge("store.pool_used_tokens", instance=i).set(used)
            m.gauge("store.sidecar_tokens", instance=i).set(side)
        m.gauge("store.pool_tokens").set(store.pool_tokens)
        m.gauge("store.promotions").set(store.promotions)

        # -- backend telemetry ------------------------------------------------
        backend = engine.backend
        qh = getattr(backend, "qmemo_hits", None)
        if qh is not None:
            m.gauge("exec.query_memo.hit").set(qh)
            m.gauge("exec.query_memo.miss").set(
                getattr(backend, "qmemo_misses", 0))
        phase_total = getattr(backend, "phase_wall_total", None)
        if phase_total:
            for phase, secs in phase_total.items():
                m.gauge("exec.phase_wall_s", phase=phase).set(secs)
        if report is not None:
            if report.stage_fills:
                # stage-measurement gaps per-run, not
                # warn-once
                m.counter("exec.stage_fills").inc(report.stage_fills)
            m.gauge("exec.pool_entries").set(report.pool_entries)
            m.gauge("exec.pool_bytes").set(report.pool_bytes)
            m.histogram("exec.wall_s").observe(report.wall_s)
            ratio = report.makespan_ratio
            if ratio == ratio and ratio not in (float("inf"),):
                m.histogram("exec.measured_ratio").observe(ratio)

        # -- indexer service --------------------------------------------------
        sel = engine.selector
        counts = getattr(sel, "obs_counts", None)
        if counts:
            for name, v in counts.items():
                m.gauge(f"selector.{name}").set(v)
        sizes = getattr(sel, "drain_merge_sizes", None)
        if sizes is not None:
            for n in sizes():
                m.histogram("selector.merge_candidates").observe(float(n))

        # -- drift ------------------------------------------------------------
        if self.drift is not None and report is not None:
            self.drift.observe_report(report)

        # -- tracer -----------------------------------------------------------
        if self.tracer is not None:
            if walls is not None:
                t0, t1, t2, t3 = walls
                # in-flight steps overlap in wall time; give each a lane
                # (round-robin over depth) so Perfetto renders them as
                # parallel pid-0 tracks instead of one impossible track.
                # Depth 1 keeps the historical single "engine" track.
                track = "engine" if depth <= 1 \
                    else f"engine lane {(stats.step - 1) % depth}"
                self.tracer.wall_span("plan", t0, t1, track=track,
                                      step=stats.step)
                self.tracer.wall_span("execute", t1, t2, track=track,
                                      step=stats.step,
                                      backend=type(backend).__name__)
                self.tracer.wall_span("account", t2, t3, track=track,
                                      step=stats.step)
            self.tracer.add_step(
                stats.step, timeline,
                report.measured if report is not None else None)
