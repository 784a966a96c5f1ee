"""Serving launcher of the port: a partitioned canonical c^KV store driven by
the ROUTE/FETCH/LOCAL predicate, with the analytic or the torch execution
backend:

    # plan + analytic timeline only (default)
    PYTHONPATH=src python -m repro_torch.launch.serve --instances 8 \
        --pods 2 --chunks 16 --agents 12 --steps 5

    # plan AND execute on the card at DeepSeek-V2-Lite width, verifying
    # §3.3 exactness against the plain single-instance oracle
    PYTHONPATH=src python -m repro_torch.launch.serve --backend exec \
        --exec-geometry v2-lite --verify --selection-frac 0

    # the same on the CPU (plain versions of the kernels)
    PYTHONPATH=src python -m repro_torch.launch.serve --backend exec \
        --device cpu --verify --selection-frac 0

    # the multi-instance backend: serving instance i on visible card
    # i % (cards), with its own stream, transports between them (peer
    # copies between cards), and a per-step measured-vs-analytic stage
    # report (--serial-exec: one timed call per stage instead of the
    # fused, overlapped path); it prints the placement first
    PYTHONPATH=src python -m repro_torch.launch.serve --backend shard_map \
        --exec-geometry v2-lite --verify --selection-frac 0 \
        --intra-fabric h100_nvlink4 --cross-fabric h100_ibgda

    # the §5.4 selection regime: the indexer scores and selects per step,
    # the exec backend attends the selected blocks (sparse_select), and
    # selection requests verify against the selection_k oracle
    PYTHONPATH=src python -m repro_torch.launch.serve --backend exec \
        --exec-geometry v2-lite --selection --selection-frac 0.5 \
        --selection-k 512 --verify --save-selection-trace /tmp/sel.json
    # ... and a recorded selection trace replays through the planner
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --selection-trace /tmp/sel.json

    # replay a saved trace (the SAME trace drives both backends)
    PYTHONPATH=src python -m repro_torch.launch.serve --save-trace /tmp/t.json
    PYTHONPATH=src python -m repro_torch.launch.serve --trace /tmp/t.json \
        --backend exec

Same flags and output as repro.launch.serve, plus --device and
--exec-geometry. The live indexer (--selection) materializes chunks and
queries as the exec backend does, on --device. Without a selector,
selection-regime sessions of the workload (--selection-frac > 0) are priced
as selection and executed dense, with the engine's warn-once notice, as in
the reference.
"""

import argparse

import numpy as np

from repro_torch.core.constants import Fabric, register_fabrics
from repro_torch.serving.engine import (EngineConfig, ServingEngine,
                                        transport_latencies)
from repro_torch.serving.workload import (WorkloadConfig, agentic_trace,
                                          materialize_trace, read_trace,
                                          register_corpus, save_trace)

# args whose values define the WORLD a trace was recorded against; a replay
# must reconstruct them from the trace's meta header, not trust the flags
TRACE_META_ARGS = ("instances", "pods", "chunks", "chunk_tokens",
                   "agents", "steps", "seed")
# a SELECTION trace additionally depends on the workload's selection knobs:
# k_selected flows into every selection dispatch's pricing and
# selection_frac decides WHICH sessions select — replaying with different
# values would silently produce different StepStats
SELECTION_META_ARGS = TRACE_META_ARGS + ("selection_k", "selection_frac")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="predicate-driven serving engine (plan/execute/account)")
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--chunk-tokens", type=int, default=2048)
    ap.add_argument("--agents", type=int, default=12,
                    help="concurrent agent sessions (fan-in N)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--pool-tokens", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=("analytic", "exec", "shard_map"),
                    default="analytic")
    ap.add_argument("--serial-exec", action="store_true",
                    help="shard_map backend: run dispatch groups through "
                         "the serial per-stage chain instead of the "
                         "fused/overlapped path (A/B debug knob)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="exec backends: where the arrays live (cuda runs "
                         "the hand-written kernels, cpu their plain "
                         "versions)")
    ap.add_argument("--exec-geometry", choices=("tiny", "v2-lite"),
                    default="tiny",
                    help="exec backends: array geometry — tiny (d_qk=24) or "
                         "DeepSeek-V2-Lite (H=16, d_qk=576, d_v=512)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="steps in flight between submit and account: 1 = "
                         "lockstep plan/execute/account, >= 2 plans step "
                         "N+1 speculatively while step N executes")
    ap.add_argument("--trace", default="",
                    help="replay a save_trace() JSON instead of generating")
    ap.add_argument("--save-trace", default="",
                    help="write the generated trace as JSON and run it")
    ap.add_argument("--verify", action="store_true",
                    help="exec backend: check outputs against the "
                         "single-instance attention oracle (§3.3)")
    ap.add_argument("--fabric-table", default="",
                    help="JSON fabric table (calibrate_fabric output) to "
                         "register before building the engine")
    ap.add_argument("--intra-fabric", default="tpu_ici")
    ap.add_argument("--cross-fabric", default="tpu_dcn")
    # §5.4 selection regime
    ap.add_argument("--selection", action="store_true",
                    help="run the distributed indexer service: score -> "
                         "select -> scatter-attend through the scheduler")
    ap.add_argument("--selection-k", type=int, default=2048,
                    help="per-request selection budget in tokens (the "
                         "workload's k_selected)")
    ap.add_argument("--selection-frac", type=float, default=0.1,
                    help="fraction of agent sessions in the selection "
                         "regime (workload generator)")
    ap.add_argument("--block-tokens", type=int, default=64,
                    help="NSA selection granularity (indexer block size)")
    ap.add_argument("--selection-trace", default="",
                    help="replay a recorded selection trace through the "
                         "planner (numpy-only) instead of live scoring")
    ap.add_argument("--save-selection-trace", default="",
                    help="with --selection: record the indexer's per-step "
                         "verdicts as JSON")
    # flight recorder
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event / Perfetto JSON of the "
                         "run: engine wall spans + planned (and, under "
                         "--backend shard_map, measured) timeline track "
                         "groups per step")
    ap.add_argument("--metrics-out", default="",
                    help="write the obs metrics registry snapshot "
                         "(counters/gauges/histograms) as JSON at exit")
    ap.add_argument("--drift-threshold", type=float, default=None,
                    help="enable the model-vs-measured drift monitor with "
                         "this |EWMA| envelope (one card partitioned into "
                         "instances is not the priced fabric: expect a very "
                         "loose value). Exits non-zero when a (primitive, "
                         "fabric, stage) cell trips. Requires a measuring "
                         "backend (shard_map)")
    return ap


def build_obs(args):
    """The flight recorder, from the CLI flags: None when every obs flag
    is off (the engine then keeps its inert NULL_OBS)."""
    if not (args.trace_out or args.metrics_out
            or args.drift_threshold is not None):
        return None
    from repro_torch.obs import DriftConfig, DriftMonitor, Obs, Tracer
    tracer = Tracer() if args.trace_out else None
    drift = (DriftMonitor(DriftConfig(threshold=args.drift_threshold))
             if args.drift_threshold is not None else None)
    return Obs(tracer=tracer, drift=drift)


def exec_geometry(args):
    """The MLA geometry the exec backend and the live indexer share."""
    if args.exec_geometry == "v2-lite":
        from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA
        return V2_LITE_MLA
    from repro_torch.serving.backends.torch_exec import TINY_MLA
    return TINY_MLA


def build_backend(args, devices=None):
    """The exec backend of --backend; the shard_map backend's mesh over
    `devices` (card slots; None: --device, where cuda is every visible
    card once)."""
    if args.backend == "exec":
        from repro_torch.serving.backends.torch_exec import TorchExecBackend
        return TorchExecBackend(exec_geometry(args), device=args.device)
    if args.backend == "shard_map":
        from repro_torch.serving.backends.shard_map import \
            ShardMapExecBackend
        return ShardMapExecBackend(exec_geometry(args), device=args.device,
                                   fused=not args.serial_exec,
                                   devices=devices)
    return None


def build_selector(args, devices=None):
    """The engine's selection seam: live indexer (--selection, on the exec
    geometry and device; under --backend shard_map on the backend's
    placement), recorded trace (--selection-trace, numpy-only), or None
    (selection requests are priced but executed dense — the engine warns
    once and counts them)."""
    if args.selection:
        from repro_torch.serving.selection import (IndexerService,
                                                   SelectionConfig,
                                                   ShardMapIndexerService)
        sel_cfg = SelectionConfig(block_tokens=args.block_tokens)
        if args.backend == "shard_map":
            return ShardMapIndexerService(sel_cfg, mla=exec_geometry(args),
                                          device=args.device,
                                          devices=devices)
        return IndexerService(sel_cfg, mla=exec_geometry(args),
                              device=args.device)
    if args.selection_trace:
        from repro_torch.serving.selection import ReplaySelector
        return ReplaySelector(args.selection_trace)
    return None


def build_engine(args, devices=None) -> ServingEngine:
    if args.fabric_table:
        register_fabrics(Fabric.load_table(args.fabric_table))
    return ServingEngine(
        args.instances, pool_tokens=args.pool_tokens,
        cfg=EngineConfig(intra_pod_fabric=args.intra_fabric,
                         cross_pod_fabric=args.cross_fabric,
                         pipeline_depth=args.pipeline_depth),
        instances_per_pod=max(1, args.instances // args.pods),
        backend=build_backend(args, devices),
        selector=build_selector(args, devices),
        obs=build_obs(args))


def apply_trace_meta(args, meta: dict, keys=TRACE_META_ARGS,
                     source: str = "--trace") -> None:
    """A replayed trace's chunk ids, homes and seeds only mean anything in
    the world they were recorded against: override the world-defining args
    from the trace's meta header."""
    for key in keys:
        if key in meta and meta[key] != getattr(args, key):
            print(f"[serve] {source} meta overrides "
                  f"--{key.replace('_', '-')}"
                  f": {getattr(args, key)} -> {meta[key]}")
            setattr(args, key, meta[key])


def build_trace(args, eng: ServingEngine, replay=None):
    """The per-step request lists: the pre-parsed --trace replay if given,
    else generated by the agentic workload."""
    wl = WorkloadConfig(n_steps=args.steps, agents=args.agents,
                        n_corpus_chunks=args.chunks,
                        chunk_tokens=args.chunk_tokens, seed=args.seed,
                        selection_frac=args.selection_frac,
                        k_selected=args.selection_k)
    cids = register_corpus(eng, wl)
    if replay is not None:
        return replay
    gen = agentic_trace(wl, eng, cids)
    if args.save_trace:
        meta = {key: getattr(args, key) for key in TRACE_META_ARGS}
        return save_trace(args.save_trace, gen, meta=meta)
    return materialize_trace(gen)


def main(argv=None, devices=None) -> ServingEngine:
    """Run the CLI; returns the engine (its stats, plans and outputs) for
    callers that drive it in-process. devices (in-process callers only)
    lists the shard_map mesh's card slots, one card as often as it should
    hold a slot; by default --device cuda spans every visible card once."""
    args = build_parser().parse_args(argv)
    if args.verify and args.backend not in ("exec", "shard_map"):
        raise SystemExit("--verify checks exec outputs against the §3.3 "
                         "oracle: it requires --backend exec or shard_map")
    if args.trace and args.save_trace:
        raise SystemExit("--save-trace records a GENERATED trace; it cannot "
                         "be combined with --trace (replay)")
    if args.selection and args.selection_trace:
        raise SystemExit("--selection scores live; it cannot be combined "
                         "with --selection-trace (replay)")
    if args.save_selection_trace and not args.selection:
        raise SystemExit("--save-selection-trace records the live "
                         "indexer's verdicts: it requires --selection")
    replay = None
    if args.trace:
        meta, replay = read_trace(args.trace)
        apply_trace_meta(args, meta)
    if args.selection_trace:
        # the selection trace defines its world too — including the
        # selection knobs, which flow into pricing
        from repro_torch.serving.selection import load_selection_trace
        sel_meta, _ = load_selection_trace(args.selection_trace)
        apply_trace_meta(args, sel_meta, keys=SELECTION_META_ARGS,
                         source="--selection-trace")
    eng = build_engine(args, devices)
    steps = build_trace(args, eng, replay)
    if args.backend == "shard_map":
        from repro_torch.core.instance_mesh import (describe_placement,
                                                    placement)
        print("[serve] " + describe_placement(
            args.instances,
            placement(args.device if devices is None else devices)))

    # reporting trails accounting: at --pipeline-depth >= 2 a scheduled
    # step may still be in flight when the loop moves on
    reported = [0]

    def report_accounted():
        while reported[0] < len(eng.stats):
            s = eng.stats[reported[0]]
            reqs = steps[reported[0]]
            recs = eng.plans[reported[0]].records
            line = (f"[serve] step {s.step}: {len(recs)} dispatches "
                    f"{s.primitives}, {s.n_resident}/{s.n_pairs} resident, "
                    f"makespan {s.latency_s*1e6:.0f}us")
            if eng.selector is not None:
                line += f", {s.n_selected} selected pairs"
            if args.verify:
                from repro_torch.serving.backends.torch_exec import \
                    max_oracle_err
                line += f", max|err| {max_oracle_err(eng, reqs, s.step):.2e}"
            print(line)
            report = eng.measured_reports[reported[0]]
            if report is not None:
                # the shard_map backend's measured-vs-analytic loop (§7)
                print("\n".join("[serve]   " + ln
                                for ln in report.summary().splitlines()))
                if args.backend == "shard_map":
                    from repro_torch.serving.backends.shard_map import \
                        peer_flows
                    print(f"[serve]   peer flows {peer_flows(report)}/"
                          f"{len(report.measured.flows)} (transfers "
                          f"between card slots)")
            reported[0] += 1

    depth = max(1, args.pipeline_depth)
    for i, reqs in enumerate(steps):
        eng.schedule_step(reqs)
        if depth >= 2 and i + 1 < len(steps):
            eng.speculate_step(steps[i + 1])
        report_accounted()
    eng.flush()
    report_accounted()
    if depth > 1:
        print(f"[serve] pipeline: depth {depth}, planner overlap hidden "
              f"{eng.planner_overlap_s*1e3:.2f}ms, "
              f"{eng.misspeculation_replans} replans")

    if args.save_selection_trace:
        from repro_torch.serving.selection import save_selection_trace
        save_selection_trace(args.save_selection_trace, eng.selector.log,
                             eng.selector.block_tokens, eng.selector.d_index,
                             meta={key: getattr(args, key)
                                   for key in SELECTION_META_ARGS})
        print(f"[serve] selection trace -> {args.save_selection_trace} "
              f"({len(eng.selector.log)} steps)")
    if eng.selector is not None:
        index_s = sum(s.stage_totals.get("index", 0.0) for s in eng.stats)
        mk = sum(s.latency_s for s in eng.stats)
        print(f"[serve] selection: selector={eng.selector.name}, "
              f"{sum(s.n_selected for s in eng.stats)} selected pairs, "
              f"indexer-stage share of makespan "
              f"{index_s / mk if mk else 0.0:.3f}")

    overview = eng.measured_overview()
    if overview is not None:
        print(f"[serve] exec: {overview}")
    lat = transport_latencies(eng.stats)
    n_route = sum(1 for r in eng.log if r.primitive == "route")
    print(f"[serve] backend={eng.backend.name}; total dispatches "
          f"{len(eng.log)}; route fraction "
          f"{n_route/max(1, len(eng.log)):.2f} (decode defaults to ROUTE, "
          f"§5.5); replicas spawned "
          f"{sum(s.replicas_spawned for s in eng.stats)}")
    if len(lat):
        print(f"[serve] p50 step latency {np.percentile(lat, 50)*1e6:.0f}us, "
              f"p99 {np.percentile(lat, 99)*1e6:.0f}us over {len(lat)} "
              "transporting steps")

    obs = eng.obs
    if obs.enabled:
        if args.trace_out and obs.tracer is not None:
            doc = obs.tracer.export(args.trace_out)
            print(f"[serve] trace -> {args.trace_out} "
                  f"({len(doc['traceEvents'])} events, "
                  f"{obs.tracer.n_steps} steps)")
        if args.metrics_out and obs.metrics is not None:
            obs.metrics.to_json(args.metrics_out)
            snap = obs.metrics.snapshot()
            print(f"[serve] metrics -> {args.metrics_out} "
                  f"({len(snap['counters'])} counters, "
                  f"{len(snap['gauges'])} gauges, "
                  f"{len(snap['histograms'])} histograms)")
        if obs.drift is not None:
            for ln in obs.drift.summary_lines():
                print(f"[serve] {ln}")
            if obs.drift.n_reports == 0:
                print("[serve] drift: no measured reports — the monitor "
                      "needs --backend shard_map")
            tripped = obs.drift.tripped()
            if tripped:
                raise SystemExit(
                    f"[serve] drift monitor TRIPPED: {len(tripped)} "
                    f"cell(s) past |ewma| > {obs.drift.config.threshold:g}")
            print(f"[serve] drift: OK ({len(obs.drift.cells)} cells within "
                  f"|ewma| <= {obs.drift.config.threshold:g})")
    return eng


if __name__ == "__main__":
    main()
