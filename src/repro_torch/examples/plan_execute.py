"""Plan / execute / account, end to end.

ONE agentic trace drives the serving engine twice:

  1. AnalyticBackend — the planner's dispatch plans scheduled on the
     overlap-aware transport timeline (pure simulation, paper constants);
  2. TorchExecBackend — the SAME plans executed on real c^KV arrays:
     ROUTE ships the grouped query rows to the holder's copy (mla_decode),
     FETCH replicates the chunk through the delta-0 splice (delta_rotate)
     then serves locally, LOCAL re-prefills — every request's partials
     merge in one softmax_merge and its output is checked against
     single-instance attention over its concatenated chunks (the paper's
     §3.3 exactness claim, THROUGH the scheduler).

    PYTHONPATH=src python -m repro_torch.examples.plan_execute
"""

from repro_torch.examples import device_of, parser
from repro_torch.serving import (AnalyticBackend, EngineConfig,
                                 ServingEngine, WorkloadConfig, agentic_trace,
                                 materialize_trace, register_corpus)
from repro_torch.serving.backends.torch_exec import (TorchExecBackend,
                                                     max_oracle_err)

ATOL = 1e-5      # exec output against the single-instance oracle, f32


def workload(n_steps: int = 12, agents: int = 12) -> WorkloadConfig:
    return WorkloadConfig(n_steps=n_steps, agents=agents, n_corpus_chunks=10,
                          chunk_tokens=256, session_steps=(3, 10), seed=1)


def build(backend, wl: WorkloadConfig):
    eng = ServingEngine(n_instances=8, pool_tokens=48 * 256,
                        cfg=EngineConfig(), instances_per_pod=4,
                        backend=backend)
    cids = register_corpus(eng, wl)
    return eng, materialize_trace(agentic_trace(wl, eng, cids))


def run(device="cuda", n_steps: int = 12, agents: int = 12) -> dict:
    wl = workload(n_steps, agents)
    ana, steps = build(AnalyticBackend(), wl)
    exe, _ = build(TorchExecBackend(device=device), wl)

    print("=== one trace, two backends "
          "(plan is shared; execute is pluggable) ===")
    errs = []
    for reqs in steps:
        ana.schedule_step(reqs)
        exe.schedule_step(reqs)
        sa, se = ana.stats[-1], exe.stats[-1]
        # planner parity: identical decisions, identical analytic costs
        assert sa.primitives == se.primitives
        assert sa.latency_s == se.latency_s
        # exec exactness: outputs == single-instance attention (§3.3)
        worst = max_oracle_err(exe, reqs, exe.step_idx)
        assert worst <= ATOL, worst
        errs.append(worst)
        print(f"step {se.step:>2}: {se.n_dispatches} dispatches "
              f"{se.primitives}, {se.n_resident}/{se.n_pairs} resident, "
              f"makespan {se.latency_s*1e6:.0f}us | exec max|err| "
              f"{worst:.2e}")

    routes = sum(1 for r in exe.log if r.primitive == "route")
    fetches = sum(1 for r in exe.log
                  if r.primitive in ("fetch", "fetch_replica"))
    print(f"\n{len(exe.log)} dispatches executed on real arrays: "
          f"{routes} routed (query moved), {fetches} fetched (cache "
          f"moved + spliced); decisions identical across backends — the "
          f"predicate picked, both layers obeyed, outputs exact.")
    return {"steps": len(steps), "max_err": max(errs, default=0.0),
            "step_errs": errs, "dispatches": len(exe.log), "routed": routes,
            "fetched": fetches,
            "analytic_stats": [s.comparable() for s in ana.stats],
            "exec_stats": [s.comparable() for s in exe.stats]}


def main(argv=None) -> dict:
    args = parser("plan_execute").parse_args(argv)
    return run(device_of("plan_execute", args.device))


if __name__ == "__main__":
    main()
