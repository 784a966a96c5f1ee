"""Serving driver: a partitioned canonical c^KV store served with the
predicate-driven engine (§5 consumed end-to-end).

Scenario (the paper's §1): a provider pre-prefills canonical chunks (case
law, annual reports) across 8 instances in 2 pods; tenants' decode steps
attend chunks that mostly live on OTHER instances. Watch the engine pick
ROUTE for decode, spawn a replica (amortised FETCH) when fan-in passes the
N~8 elbow, fire straggler backups, and survive a holder failure.

Control plane only (the engine prices its plans on the analytic timeline):
no array is made, so --device is only checked, as in the other examples.

    PYTHONPATH=src python -m repro_torch.examples.serve_routed
"""

import numpy as np

from repro_torch.examples import device_of, parser
from repro_torch.serving.engine import (Request, ServingEngine,
                                        transport_latencies)
from repro_torch.serving.workload import WorkloadConfig, agentic_trace


def run() -> dict:
    rng = np.random.RandomState(0)
    eng = ServingEngine(n_instances=8, pool_tokens=64 * 2048,
                        instances_per_pod=4)

    # canonical corpus: 12 chunks spread across instances
    chunks = []
    for i in range(12):
        cid = f"annual_report_{2014 + i}"
        eng.register_chunk(cid, holder=i % 8, length=2048)
        chunks.append(cid)

    print("=== steady-state decode: tenant sessions fan out (multi-step) ===")
    wl = WorkloadConfig(n_steps=24, agents=16, n_corpus_chunks=12,
                        session_steps=(8, 24), seed=0)
    # reuse the already-registered corpus ids as the working-set universe
    stats = eng.run(agentic_trace(wl, eng, chunks))
    for s in stats[:3] + stats[-2:]:
        print(f"step {s.step:>3}: {s.n_dispatches} dispatches "
              f"{s.primitives}, {s.n_resident}/{s.n_pairs} resident, "
              f"makespan {s.latency_s*1e6:.0f}us "
              f"(max-reduce {s.max_dispatch_s*1e6:.0f}us, overlap eff "
              f"{s.overlap_efficiency:.2f})")
    lat = transport_latencies(stats)     # empty steps carry no latency
    resident = sum(s.n_resident for s in stats[-8:]) / \
        max(1, sum(s.n_pairs for s in stats[-8:]))
    spawned = sum(s.replicas_spawned for s in stats)
    p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
    print(f"{len(stats)} steps: p50 {p50*1e6:.0f}us, "
          f"p99 {p99*1e6:.0f}us; steady residency "
          f"{resident:.0%} (fetches persisted + replicas spawned: "
          f"{spawned})")

    last = stats[-1]
    print(f"\n=== step {last.step} stage Gantt (wire serializes per "
          f"(link, fabric); independent stages overlap) ===")
    print(eng.timeline_of(last.step).gantt(max_flows=8))
    anatomy = " ".join(f"{k}={v*1e6:.0f}us"
                       for k, v in sorted(last.stage_totals.items()))
    print(f"  stage totals: {anatomy}\n  sum-of-stages "
          f"{last.serial_stage_s*1e6:.0f}us -> makespan "
          f"{last.latency_s*1e6:.0f}us "
          f"(overlap efficiency {last.overlap_efficiency:.2f})")

    print("\n=== hot chunk: 20 tenants hammer one document (§6.3) ===")
    hot = chunks[0]
    reqs = [Request(req_id=100 + t, home=(t % 7) + 1, chunk_ids=[hot], m_q=8)
            for t in range(20)]
    recs = eng.schedule_step(reqs)
    for r in recs:
        print(f"  {r.primitive:>14} holder={r.holder} n_req={r.n_requesters}"
              f" m_q={r.m_q_total} est={r.est_cost_s*1e6:.0f}us")
    hot_holders = eng.store.holders_of(hot)
    print(f"  holders of {hot} now: {hot_holders} "
          f"(replica spawned past the fan-in cap of "
          f"{eng.cfg.fanin_cap})")

    print("\n=== straggler: instance 2 runs 5x slow ===")
    eng.set_straggler(2, 5.0)
    victim = [c for c in chunks if eng.store.lookup(c).holder == 2][0]
    eng.store.add_replica(victim, 5)
    recs = eng.schedule_step([Request(200, home=0, chunk_ids=[victim],
                                      m_q=16)])
    for r in recs:
        tag = " (backup)" if r.backup else ""
        print(f"  {r.primitive:>14} holder={r.holder} "
              f"est={r.est_cost_s*1e6:.0f}us{tag}")
    straggler_s = eng.step_latency(eng.step_idx)
    print(f"  step makespan {straggler_s*1e6:.0f}us "
          f"(backup capped the straggler)")

    print("\n=== holder failure: instance 3 dies ===")
    orphaned = eng.fail_instance(3)
    print(f"  orphaned chunks (re-prefill via LOCAL): {orphaned}")
    live = [i.idx for i in eng.instances if i.alive]
    reqs = [Request(300 + t, home=int(rng.choice(live)),
                    chunk_ids=list(rng.choice(chunks, 2, replace=False)))
            for t in range(6)]
    recs = eng.schedule_step(reqs)
    assert all(r.holder != 3 for r in recs)
    print(f"  step after failure: {len(recs)} dispatches, none to the dead "
          f"instance; primitives used: {sorted({r.primitive for r in recs})}")
    return {"steps": len(stats), "p50_s": float(p50), "p99_s": float(p99),
            "steady_residency": resident, "replicas_spawned": spawned,
            "hot_holders": list(hot_holders), "straggler_step_s": straggler_s,
            "orphaned": list(orphaned), "after_failure_dispatches": len(recs)}


def main(argv=None) -> dict:
    args = parser("serve_routed").parse_args(argv)
    device_of("serve_routed", args.device)
    return run()


if __name__ == "__main__":
    main()
