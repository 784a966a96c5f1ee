"""The agentic workload (§1, §6.3): one large immutable document pinned as
a prefix, N concurrent sub-agents fork it copy-on-write, append private
suffixes, and every decode step attends the shared c^KV.

Demonstrates, with REAL attention math (single-card simulation of the
instance mesh; the partials are mla_decode launches on the card):
  * CoW forks: shared prefix + private suffix per agent;
  * per-step routed decode: each agent's query merges a partial from the
    document holder with its own suffix partial — exact vs a monolithic
    cache (§3.3);
  * the replication decision at the N~8 elbow: fan_in(chunk) drives the
    engine's replica spawn (the amortised-FETCH boundary, not the splice,
    governs the pure-prefix case — §6.3).

    PYTHONPATH=src python -m repro_torch.examples.agentic_fanout
"""

import torch

from repro_torch.core import predicate as P
from repro_torch.core.merge import merge2
from repro_torch.examples import device_of, parser
from repro_torch.models import mla as M
from repro_torch.serving.engine import Request, ServingEngine

CFG = M.MLAConfig(d_model=256, n_heads=8, kv_lora_rank=64,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
DOC_TOKENS = 512
N_AGENTS = 12
TOL = 1e-5       # routed fork decode against the monolithic cache, f32


def run(device="cuda", n_agents: int = N_AGENTS,
        doc_tokens: int = DOC_TOKENS) -> dict:
    dev = torch.device(device)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    params = M.MLA(CFG, dtype=torch.float32, device=dev, generator=gen(0))
    # the pinned document, prefilled once at canonical offset 0
    doc = 0.1 * torch.randn((1, doc_tokens, CFG.d_model), generator=gen(1),
                            device=dev)
    doc_pos = torch.arange(doc_tokens, device=dev)[None]
    doc_ckv = M.latent_cache_entries(params, CFG, doc, doc_pos)[0]

    eng = ServingEngine(n_instances=8, pool_tokens=1_000_000,
                        instances_per_pod=4)
    eng.register_chunk("pinned_codebase", holder=0, length=doc_tokens)

    print(f"document: {doc_tokens} tokens on instance 0; "
          f"{n_agents} sub-agents fork it CoW")
    errs = []
    for a in range(n_agents):
        fork = eng.store.fork("pinned_codebase", agent_instance=a % 8)
        # agent appends a private suffix (true prefix: delta = 0, the
        # splice elides — §6.3)
        suffix_len = 16 + 4 * a
        eng.store.append_suffix(fork.fork_id, suffix_len)
        sx = 0.1 * torch.randn((1, suffix_len, CFG.d_model),
                               generator=gen(10 + a), device=dev)
        spos = doc_tokens + torch.arange(suffix_len, device=dev)[None]
        suffix_ckv = M.latent_cache_entries(params, CFG, sx, spos)[0]

        # one decode step: query at the tail of the agent's fork
        qn, qr = M.project_q(params, CFG, sx[:, -1:], spos[:, -1:] + 1)
        q_abs = M.absorb_query(params, CFG, qn, qr)[:, 0]

        # routed: holder partial over the doc + local partial over suffix
        p_doc = M.absorbed_partial(CFG, q_abs, doc_ckv)       # at holder
        p_suf = M.absorbed_partial(CFG, q_abs, suffix_ckv)    # at agent
        merged = merge2(p_suf, p_doc)
        # oracle: one monolithic cache, the plain version
        mono = M.absorbed_partial_ref(
            CFG, q_abs, torch.cat([doc_ckv, suffix_ckv], dim=0))
        errs.append(float(torch.max(torch.abs(merged.o - mono.o))))

    print(f"routed fork decode vs monolithic cache, {n_agents} agents: "
          f"max|err| = {max(errs):.2e} (fp32 round-off)")
    assert max(errs) < TOL

    fan = eng.store.fan_in("pinned_codebase")
    replicate = P.replication_threshold(fan)
    print(f"fan-in on the pinned document: {fan} concurrent readers")
    print(f"replicate beyond the elbow? "
          f"{replicate} (elbow N={P.holder_fanout_cap()})")

    # drive the engine over MULTIPLE steps with all agents hammering the
    # doc: step 1 caps fan-in at the elbow and spawns a replica (amortised
    # FETCH); later steps see the replica resident and rebalance onto it
    reqs = [Request(req_id=a, home=(a % 7) + 1,
                    chunk_ids=["pinned_codebase"],
                    expected_reuse_steps=8) for a in range(n_agents)]
    steps = []
    for _ in range(3):
        eng.schedule_step(reqs)
        s = eng.stats[-1]
        print(f"engine step {s.step}: dispatches {s.primitives}, "
              f"{s.n_resident}/{s.n_pairs} resident, "
              f"critical path {s.latency_s*1e6:.0f}us")
        steps.append({"step": s.step, "primitives": dict(s.primitives),
                      "n_resident": s.n_resident, "n_pairs": s.n_pairs,
                      "latency_s": s.latency_s})
    holders = eng.store.holders_of("pinned_codebase")
    print(f"holders now: {holders} "
          f"(replica persisted past the N~{eng.cfg.fanin_cap} elbow)")
    return {"max_err": max(errs), "fan_in": fan, "replicate": replicate,
            "engine_steps": steps, "holders": list(holders)}


def main(argv=None) -> dict:
    args = parser("agentic_fanout").parse_args(argv)
    return run(device_of("agentic_fanout", args.device))


if __name__ == "__main__":
    main()
