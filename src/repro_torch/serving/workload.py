"""Trace-driven agentic workload generator (§1, §6.3).

Models the regime the paper motivates: IndexCache-style many-agents-one-
corpus fan-in. A provider pins canonical chunks across instances; agent
sessions arrive with a home instance and a Zipf-skewed working set of
corpus chunks, issue one decode step per engine step for the length of
their session, then depart (replaced, so concurrency — i.e. sustained
traffic — is constant). An agent's expected_reuse_steps is its remaining
session life: exactly the amortisation horizon FETCH needs (§5.5 rule 2),
so popular chunks replicate toward their readers over the run while
one-shot readers keep routing.

The trace is a plain iterator of per-step List[Request] — the engine's
run() drives it; bench_serving_steadystate.py measures it. Every Request
carries a deterministic query_seed (derived from the session id, no extra
RNG draws), so the SAME trace drives the analytic and the exec backend:
the analytic path ignores the seed, the exec path materializes the
request's query tensor from it. materialize_trace / save_trace /
load_trace snapshot a trace so both backends (or a later session) replay
the identical request stream.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch.serving.engine import Request, ServingEngine


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_steps: int = 128
    agents: int = 64                 # concurrent sessions (fan-in N)
    n_corpus_chunks: int = 24
    chunk_tokens: int = 2048
    chunks_per_request: int = 2      # chunks an agent attends per step
    zipf_a: float = 1.2              # corpus popularity skew
    m_q_choices: Sequence[int] = (1, 4, 8, 16)   # decode-shaped row counts
    session_steps: Sequence[int] = (8, 64)       # lifetime range, inclusive
    selection_frac: float = 0.1      # agents in the §5.4 selection regime
    k_selected: int = 2048
    seed: int = 0


def _zipf_probs(n: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
    return p / p.sum()


def register_corpus(engine: ServingEngine, cfg: WorkloadConfig) -> List[str]:
    """Pin the canonical corpus round-robin over the engine's instances."""
    n_inst = len(engine.instances)
    cids = []
    for i in range(cfg.n_corpus_chunks):
        cid = f"corpus_{i:04d}"
        engine.register_chunk(cid, holder=i % n_inst,
                              length=cfg.chunk_tokens)
        cids.append(cid)
    return cids


@dataclasses.dataclass
class _Session:
    req_id: int
    home: int
    working_set: List[str]
    m_q: int
    steps_left: int
    k_selected: int = -1             # -1 => dense regime


def agentic_trace(cfg: WorkloadConfig, engine: ServingEngine,
                  chunk_ids: Sequence[str]) -> Iterator[List[Request]]:
    """Yield cfg.n_steps per-step request lists, deterministic in cfg.seed."""
    rng = np.random.RandomState(cfg.seed)
    n_inst = len(engine.instances)
    probs = _zipf_probs(len(chunk_ids), cfg.zipf_a)
    next_id = [0]

    def spawn() -> _Session:
        k = min(cfg.chunks_per_request, len(chunk_ids))
        ws = list(rng.choice(chunk_ids, size=k, replace=False, p=probs))
        s = _Session(
            req_id=next_id[0],
            home=int(rng.randint(n_inst)),
            working_set=ws,
            m_q=int(rng.choice(cfg.m_q_choices)),
            steps_left=int(rng.randint(cfg.session_steps[0],
                                       cfg.session_steps[1] + 1)),
            k_selected=(cfg.k_selected
                        if rng.rand() < cfg.selection_frac else -1))
        next_id[0] += 1
        return s

    sessions = [spawn() for _ in range(cfg.agents)]
    for _ in range(cfg.n_steps):
        step: List[Request] = []
        for i, s in enumerate(sessions):
            step.append(Request(
                req_id=s.req_id, home=s.home,
                chunk_ids=list(s.working_set), m_q=s.m_q,
                expected_reuse_steps=max(1, s.steps_left),
                k_selected=None if s.k_selected < 0 else s.k_selected,
                # deterministic in the session id — no RNG draw, so the
                # request stream is identical with or without exec mode
                query_seed=cfg.seed * 1_000_003 + s.req_id))
            s.steps_left -= 1
            if s.steps_left <= 0:
                sessions[i] = spawn()    # departure + fresh arrival
        yield step


# ---------------------------------------------------------------------------
# Trace snapshots: one trace, many consumers (analytic vs exec backend,
# CLI replays, golden fixtures).
# ---------------------------------------------------------------------------

def materialize_trace(trace: Iterable[List[Request]]) -> List[List[Request]]:
    """Exhaust a trace iterator into a replayable list of steps (agentic_
    trace is a generator — the same object cannot drive two engines)."""
    return [list(step) for step in trace]


def save_trace(path: Union[str, pathlib.Path],
               trace: Iterable[List[Request]],
               meta: Optional[dict] = None) -> List[List[Request]]:
    """Write a trace as JSON (one dict per request); returns the
    materialized steps so the caller can keep driving them. `meta` rides
    along (corpus geometry, engine topology, seeds) so a replay can
    reconstruct the WORLD the trace was recorded against — chunk ids in
    a trace mean nothing if the corpus is registered differently."""
    steps = materialize_trace(trace)
    payload = {
        "meta": meta or {},
        "steps": [[dataclasses.asdict(rq) for rq in step]
                  for step in steps],
    }
    pathlib.Path(path).write_text(json.dumps(payload, indent=1) + "\n")
    return steps


def read_trace(path: Union[str, pathlib.Path]
               ) -> "tuple[dict, List[List[Request]]]":
    """One parse of a save_trace() JSON -> (meta, per-step Request lists).
    The bare-list pre-meta format is accepted too (meta = {})."""
    payload = json.loads(pathlib.Path(path).read_text())
    if isinstance(payload, dict):
        meta, raw = payload.get("meta", {}), payload["steps"]
    else:
        meta, raw = {}, payload
    return meta, [[Request(**rq) for rq in step] for step in raw]


def load_trace(path: Union[str, pathlib.Path]) -> List[List[Request]]:
    """Just the steps of a saved trace."""
    return read_trace(path)[1]


def trace_meta(path: Union[str, pathlib.Path]) -> dict:
    """Just the meta header of a saved trace."""
    return read_trace(path)[0]
