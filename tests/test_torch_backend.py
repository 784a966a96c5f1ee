"""Port parity through the scheduler: TorchExecBackend (on the CPU, where its
kernels take their plain versions) against JaxExecBackend on the frozen
scenarios of tests/engine_scenarios.py, rebuilt with the port's engine.

Both backends get the same state: the same numpy chunk arrays attached to
both stores before step 1 (repro_torch.convert.chunks_from_numpy) and the
same numpy queries (TorchExecBackend's query_source; a test-local
JaxExecBackend subclass overriding query_of). Then:

* per-request o and m agree within 1e-6 absolute, l within 1e-6 relative
  (an unnormalised sum that grows with the chunk length) at the TINY_MLA
  geometry; at V2-Lite width (d_qk = 576) the logits are 576-term dot
  products summed in another order by each package, and the tolerance is
  the reference kernels' own at that width, 5e-6 absolute and 1e-5
  relative (tests/test_kernels.py:68);
* StepStats.comparable() is bit-identical to the JAX package's
  AnalyticBackend on the same EngineConfig.
"""

import dataclasses
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_scenarios as jax_scenarios
from repro.serving import engine as JE
from repro.serving.backends import AnalyticBackend as JaxAnalytic
from repro.serving.backends import JaxExecBackend
from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA
from repro_torch.convert import chunks_from_numpy
from repro_torch.serving import engine as TE
from repro_torch.serving.backends.torch_exec import (
    TINY_MLA, TorchExecBackend, chunk_array, fetch_source, max_oracle_err,
    oracle_partial, query_for)

TOL = 1e-6


def _port_scenarios():
    """tests/engine_scenarios.py with the port's engine in place of the
    reference's: one source for the frozen traces."""
    src = pathlib.Path(jax_scenarios.__file__).read_text().replace(
        "from repro.serving.engine", "from repro_torch.serving.engine")
    mod = types.ModuleType("torch_engine_scenarios")
    exec(compile(src, "torch_engine_scenarios", "exec"), mod.__dict__)
    return mod.SCENARIOS


TORCH_SCENARIOS = _port_scenarios()


def _query_source(cfg):
    def source(rq, step):
        seed = rq.req_id if rq.query_seed is None else rq.query_seed
        rng = np.random.default_rng([seed, step])
        return rng.standard_normal(
            (rq.m_q, cfg.n_heads, cfg.d_qk)).astype(np.float32)
    return source


class InjectedJaxExec(JaxExecBackend):
    """The reference backend fed the test's numpy queries."""

    def __init__(self, cfg, source):
        super().__init__(cfg)
        self.source = source

    def query_of(self, rq, step):
        return jnp.asarray(self.source(rq, step))


def _chunk_arrays(steps, store, cfg, seed=0):
    ids = sorted({c for reqs in steps for rq in reqs for c in rq.chunk_ids})
    rng = np.random.default_rng(seed)
    return {c: rng.standard_normal((store.lookup(c).length, cfg.d_qk))
            .astype(np.float32) for c in ids}


def _assert_parity(j_eng, t_eng, a_eng, steps, atol=TOL, rtol=TOL):
    for step, reqs in enumerate(steps, start=1):
        jo, to = j_eng.outputs_of(step), t_eng.outputs_of(step)
        assert sorted(jo) == sorted(to)
        for rid in jo:
            for k, tol in (("o", (atol, 0)), ("m", (atol, 0)),
                           ("l", (0, rtol))):
                np.testing.assert_allclose(
                    getattr(to[rid], k).numpy(), np.asarray(getattr(jo[rid], k)),
                    atol=tol[0], rtol=tol[1])
    assert [s.comparable() for s in t_eng.stats] \
        == [s.comparable() for s in a_eng.stats]
    assert [r.primitive for r in t_eng.log] == [r.primitive for r in a_eng.log]


def _drive(build_jax, build_torch, cfg):
    source = _query_source(cfg)
    a_eng, steps = build_jax(JaxAnalytic())
    j_eng, _ = build_jax(InjectedJaxExec(cfg, source))
    t_eng, t_steps = build_torch(
        TorchExecBackend(cfg, device="cpu", query_source=source))
    arrays = _chunk_arrays(steps, j_eng.store, cfg)
    for cid, arr in arrays.items():
        j_eng.store.attach_data(cid, jnp.asarray(arr))
    chunks_from_numpy(t_eng.store, arrays, device="cpu")
    for reqs, t_reqs in zip(steps, t_steps):
        a_eng.schedule_step(reqs)
        j_eng.schedule_step(reqs)
        t_eng.schedule_step(t_reqs)
    return j_eng, t_eng, a_eng, steps


@pytest.mark.parametrize("name", sorted(jax_scenarios.SCENARIOS))
def test_scenario_parity_tiny(name):
    j_eng, t_eng, a_eng, steps = _drive(jax_scenarios.SCENARIOS[name],
                                        TORCH_SCENARIOS[name], TINY_MLA)
    _assert_parity(j_eng, t_eng, a_eng, steps)


def _short_world(ns):
    """A V2-Lite-width world with short chunks: routed groups, a FETCH that
    persists and is then resident, and several chunks per request."""
    def build(backend):
        eng = ns.ServingEngine(4, pool_tokens=10**5, cfg=ns.EngineConfig(),
                               instances_per_pod=2, backend=backend)
        for i in range(4):
            eng.register_chunk(f"s{i}", holder=i, length=48 + 16 * i)
        fetchy = ns.Request(9, home=0, chunk_ids=["s3"], m_q=1,
                            expected_reuse_steps=100_000)
        steps = [[ns.Request(0, home=0, chunk_ids=["s1", "s2"], m_q=2),
                  ns.Request(1, home=3, chunk_ids=["s1"], m_q=3), fetchy],
                 [ns.Request(0, home=0, chunk_ids=["s1", "s2"], m_q=2),
                  ns.Request(2, home=1, chunk_ids=["s0", "s3"], m_q=1),
                  fetchy]]
        return eng, steps
    return build


def test_v2_lite_width_parity():
    j_eng, t_eng, a_eng, steps = _drive(_short_world(JE), _short_world(TE),
                                        V2_LITE_MLA)
    assert {"route", "fetch"} <= {r.primitive for r in a_eng.log}
    _assert_parity(j_eng, t_eng, a_eng, steps, atol=5e-6, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(TORCH_SCENARIOS))
def test_generated_state_matches_own_oracle(name):
    """Without injected state the backend materializes its own chunks and
    queries; every request matches the plain single-instance oracle."""
    eng, steps = TORCH_SCENARIOS[name](TorchExecBackend(device="cpu"))
    for reqs in steps:
        eng.schedule_step(reqs)
        assert max_oracle_err(eng, reqs, eng.step_idx) <= TOL


def test_fetch_persists_exact_replica_then_serves_resident():
    eng = TE.ServingEngine(4, pool_tokens=10**5,
                           backend=TorchExecBackend(device="cpu"))
    eng.register_chunk("doc", holder=1, length=64)
    rq = TE.Request(0, home=0, chunk_ids=["doc"], m_q=2,
                    expected_reuse_steps=100_000)
    assert [r.primitive for r in eng.schedule_step([rq])] == ["fetch"]
    rep = eng.store.array_on("doc", 0)
    assert rep is not None and rep.shape == (64, TINY_MLA.d_qk)
    assert torch.equal(rep, eng.store.lookup("doc").data)   # delta-0 splice
    assert eng.schedule_step([rq]) == []                   # resident now
    assert max_oracle_err(eng, [rq], eng.step_idx) <= TOL


def test_exactness_survives_holder_failure_and_promotion():
    eng = TE.ServingEngine(4, pool_tokens=10**5,
                           backend=TorchExecBackend(device="cpu"))
    eng.register_chunk("doc", holder=1, length=32)
    rq = TE.Request(0, home=0, chunk_ids=["doc"], m_q=4)
    eng.schedule_step([rq])
    assert eng.fail_instance(1) == ["doc"]
    assert [r.primitive for r in eng.schedule_step([rq])] == ["local"]
    assert max_oracle_err(eng, [rq], eng.step_idx) <= TOL

    eng, steps = TORCH_SCENARIOS["fetch_heavy"](TorchExecBackend(device="cpu"))
    eng.schedule_step(steps[0])            # FETCHes persist replicas on 0
    assert eng.fail_instance(1) == []      # doc0 promoted, not orphaned
    assert eng.store.lookup("doc0").holder == 0
    rq = TE.Request(7, home=3, chunk_ids=["doc0"], m_q=4)
    eng.schedule_step([rq])
    assert max_oracle_err(eng, [rq], eng.step_idx) <= TOL


def test_deterministic_materialization_and_query_memo():
    a = chunk_array(TINY_MLA, "corpus_0001", 16, device="cpu")
    assert torch.equal(a, chunk_array(TINY_MLA, "corpus_0001", 16,
                                      device="cpu"))
    r1 = TE.Request(7, home=0, chunk_ids=["x"], m_q=3, query_seed=42)
    q5 = query_for(TINY_MLA, r1, 5, device="cpu")
    assert torch.equal(q5, query_for(TINY_MLA, r1, 5, device="cpu"))
    assert not torch.equal(q5, query_for(TINY_MLA, r1, 6, device="cpu"))

    b = TorchExecBackend(device="cpu")
    rq = TE.Request(3, home=0, chunk_ids=["c"], m_q=4)
    q1 = b.query_of(rq, 1)
    assert b.query_of(rq, 1) is q1
    twin = TE.Request(9, home=1, chunk_ids=["c"], m_q=4, query_seed=3)
    assert b.query_of(twin, 1) is q1
    b.query_of(rq, 2)
    assert (3, 1, 4) in b._qmemo
    b.query_of(rq, 4)
    assert (3, 1, 4) not in b._qmemo and (3, 4, 4) in b._qmemo
    assert (b.qmemo_hits, b.qmemo_misses) == (2, 3)


def test_fetch_source_resolution():
    rec = dataclasses.make_dataclass(
        "R", ["link_instance", "holder"])(link_instance=2, holder=5)
    assert fetch_source(rec) == 2
    rec = dataclasses.make_dataclass(
        "R", ["link_instance", "holder"])(link_instance=-1, holder=5)
    assert fetch_source(rec) == 5


def test_oracle_uses_the_backend_query():
    """oracle_partial with the backend's query equals the plain attention
    over the concatenated canonical chunks."""
    eng, steps = TORCH_SCENARIOS["routed_only"](TorchExecBackend(device="cpu"))
    eng.schedule_step(steps[0])
    rq = steps[0][0]
    q = eng.backend.fresh_query(rq, 1)
    want = oracle_partial(TINY_MLA, eng.store, rq, 1, q=q)
    got = eng.outputs_of(1)[rq.req_id]
    np.testing.assert_allclose(got.o.numpy(), want.o.numpy(), atol=TOL)
