"""The multi-instance backend (ShardMapExecBackend over an InstanceMesh) on
the CPU, where the mesh has no streams and the kernels take their plain
versions, in both modes (fused: every group issued, one barrier; serial:
one timed call per stage).

* Against the JAX package's JaxExecBackend on the three dense goldens, the
  selection scenario and a V2-Lite-width world, fed the same numpy chunks
  and queries: per-request o and m within 2e-6 absolute and l within 2e-6
  relative at TINY_MLA, 5e-6 / 1e-5 at d_qk = 576 (the reference kernels'
  tolerances, tests/test_kernels.py:40,68). Not against the JAX package's
  own shard_map backend, whose test fails here undiagnosed.
* StepStats.comparable() equal, bit for bit, to an AnalyticBackend run on
  the same EngineConfig, at pipeline depths 1, 2 and 4.
* Fused against serial within 1e-6 (the same plain ops on the same
  inputs), on the goldens and on agentic workloads of three seeds.
* No filled stage, and measured flows that match the analytic schedule
  flow for flow and stage for stage (keys, names, resources).
* A dead holder mid-run: outputs still meet the oracle through the
  promoted replica, and the committed-copy pool holds only live copies.
* The serve CLI with --backend shard_map, fused and --serial-exec.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_scenarios as jax_scenarios
from repro.serving.backends import AnalyticBackend as JaxAnalytic
from repro.serving.selection import ReplaySelector as JaxReplay
from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA
from repro_torch.convert import chunks_from_numpy
from repro_torch.launch import serve
from repro_torch.serving import engine as TE
from repro_torch.serving.backends import AnalyticBackend
from repro_torch.serving.backends.shard_map import ShardMapExecBackend
from repro_torch.serving.backends.torch_exec import TINY_MLA, max_oracle_err
from repro_torch.serving.selection import (SelectionConfig,
                                           ShardMapIndexerService,
                                           selection_trace_payload)
from repro_torch.serving.workload import (WorkloadConfig, agentic_trace,
                                          materialize_trace, register_corpus)
from test_torch_backend import (InjectedJaxExec, TORCH_SCENARIOS, JE,
                                _assert_parity, _chunk_arrays,
                                _query_source, _short_world)
from test_torch_selection import InjectedJaxIndexer, torch_selection_scenario

TOL = 2e-6
MODES = pytest.mark.parametrize("fused", [True, False],
                                ids=["fused", "serial"])


def _mesh_backend(cfg, fused, source=None):
    return ShardMapExecBackend(cfg, device="cpu", query_source=source,
                               fused=fused)


# ---------------------------------------------------------------------------
# (a) against JaxExecBackend
# ---------------------------------------------------------------------------

def _drive(build_jax, build_torch, cfg, fused):
    source = _query_source(cfg)
    a_eng, steps = build_jax(JaxAnalytic())
    j_eng, _ = build_jax(InjectedJaxExec(cfg, source))
    t_eng, t_steps = build_torch(_mesh_backend(cfg, fused, source))
    arrays = _chunk_arrays(steps, j_eng.store, cfg)
    for cid, arr in arrays.items():
        j_eng.store.attach_data(cid, jnp.asarray(arr))
    chunks_from_numpy(t_eng.store, arrays, device="cpu")
    for reqs, t_reqs in zip(steps, t_steps):
        a_eng.schedule_step(reqs)
        j_eng.schedule_step(reqs)
        t_eng.schedule_step(t_reqs)
    return j_eng, t_eng, a_eng, steps


@MODES
@pytest.mark.parametrize("name", sorted(jax_scenarios.SCENARIOS))
def test_goldens_match_jax_exec(name, fused):
    j_eng, t_eng, a_eng, steps = _drive(jax_scenarios.SCENARIOS[name],
                                        TORCH_SCENARIOS[name], TINY_MLA,
                                        fused)
    _assert_parity(j_eng, t_eng, a_eng, steps, atol=TOL, rtol=TOL)
    assert all(r is not None and r.mode == ("fused" if fused else "serial")
               for r in t_eng.measured_reports)


@MODES
def test_v2_lite_width_matches_jax_exec(fused):
    j_eng, t_eng, a_eng, steps = _drive(_short_world(JE), _short_world(TE),
                                        V2_LITE_MLA, fused)
    assert {"route", "fetch"} <= {r.primitive for r in a_eng.log}
    _assert_parity(j_eng, t_eng, a_eng, steps, atol=5e-6, rtol=1e-5)


@MODES
def test_selection_scenario_matches_jax_exec(fused):
    cfg = TINY_MLA
    source = _query_source(cfg)
    t_svc = ShardMapIndexerService(SelectionConfig(), cfg, device="cpu",
                                   query_source=source)
    t_eng, steps = torch_selection_scenario(
        _mesh_backend(cfg, fused, source), t_svc)
    j_eng, j_steps = jax_scenarios.selection_scenario(
        InjectedJaxExec(cfg, source), InjectedJaxIndexer(SelectionConfig(),
                                                         cfg, source))
    arrays = _chunk_arrays(j_steps, j_eng.store, cfg)
    for cid, arr in arrays.items():
        j_eng.store.attach_data(cid, jnp.asarray(arr))
    chunks_from_numpy(t_eng.store, arrays, device="cpu")
    for reqs, j_reqs in zip(steps, j_steps):
        t_eng.schedule_step(reqs)
        j_eng.schedule_step(j_reqs)
    a_eng, a_steps = jax_scenarios.selection_scenario(
        JaxAnalytic(), JaxReplay(selection_trace_payload(
            t_svc.log, t_svc.block_tokens, t_svc.d_index)))
    for reqs in a_steps:
        a_eng.schedule_step(reqs)
    assert all(p.selections for p in t_eng.plans)
    _assert_parity(j_eng, t_eng, a_eng, steps, atol=TOL, rtol=TOL)
    for step, reqs in enumerate(steps, start=1):
        assert max_oracle_err(t_eng, reqs, step) <= TOL
    # the indexer's measured walls land in each selected dispatch's
    # "index" stage, and nothing was filled
    assert t_svc.measured_index_s
    assert all(r.stage_fills == 0 for r in t_eng.measured_reports)
    assert all(r.measured.stage_totals().get("index", 0.0) > 0
               for r in t_eng.measured_reports)


# ---------------------------------------------------------------------------
# (b) StepStats at pipeline depths; (d) measured flows
# ---------------------------------------------------------------------------

def _run(build, backend, depth):
    eng, steps = build(backend, TE.EngineConfig(pipeline_depth=depth))
    for i, reqs in enumerate(steps):
        eng.schedule_step(reqs)
        if i + 1 < len(steps):
            eng.speculate_step(steps[i + 1])
    eng.flush()
    return eng, steps


@MODES
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_stepstats_equal_analytic_at_every_depth(depth, fused):
    for name, build in sorted(TORCH_SCENARIOS.items()):
        ana, steps = _run(build, AnalyticBackend(), depth)
        eng, _ = _run(build, _mesh_backend(TINY_MLA, fused), depth)
        assert [s.comparable() for s in eng.stats] \
            == [s.comparable() for s in ana.stats], name
        for step, reqs in enumerate(steps, start=1):
            assert max_oracle_err(eng, reqs, step) <= TOL


def _flow_shape(flows):
    return [(f.key, [(s.name, s.resource) for s in f.stages])
            for f in flows]


@MODES
def test_measured_flows_match_the_analytic_schedule(fused):
    for name, build in sorted(TORCH_SCENARIOS.items()):
        eng, steps = build(_mesh_backend(TINY_MLA, fused))
        for reqs in steps:
            eng.schedule_step(reqs)
        assert len(eng.measured_reports) == len(steps)
        for rep in eng.measured_reports:
            assert rep.stage_fills == 0, name
            assert _flow_shape(rep.measured.flows) \
                == _flow_shape(rep.analytic.flows), name
            assert all(s.duration_s > 0 for f in rep.measured.flows
                       for s in f.stages), name
            assert rep.pool_entries > 0 and rep.pool_bytes > 0
            log = eng.backend.stage_log[rep.step]
            assert [(e["stage"], e["analytic_s"]) for e in log] \
                == [(s.name, s.duration_s) for f in rep.analytic.flows
                    for s in f.stages]
    be = eng.backend
    if fused:
        assert set(be.phase_wall) == {"stack", "dispatch", "barrier",
                                      "merge"}
        assert all(v >= be.phase_wall[k] for k, v in
                   be.phase_wall_total.items())
    else:
        assert be.phase_wall == {}
        # CPU: host walls only, no CUDA-event time
        assert all(e["measured_s"] > 0 and e["device_s"] is None
                   for e in be.stage_log[1])
    assert {e["kind"] for logs in be.stage_log.values() for e in logs} \
        <= {"route pairwise", "route fanout", "fetch", "local"}


# ---------------------------------------------------------------------------
# (c) fused against serial
# ---------------------------------------------------------------------------

def _outputs_agree(a, b, steps, atol=1e-6):
    for step in range(1, len(steps) + 1):
        ao, bo = a.outputs_of(step), b.outputs_of(step)
        assert sorted(ao) == sorted(bo)
        for rid in ao:
            for x, y in zip(ao[rid], bo[rid]):
                torch.testing.assert_close(x, y, atol=atol, rtol=0)


def test_fused_matches_serial_on_the_goldens():
    for name, build in sorted(TORCH_SCENARIOS.items()):
        runs = [_run(build, _mesh_backend(TINY_MLA, fused), depth)
                for fused, depth in ((True, 2), (False, 1))]
        _outputs_agree(runs[0][0], runs[1][0], runs[0][1])


def _agentic(seed, fused, depth=1):
    eng = TE.ServingEngine(6, pool_tokens=4096,
                           cfg=TE.EngineConfig(pipeline_depth=depth),
                           instances_per_pod=3,
                           backend=_mesh_backend(TINY_MLA, fused))
    wl = WorkloadConfig(n_steps=4, agents=8, n_corpus_chunks=8,
                        chunk_tokens=128, seed=seed, selection_frac=0.0)
    steps = materialize_trace(agentic_trace(wl, eng,
                                            register_corpus(eng, wl)))
    for reqs in steps:
        eng.schedule_step(reqs)
    eng.flush()
    return eng, steps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_matches_serial_on_agentic_workloads(seed):
    fused, steps = _agentic(seed, True, depth=2)
    serial, _ = _agentic(seed, False)
    assert [s.comparable() for s in fused.stats] \
        == [s.comparable() for s in serial.stats]
    _outputs_agree(fused, serial, steps)
    for step, reqs in enumerate(steps, start=1):
        assert max_oracle_err(fused, reqs, step) <= TOL
    assert all(r.stage_fills == 0 for r in fused.measured_reports)


# ---------------------------------------------------------------------------
# (e) a dead holder; the committed-copy pool
# ---------------------------------------------------------------------------

def _live_copies(store):
    return {(c.chunk_id, i) for c in store._chunks.values()
            for i in [c.holder] + list(c.replicas)}


@MODES
def test_dead_holder_serves_through_the_promoted_replica(fused):
    eng, steps = TORCH_SCENARIOS["fetch_heavy"](_mesh_backend(TINY_MLA,
                                                              fused))
    eng.schedule_step(steps[0])               # FETCHes persist on 0
    pool = eng.backend._pool
    assert {("doc0", 0), ("doc0", 1)} <= set(pool)
    assert eng.fail_instance(1) == []         # doc0 promoted, not orphaned
    assert ("doc0", 1) not in pool            # retired with its holder
    assert eng.store.lookup("doc0").holder == 0
    reqs = [TE.Request(7, home=3, chunk_ids=["doc0", "doc1"], m_q=4),
            TE.Request(8, home=0, chunk_ids=["doc0"], m_q=2)]
    eng.schedule_step(reqs)
    assert max_oracle_err(eng, reqs, eng.step_idx) <= TOL
    assert set(pool) <= _live_copies(eng.store)


@MODES
def test_pool_retires_entries_with_their_replicas(fused):
    eng, steps = _agentic(3, fused)
    pool = eng.backend._pool
    assert pool and set(pool) <= _live_copies(eng.store)
    replica = next((cid, i) for cid, i in pool
                   if i in eng.store.lookup(cid).replicas)
    eng.store.evict_replica(*replica)
    assert replica not in pool
    assert eng.measured_reports[-1].pool_entries >= len(pool)


def test_mesh_backend_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs its absence")
    for fused in (True, False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardMapExecBackend(fused=fused)
    assert ShardMapExecBackend(device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# (i) the serve CLI
# ---------------------------------------------------------------------------

SMALL = ["--instances", "4", "--pods", "2", "--chunks", "6",
         "--chunk-tokens", "64", "--agents", "6", "--steps", "3",
         "--selection-frac", "0", "--backend", "shard_map", "--device",
         "cpu", "--verify"]


@pytest.mark.parametrize("extra", [[], ["--serial-exec"],
                                   ["--pipeline-depth", "2"]],
                         ids=["fused", "serial", "depth2"])
def test_serve_cli_runs_the_mesh_backend(capsys, extra):
    eng = serve.main(SMALL + extra)
    out = capsys.readouterr().out
    errs = [float(x) for x in re.findall(r"max\|err\| (\S+)", out)]
    assert len(errs) == 3 and max(errs) <= 1e-6
    mode = "serial" if extra == ["--serial-exec"] else "fused"
    assert len(re.findall(rf"makespan analytic .*, {mode}, pool", out)) == 3
    assert "[serve] exec: measured/analytic ratio" in out
    assert "backend=shard_map" in out
    assert eng.backend.fused == (mode == "fused")


def test_serve_cli_selection_and_drift_through_the_mesh(capsys):
    serve.main(["--instances", "4", "--pods", "2", "--chunks", "6",
                "--chunk-tokens", "256", "--agents", "6", "--steps", "3",
                "--selection", "--selection-frac", "0.5", "--selection-k",
                "128", "--backend", "shard_map", "--device", "cpu",
                "--verify", "--drift-threshold", "1e9"])
    out = capsys.readouterr().out
    errs = [float(x) for x in re.findall(r"max\|err\| (\S+)", out)]
    assert len(errs) == 3 and max(errs) <= 1e-6
    assert "selector=indexer-shard_map" in out
    assert "no measured reports" not in out and "drift: OK" in out


def test_serve_cli_verify_needs_an_exec_backend():
    with pytest.raises(SystemExit, match="--backend exec or shard_map"):
        serve.main(["--verify"])
