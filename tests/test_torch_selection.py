"""Port parity of the selection regime (§5.4): core.selection, the live
IndexerService, the selection half of TorchExecBackend (on the CPU, where
sparse_select and mla_decode take their plain versions) and the serve CLI's
selection flags, against the JAX package.

Both sides get the same state: the same numpy chunk arrays attached to both
stores and the same numpy queries, given to the port's backend and indexer
as their query source and to test-local reference subclasses. Then:

* the port's indexer picks exactly the reference's blocks and masks;
* through the scheduler on tests/engine_scenarios.py:selection_scenario,
  rebuilt with the port's engine, per-request o and m agree with
  JaxExecBackend within 1e-6 absolute and l within 1e-6 relative at
  TINY_MLA; at V2-Lite width (d_qk = 576) within 5e-6 absolute / 1e-5
  relative, the reference kernels' own tolerance at that width
  (tests/test_kernels.py:68); every output is within 1e-6 of the
  selection oracle; StepStats.comparable() equal the JAX AnalyticBackend's
  driven by a ReplaySelector of the same selections, bit for bit.
"""

import dataclasses
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import engine_scenarios as jax_scenarios
from repro.core import selection as JSEL
from repro.launch import serve as jax_serve
from repro.serving.backends import AnalyticBackend as JaxAnalytic
from repro.serving.selection import IndexerService as JaxIndexer
from repro.serving.selection import ReplaySelector as JaxReplay
from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA
from repro_torch.convert import chunks_from_numpy
from repro_torch.core import selection as TSEL
from repro_torch.launch import serve
from repro_torch.serving import engine as TE
from repro_torch.serving.backends.torch_exec import (
    TINY_MLA, TorchExecBackend, chunk_array, max_oracle_err,
    selection_oracle_partial)
from repro_torch.serving.selection import (IndexerService, ReplaySelector,
                                           SelectionConfig,
                                           save_selection_trace,
                                           selection_trace_payload,
                                           token_mask)
from test_torch_backend import (InjectedJaxExec, _assert_parity,
                                _chunk_arrays, _query_source)

TOL = 1e-6


def _port_selection_scenario():
    """tests/engine_scenarios.py:selection_scenario with the port's engine
    in place of the reference's."""
    src = pathlib.Path(jax_scenarios.__file__).read_text().replace(
        "from repro.serving.engine", "from repro_torch.serving.engine")
    mod = types.ModuleType("torch_engine_scenarios")
    exec(compile(src, "torch_engine_scenarios", "exec"), mod.__dict__)
    return mod.selection_scenario


torch_selection_scenario = _port_selection_scenario()


class InjectedJaxIndexer(JaxIndexer):
    """The reference indexer fed the test's numpy queries."""

    def __init__(self, cfg, mla, source):
        super().__init__(cfg, mla)
        self.source = source

    def index_query(self, rq, step):
        q = np.asarray(self.source(rq, step), np.float32)
        return q[..., :self.d_index].mean(axis=1)


# ---------------------------------------------------------------------------
# core.selection
# ---------------------------------------------------------------------------

def test_topk_blocks_pads_the_tail():
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((3, 200)).astype(np.float32)
    scores[1, 195] = 50.0                       # the tail block must win
    got = TSEL.topk_blocks(torch.tensor(scores), 64, 2)
    want = JSEL.topk_blocks(jnp.asarray(scores), 64, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[1, 0]) == 3
    assert TSEL.topk_blocks(torch.tensor(scores), 64, 99).shape == (3, 4)


def test_block_and_token_masks():
    idx = np.array([[0, 3], [2, 2]])
    np.testing.assert_array_equal(
        TSEL.block_mask_to_tokens(torch.tensor(idx), 64, 200).numpy(),
        np.asarray(JSEL.block_mask_to_tokens(jnp.asarray(idx), 64, 200)))
    tok = np.array([[5, 9, 1], [0, 0, 7]])
    np.testing.assert_array_equal(
        TSEL.selection_mask(torch.tensor(tok), 12).numpy(),
        np.asarray(JSEL.selection_mask(jnp.asarray(tok), 12)))
    rng = np.random.default_rng(1)
    s = rng.standard_normal((2, 150)).astype(np.float32)
    np.testing.assert_array_equal(TSEL.block_scores(s, 64),
                                  JSEL.block_scores(s, 64))
    for a, b in zip(TSEL.residency_split([3, 70, 71, 199], [0, 64, 128, 200]),
                    JSEL.residency_split(jnp.asarray([3, 70, 71, 199]),
                                         [0, 64, 128, 200])):
        np.testing.assert_array_equal(a, b)


def test_index_scores_keys_and_topk_tokens():
    rng = np.random.default_rng(2)
    p = {"q_proj": rng.standard_normal((32, 8)).astype(np.float32),
         "k_proj": rng.standard_normal((32, 8)).astype(np.float32)}
    x_q = rng.standard_normal((2, 3, 32)).astype(np.float32)
    x_ctx = rng.standard_normal((40, 32)).astype(np.float32)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    t_keys = TSEL.index_keys(tp, torch.tensor(x_ctx))
    j_keys = JSEL.index_keys(jp, jnp.asarray(x_ctx))
    np.testing.assert_allclose(t_keys.numpy(), np.asarray(j_keys),
                               atol=1e-5, rtol=1e-5)
    t_s = TSEL.index_scores(tp, torch.tensor(x_q), t_keys)
    j_s = JSEL.index_scores(jp, jnp.asarray(x_q), j_keys)
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_array_equal(
        TSEL.topk_tokens(torch.tensor(np.asarray(j_s)), 5).numpy(),
        np.asarray(JSEL.topk_tokens(j_s, 5)))
    assert TSEL.latent_index_keys(t_keys, 3).shape == (40, 3)


# ---------------------------------------------------------------------------
# IndexerService
# ---------------------------------------------------------------------------

def _indexer_pair(cfg=TINY_MLA, sel_cfg=SelectionConfig()):
    """(port engine + indexer, reference engine + indexer, steps) on the
    selection scenario with the same attached arrays and queries."""
    source = _query_source(cfg)
    t_svc = IndexerService(sel_cfg, cfg, device="cpu", query_source=source)
    j_svc = InjectedJaxIndexer(sel_cfg, cfg, source)
    t_eng, steps = torch_selection_scenario(selector=t_svc)
    j_eng, j_steps = jax_scenarios.selection_scenario(selector=j_svc)
    arrays = _chunk_arrays(j_steps, j_eng.store, cfg)
    for cid, arr in arrays.items():
        j_eng.store.attach_data(cid, jnp.asarray(arr))
    chunks_from_numpy(t_eng.store, arrays, device="cpu")
    return t_eng, t_svc, j_eng, j_svc, steps, j_steps


@pytest.mark.parametrize("block_tokens", [64, 32])
def test_indexer_picks_the_reference_blocks(block_tokens):
    t_eng, t_svc, j_eng, j_svc, steps, j_steps = _indexer_pair(
        sel_cfg=SelectionConfig(block_tokens=block_tokens))
    n = 0
    for step, (reqs, j_reqs) in enumerate(zip(steps, j_steps), start=1):
        for rq, j_rq in zip(reqs, j_reqs):
            if rq.k_selected is None:
                continue
            got = t_svc.select_request(t_eng.store, rq, step)
            want = j_svc.select_request(j_eng.store, j_rq, step)
            assert got.blocks == want.blocks
            for cid in rq.chunk_ids:
                np.testing.assert_array_equal(got.masks[cid],
                                              want.masks[cid])
            glob = t_svc.global_select(t_eng.store, rq, step)
            assert glob.blocks == got.blocks \
                == j_svc.global_select(j_eng.store, j_rq, step).blocks
            n += 1
    assert n == 4
    assert t_svc.obs_counts == j_svc.obs_counts


def test_index_keys_ride_host_side_once():
    t_eng, t_svc, *_ = _indexer_pair()
    keys = t_svc.ensure_index_keys(t_eng.store, "sel0")
    assert isinstance(keys, np.ndarray) and keys.flags.c_contiguous
    assert keys.shape == (192, TINY_MLA.kv_lora_rank)
    np.testing.assert_array_equal(
        keys, t_eng.store.lookup("sel0").data[:, :16].numpy())
    assert t_svc.ensure_index_keys(t_eng.store, "sel0") is \
        t_eng.store.lookup("sel0").index_keys


def test_generated_keys_match_the_backend_arrays():
    """On an analytic engine (no arrays attached) the indexer materializes
    the chunk exactly as the exec backend would (same generator, same
    device)."""
    svc = IndexerService(device="cpu")
    eng, _ = torch_selection_scenario(selector=svc)
    keys = svc.ensure_index_keys(eng.store, "sel2")
    arr = chunk_array(TINY_MLA, "sel2", 160, device="cpu")
    np.testing.assert_array_equal(keys,
                                  arr[:, :TINY_MLA.kv_lora_rank].numpy())


def test_selection_trace_round_trip_replays_identical_plans(tmp_path):
    svc = IndexerService(device="cpu")
    live, steps = torch_selection_scenario(selector=svc)
    for reqs in steps:
        live.schedule_step(reqs)
    path = tmp_path / "sel.json"
    save_selection_trace(path, svc.log, svc.block_tokens, svc.d_index)
    rep, steps = torch_selection_scenario(selector=ReplaySelector(str(path)))
    for reqs in steps:
        rep.schedule_step(reqs)
    assert [s.comparable() for s in live.stats] \
        == [s.comparable() for s in rep.stats]
    for a, b in zip(live.plans, rep.plans):
        assert [(r.primitive, r.chunk_id, r.holder, r.req_ids, r.stages)
                for r in a.records] \
            == [(r.primitive, r.chunk_id, r.holder, r.req_ids, r.stages)
                for r in b.records]
        assert {k: v.blocks for k, v in a.selections.items()} \
            == {k: v.blocks for k, v in b.selections.items()}


# ---------------------------------------------------------------------------
# Through the scheduler
# ---------------------------------------------------------------------------

def _drive_selection(cfg):
    """Port exec + indexer, reference exec + indexer (injected), and the
    JAX analytic engine replaying the port's selections."""
    source = _query_source(cfg)
    t_svc = IndexerService(SelectionConfig(), cfg, device="cpu",
                           query_source=source)
    t_eng, steps = torch_selection_scenario(
        TorchExecBackend(cfg, device="cpu", query_source=source), t_svc)
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
    return j_eng, t_eng, a_eng, steps


@pytest.mark.parametrize("cfg,atol,rtol", [(TINY_MLA, TOL, TOL),
                                           (V2_LITE_MLA, 5e-6, 1e-5)],
                         ids=["tiny", "v2_lite"])
def test_selection_scenario_parity(cfg, atol, rtol):
    j_eng, t_eng, a_eng, steps = _drive_selection(cfg)
    assert all(p.selections for p in t_eng.plans)
    for p, jp in zip(t_eng.plans, j_eng.plans):
        assert {k: v.blocks for k, v in p.selections.items()} \
            == {k: v.blocks for k, v in jp.selections.items()}
    _assert_parity(j_eng, t_eng, a_eng, steps, atol=atol, rtol=rtol)
    for step, reqs in enumerate(steps, start=1):
        assert max_oracle_err(t_eng, reqs, step) <= (TOL if cfg is TINY_MLA
                                                     else 5e-6)


def test_plan_block_ids_agree_with_plan_masks():
    """The backend attends sel.blocks and never reads sel.masks on the
    card: on every access of the scenario the two agree."""
    _, t_eng, _, _ = _drive_selection(TINY_MLA)
    n = 0
    for plan in t_eng.plans:
        for sel in plan.selections.values():
            for cid, blocks in sel.blocks.items():
                assert list(blocks) == sorted(blocks)
                np.testing.assert_array_equal(
                    token_mask(blocks, sel.block_tokens,
                               t_eng.store.lookup(cid).length),
                    sel.masks[cid])
                n += 1
    assert n >= 6


def test_generated_state_matches_selection_oracle():
    eng, steps = torch_selection_scenario(TorchExecBackend(device="cpu"),
                                          IndexerService(device="cpu"))
    for reqs in steps:
        eng.schedule_step(reqs)
        assert eng.plans[-1].selections
        assert max_oracle_err(eng, reqs, eng.step_idx) <= TOL


def test_fetch_selected_gathers_and_never_persists():
    eng = TE.ServingEngine(2, pool_tokens=10**5,
                           backend=TorchExecBackend(device="cpu"),
                           selector=IndexerService(device="cpu"))
    eng.register_chunk("doc", holder=1, length=160)
    rq = TE.Request(0, home=0, chunk_ids=["doc"], m_q=2, k_selected=96)
    plan = eng.plan_step([rq])
    assert len(plan.records) == 1 and plan.selections
    fetch_plan = dataclasses.replace(
        plan, records=[dataclasses.replace(plan.records[0],
                                           primitive="fetch")])
    ex = eng.backend.execute(eng, fetch_plan)
    want = selection_oracle_partial(TINY_MLA, eng.store, rq,
                                    plan.selections[0], plan.step,
                                    device="cpu")
    np.testing.assert_allclose(ex.outputs[0].o.numpy(), want.o.numpy(),
                               atol=TOL)
    assert not eng.store.lookup("doc").replica_data
    assert eng.store.lookup("doc").replicas == []
    replica = dataclasses.replace(
        plan, records=[dataclasses.replace(plan.records[0],
                                           primitive="fetch_replica")])
    with pytest.raises(RuntimeError, match="fetch_replica"):
        eng.backend.execute(eng, replica)


def test_fetch_selected_empty_gather_is_identity():
    eng = TE.ServingEngine(4, pool_tokens=10**5,
                           backend=TorchExecBackend(device="cpu"),
                           selector=IndexerService(device="cpu"))
    eng.register_chunk("a", holder=1, length=64)
    eng.register_chunk("b", holder=2, length=64)
    rq = TE.Request(0, home=0, chunk_ids=["a", "b"], m_q=2, k_selected=64)
    plan = eng.plan_step([rq])
    for cid in rq.chunk_ids:                 # the oracle reads both chunks
        eng.backend.ensure_chunk_data(eng.store, cid)
    forced = dataclasses.replace(plan, records=[
        dataclasses.replace(r, primitive="fetch") for r in plan.records])
    ex = eng.backend.execute(eng, forced)
    want = selection_oracle_partial(TINY_MLA, eng.store, rq,
                                    plan.selections[0], plan.step,
                                    device="cpu")
    np.testing.assert_allclose(ex.outputs[0].o.numpy(), want.o.numpy(),
                               atol=TOL)


def test_empty_holder_selection_is_identity():
    eng = TE.ServingEngine(4, pool_tokens=10**5,
                           backend=TorchExecBackend(device="cpu"),
                           selector=IndexerService(device="cpu"))
    eng.register_chunk("a", holder=1, length=64)
    eng.register_chunk("b", holder=2, length=64)
    rq = TE.Request(0, home=0, chunk_ids=["a", "b"], m_q=2, k_selected=64)
    eng.schedule_step([rq])
    sel = eng.plans[-1].selections[0]
    assert sorted(sel.kb_on(c) for c in ("a", "b")) == [0, 1]
    assert max_oracle_err(eng, [rq], 1) <= TOL


def test_matches_model_dsa_path():
    """block_tokens = 1, m_q = 1: token-level top-k with the DSA scoring
    rule (mean-head latent query . latent c^KV band, top-k, attend the
    gathered entries) — the scheduler output equals it, on the port."""
    k = 5
    svc = IndexerService(SelectionConfig(block_tokens=1), device="cpu")
    eng = TE.ServingEngine(2, pool_tokens=10**5,
                           backend=TorchExecBackend(device="cpu"),
                           selector=svc)
    eng.register_chunk("doc", holder=1, length=48)
    rq = TE.Request(0, home=0, chunk_ids=["doc"], m_q=1, k_selected=k)
    eng.schedule_step([rq])
    got = eng.outputs_of(1)[0]
    q = eng.backend.fresh_query(rq, 1).numpy()
    ckv = eng.store.lookup("doc").data.numpy()
    d_c = TINY_MLA.kv_lora_rank
    qi = q[..., :d_c].mean(axis=1)
    _, sel_idx = jax.lax.top_k(jnp.asarray(qi @ ckv[:, :d_c].T)[0], k)
    from repro.models.mla import MLAConfig, absorbed_partial
    want = absorbed_partial(MLAConfig(**dataclasses.asdict(TINY_MLA)),
                            jnp.asarray(q),
                            jnp.take(jnp.asarray(ckv), sel_idx, axis=0))
    np.testing.assert_allclose(got.o.numpy(), np.asarray(want.o), atol=TOL,
                               rtol=1e-5)
    np.testing.assert_allclose(got.l.numpy(), np.asarray(want.l), rtol=1e-5)


# ---------------------------------------------------------------------------
# The serve CLI
# ---------------------------------------------------------------------------

WORLD = ["--instances", "4", "--pods", "2", "--chunks", "6",
         "--chunk-tokens", "128", "--agents", "6", "--steps", "3"]
ARGS = WORLD + ["--selection-frac", "0.5", "--selection-k", "128"]


def _makespans(text):
    return [ln.split("makespan ")[1].split(",")[0]
            for ln in text.splitlines() if "makespan" in ln]


def test_serve_selection_verify_and_replay(tmp_path, capsys):
    trace = tmp_path / "sel.json"
    serve.main(ARGS + ["--backend", "exec", "--device", "cpu", "--selection",
                       "--verify", "--save-selection-trace", str(trace)])
    out = capsys.readouterr().out
    assert "selector=indexer" in out
    errs = [float(x) for x in re.findall(r"max\|err\| (\S+)", out)]
    assert len(errs) == 3 and max(errs) <= 1e-5
    n_sel = int(re.search(r"selector=indexer, (\d+) selected pairs",
                          out).group(1))
    assert n_sel > 0
    serve.main(WORLD + ["--selection-trace", str(trace)])
    out2 = capsys.readouterr().out
    assert "selector=replay" in out2
    assert "--selection-trace meta overrides --selection-frac" in out2
    assert _makespans(out) == _makespans(out2)
    # the reference replays the port's trace to the same plans
    jax_serve.main(WORLD + ["--selection-trace", str(trace)])
    assert _makespans(capsys.readouterr().out) == _makespans(out)


def test_serve_selection_flag_conflicts(tmp_path):
    with pytest.raises(SystemExit, match="cannot be combined"):
        serve.main(ARGS + ["--selection", "--selection-trace",
                           str(tmp_path / "x.json")])
    with pytest.raises(SystemExit, match="requires --selection"):
        serve.main(ARGS + ["--save-selection-trace",
                           str(tmp_path / "y.json")])


def test_serve_selection_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(ARGS + ["--backend", "exec", "--selection"])
