"""The port's example drivers (repro_torch.examples) against the JAX
package's (examples/*.py), on the CPU.

* quickstart: the reference's MLA parameters and chunk (numpy, carried
  across by convert.mla_params_from_numpy) give the same canonical c^KV,
  absorbed query row, 4-shard routed merge and mla_decode partial (the
  Pallas kernel in interpret mode, as tests/test_kernels.py runs it) within
  1e-5; the three predicate rows are equal.
* serve_routed: control plane only; it prints what the reference prints,
  line for line.
* agentic_fanout: the reference's main() at reduced sizes (set on its
  module object) and the port's run() at the same sizes print the same
  fan-in, replication verdict, engine steps and holders; the routed fork
  decode is within 1e-5 of the monolithic cache.
* plan_execute: each step's StepStats (comparable()) of the port's exec
  backend equal its analytic backend's and the reference's AnalyticBackend
  on the same EngineConfig, bit for bit; exec max|err| <= 1e-5.
* train_mla_100m: both configs equal the reference's field for field and
  have its parameter count (the port on the meta device, the reference
  through jax.eval_shape); a short CPU run restores once and replays the
  restored step's loss bit for bit.
* every example refuses --device cuda without a card, naming --device cpu.
"""

import contextlib
import dataclasses
import importlib
import importlib.util
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constants as JC
from repro.core import predicate as JP
from repro.core.routing import route_simulated as jax_route_simulated
from repro.kernels.mla_decode import mla_decode as jax_mla_decode
from repro.models import mla as JM
from repro.models import model as JMD
from repro.models.module import KeyGen, count_params as jax_count_params
from repro.models.module import split
from repro.serving import AnalyticBackend as JAnalytic
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JEngine
from repro.serving import WorkloadConfig as JWorkload
from repro.serving import (agentic_trace as jax_agentic_trace,
                           materialize_trace as jax_materialize,
                           register_corpus as jax_register_corpus)
from repro_torch.convert import mla_params_from_numpy
from repro_torch.examples import (agentic_fanout, plan_execute, quickstart,
                                  serve_routed, train_mla_100m)
from repro_torch.models import model as TMD
from repro_torch.models.module import count_params
from torch_parity import ROOT

ATOL = 1e-5
EXAMPLES = ("quickstart", "serve_routed", "agentic_fanout", "plan_execute",
            "train_mla_100m")


def reference_example(name: str):
    """examples/<name>.py of the JAX package, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_matches_the_reference():
    cfg = quickstart.CFG
    jcfg = JM.MLAConfig(**dataclasses.asdict(cfg))
    params = split(JM.init_mla(KeyGen(jax.random.PRNGKey(0)), jcfg,
                               dtype=jnp.float32))[0]
    x = 0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                (1, quickstart.S, cfg.d_model))
    pos = jnp.arange(quickstart.S)[None]
    ckv = JM.latent_cache_entries(params, jcfg, x, pos)[0]
    qn, qr = JM.project_q(params, jcfg, x[:, -1:], pos[:, -1:] + 1)
    q_abs = JM.absorb_query(params, jcfg, qn, qr)[:, 0]
    rows = quickstart.S // quickstart.SHARDS
    merged = jax_route_simulated(jcfg, q_abs, [
        ckv[i * rows:(i + 1) * rows] for i in range(quickstart.SHARDS)])
    kernel = jax_mla_decode(q_abs, ckv[None], d_v=jcfg.kv_lora_rank,
                            scale=jcfg.scale, block_s=64)

    got = quickstart.attend(
        mla_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu"),
        torch.tensor(np.asarray(x)))
    close = lambda a, b, **kw: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), **kw)
    close(got["ckv"], ckv, atol=ATOL, rtol=0)
    close(got["q_abs"], q_abs, atol=ATOL, rtol=0)
    for mine, ref in ((got["merged"], merged), (got["kernel"], kernel)):
        close(mine.o, ref.o, atol=ATOL, rtol=0)
        close(mine.m, ref.m, atol=ATOL, rtol=0)
        close(mine.l, ref.l, atol=0, rtol=ATOL)

    rows = [JP.decide(JP.Request(m_q=m_q, c_t=2048,
                                 fabric=JC.fabric("h100_ibgda"),
                                 expected_reuse_steps=reuse))
            for m_q, reuse in quickstart.DECISIONS]
    assert [(d.primitive.value, d.t_route, d.t_fetch, d.t_local, d.reason)
            for d in quickstart.decisions()] \
        == [(d.primitive.value, d.t_route, d.t_fetch, d.t_local, d.reason)
            for d in rows]


def test_quickstart_runs_on_the_cpu():
    out, lines = printed(quickstart.main, ["--device", "cpu"])
    assert out["ckv_shape"] == (quickstart.S, quickstart.CFG.d_qk)
    assert out["route_err"] <= ATOL and out["kernel_err"] <= ATOL
    assert [r["primitive"] for r in out["decisions"]] \
        == ["route", "fetch", "route"]
    assert len(lines) == 7 and "plain version" in lines[3]


# ---------------------------------------------------------------------------
# serve_routed
# ---------------------------------------------------------------------------

def test_serve_routed_prints_what_the_reference_prints():
    # the workload puts some sessions in the selection regime with no
    # selector: both engines warn once (tier-1 runs warnings as errors)
    with pytest.warns(RuntimeWarning, match="k_selected"):
        _, want = printed(reference_example("serve_routed").main)
        out, got = printed(serve_routed.main, ["--device", "cpu"])
    assert got == want
    assert out["steps"] == 24 and len(out["hot_holders"]) == 3
    assert out["after_failure_dispatches"] > 0


# ---------------------------------------------------------------------------
# agentic_fanout
# ---------------------------------------------------------------------------

# reduced sizes: still past the N~8 fan-in elbow, so the replica spawns
N_AGENTS, DOC_TOKENS = 9, 64


def test_agentic_fanout_matches_the_reference_at_reduced_sizes():
    ref = reference_example("agentic_fanout")
    ref.N_AGENTS, ref.DOC_TOKENS = N_AGENTS, DOC_TOKENS
    _, want = printed(ref.main)
    out, got = printed(agentic_fanout.run, "cpu", N_AGENTS, DOC_TOKENS)
    # every line but the max|err| of the drawn arrays
    keep = lambda lines: [ln for ln in lines if "max|err|" not in ln]
    assert keep(got) == keep(want)
    assert len(keep(got)) == 7
    assert out["max_err"] < agentic_fanout.TOL
    assert out["fan_in"] == N_AGENTS and out["replicate"] is True
    assert len(out["holders"]) == 2


# ---------------------------------------------------------------------------
# plan_execute
# ---------------------------------------------------------------------------

STEPS, AGENTS = 6, 8


def test_plan_execute_stepstats_equal_the_references():
    with pytest.warns(RuntimeWarning, match="k_selected"):
        out, lines = printed(plan_execute.run, "cpu", STEPS, AGENTS)
        wl = JWorkload(**dataclasses.asdict(plan_execute.workload(STEPS,
                                                                  AGENTS)))
        eng = JEngine(n_instances=8, pool_tokens=48 * 256,
                      cfg=JEngineConfig(), instances_per_pod=4,
                      backend=JAnalytic())
        for reqs in jax_materialize(jax_agentic_trace(
                wl, eng, jax_register_corpus(eng, wl))):
            eng.schedule_step(reqs)
    want = [s.comparable() for s in eng.stats]
    assert len(want) == STEPS
    assert out["exec_stats"] == out["analytic_stats"] == want
    assert out["max_err"] <= plan_execute.ATOL == ATOL
    assert out["routed"] > 0
    assert out["dispatches"] == sum(s["n_dispatches"] for s in want)
    assert sum(ln.startswith("step ") for ln in lines) == STEPS


# ---------------------------------------------------------------------------
# train_mla_100m
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [True, False], ids=["mla-100m", "mla-20m"])
def test_train_configs_and_parameter_counts_equal_the_references(full):
    ref = reference_example("train_mla_100m")
    want, got = ref.build_config(full), train_mla_100m.build_config(full)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    abstract = jax.eval_shape(lambda k: split(JMD.init_model(want, k))[0],
                              jax.random.PRNGKey(0))
    n = count_params(TMD.init_model(got, device="meta"))
    assert n == jax_count_params(abstract)
    # the "~100M" configuration holds 76 453 376 parameters in both
    assert n == (76_453_376 if full else 8_675_840)


def test_train_restores_once_and_replays_bit_for_bit(tmp_path):
    out, lines = printed(train_mla_100m.main, [
        "--device", "cpu", "--steps", "52", "--seq", "16", "--batch", "2",
        "--ckpt-dir", str(tmp_path)])
    assert [e["step"] for e in out["events"]] == [25]
    assert out["events"][0]["event"] == "restored"
    assert all(math.isfinite(x) for _, x in out["losses"])
    assert out["losses"][-1][1] < out["losses"][0][1]
    steps = [s for s, _, _ in out["ran"]]
    assert steps == list(range(26)) + list(range(25, 52))
    first, again = out["ran"][25], out["ran"][26]
    assert first[0] == again[0] == 25 and first[1] == again[1]
    assert out["checkpoints"] == [25, 50]
    assert lines[0] == "model: mla-20m, 8.7M params"


# ---------------------------------------------------------------------------
# --device cuda without a card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", EXAMPLES)
@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]],
                         ids=["default", "cuda"])
def test_cuda_without_a_card_exits_naming_the_cpu_flag(name, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs its absence")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(SystemExit, match="--device cpu"):
        mod.main(argv)
