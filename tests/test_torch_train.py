"""Port parity of the training path (repro_torch.models.model.loss_fn, the
train forms of MLA and SSD under autograd, repro_torch.train, the launcher)
against the JAX package, on the CPU, at smoke widths in f32. Weights are
numpy_weights in the reference's layout carried across with
convert.model_params_from_numpy; the batch is drawn once (the reference's
pipeline, as numpy) and handed to both packages.

Configs: the DeepSeek smoke config (q_lora_rank 48, a dense first layer),
the V2-Lite-shaped tiny config, the Mamba2 smoke config, and the DeepSeek
smoke config with loss_chunk 6 (the cross-entropy in two chunks of 8).

Tolerances:
* the loss: rtol 1e-5 (one f32 forward, sums in another order);
* every gradient leaf: atol 1e-4 x the leaf's max |grad| and rtol 1e-4,
  the forward's own 1e-4 (tests/test_torch_model.py), on equal MoE routes;
* three train steps at n_micro 1 and 2: the losses within rtol 1e-4 and
  the first step's gradients as above. The parameters after AdamW are not
  compared: the first step moves each parameter by lr * g / (|g| + eps),
  which is +-lr for any |g| >> 1e-8, so a gradient of ~1e-7 whose sign
  the two packages round apart moves that parameter by 2 lr.
"""

import dataclasses
import functools
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data.pipeline import DataConfig, SyntheticPipeline as JPipe
from repro.models import mla as JMLA
from repro.models import model as JMm
from repro.models import moe as JMOE
from repro.optim import adamw as JA
from repro.train import step as JS
from repro_torch import configs as TC
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import model_params_from_numpy
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import mla as TMLA
from repro_torch.models import model as TMm
from repro_torch.models import moe as TMOE
from repro_torch.models.module import trainable
from repro_torch.optim import adamw as TA
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import (TrainConfig, loss_and_grads,
                                    make_train_step)
from torch_parity import ROOT, numpy_weights, tiny_v2_lite

B, S = 2, 16


class _Ref:
    model, mla, moe = JMm, JMLA, JMOE


class _Port:
    model, mla, moe = TMm, TMLA, TMOE


def _smoke(arch):
    return lambda m: (JC if m is _Ref else TC).get_smoke_config(arch)


CASES = {
    "deepseek_smoke": _smoke("deepseek-v2-lite"),
    "v2_lite_tiny": tiny_v2_lite,
    "mamba2_smoke": _smoke("mamba2-370m"),
    "deepseek_chunked_ce": lambda m: dataclasses.replace(
        _smoke("deepseek-v2-lite")(m), loss_chunk=6),
}


def _batch(vocab, batch, step=0):
    """The reference pipeline's batch as numpy (int32)."""
    b = JPipe(DataConfig(vocab=vocab, seq_len=S, global_batch=batch)
              ).batch_at(step)
    return {k: np.asarray(v) for k, v in b.items()}


def _t(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _grad_close(got, want, name):
    tol = 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=1e-4, err_msg=name)


@functools.partial(jax.jit, static_argnums=0)
def _ref_routes(jcfg, jparams, tokens):
    """The reference's top-k route at every MoE layer of its forward,
    from its own blocks and router."""
    x, pos = JMm._embed_inputs(jparams, jcfg, {"tokens": tokens})
    na = jcfg.norm_apply()
    routes = []
    for key, moe_block in (("dense_blocks", False), ("blocks", True)):
        stack = jparams[key]
        for i in range(jax.tree.leaves(stack)[0].shape[0]):
            lp = jax.tree.map(lambda a: a[i], stack)
            if moe_block:
                attn, _ = JMLA.mla_attention(lp["attn"], jcfg.mla,
                                             na(lp["ln1"], x), pos)
                h = na(lp["ln2"], x + attn)
                idx, _, _ = JMOE._router(lp["moe"], jcfg.moe,
                                         h.reshape(-1, h.shape[-1]))
                routes.append(idx)
            x, _, _ = JMm._dense_block_fwd(lp, jcfg, x, pos, moe_block)
    return routes


@pytest.fixture(scope="module", params=sorted(CASES))
def grads(request):
    """The case's loss and gradients, reference (jax.value_and_grad of
    repro.models.model.loss_fn) and port (loss_fn, backward), on one weight
    tree and one batch."""
    jcfg, tcfg = CASES[request.param](_Ref), CASES[request.param](_Port)
    tree = numpy_weights(jcfg, seed=len(request.param))
    batch = _batch(jcfg.vocab, B)
    jparams = jax.tree.map(jnp.asarray, tree)
    loss, g = jax.jit(jax.value_and_grad(JMm.loss_fn), static_argnums=1)(
        jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    ref = {"loss": float(loss),
           "grads": model_params_from_numpy(jax.tree.map(np.asarray, g),
                                            tcfg, device="cpu"),
           "routes": ([np.asarray(r) for r in _ref_routes(
               jcfg, jparams, jnp.asarray(batch["tokens"]))]
               if jcfg.family == "moe" else [])}
    params = trainable(model_params_from_numpy(tree, tcfg, device="cpu"))
    routes = []
    lt = TMm.loss_fn(params, tcfg, _t(batch), routes=routes)
    lt.backward()
    port = {"loss": float(lt.detach()), "params": params, "routes": routes}
    return request.param, tcfg, ref, port


def test_loss_matches_reference(grads):
    _, _, ref, port = grads
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)


def test_grads_match_reference_leaf_by_leaf(grads):
    name, tcfg, ref, port = grads
    want = dict(ref["grads"].named_parameters())
    got = dict(port["params"].named_parameters())
    assert sorted(got) == sorted(want)
    for k, p in got.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        _grad_close(p.grad.numpy(), want[k].detach().numpy(), f"{name} {k}")


def test_routes_match_reference_and_are_recorded_once(grads):
    """One (T, k) route per MoE layer, once, although remat recomputes each
    block in backward; equal to the reference's."""
    _, tcfg, ref, port = grads
    n_moe = (tcfg.n_layers - tcfg.first_k_dense
             if tcfg.family == "moe" else 0)
    assert tcfg.remat and len(port["routes"]) == n_moe
    for got, want in zip(port["routes"], ref["routes"]):
        np.testing.assert_array_equal(got.numpy(), want)


def test_remat_changes_no_number():
    """Each block under torch.utils.checkpoint gives the same loss and
    gradients, bit for bit, as the blocks kept whole."""
    tcfg = TC.get_smoke_config("deepseek-v2-lite")
    tree = numpy_weights(CASES["deepseek_smoke"](_Ref), seed=3)
    batch = _t(_batch(tcfg.vocab, B))
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = trainable(model_params_from_numpy(tree, cfg, device="cpu"))
        routes = []
        loss = TMm.loss_fn(params, cfg, batch, routes=routes)
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in params.parameters()],
                      routes)
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
    assert len(out[True][2]) == len(out[False][2]) == tcfg.n_layers - 1


def test_pinned_routes_replace_the_top_k():
    """train_forward(pinned_routes=...) on its own routes changes no
    number; on another run's routes it takes them, weighted by its own
    router probabilities."""
    cfg = TC.get_smoke_config("deepseek-v2-lite")
    params = model_params_from_numpy(
        numpy_weights(CASES["deepseek_smoke"](_Ref), seed=8), cfg,
        device="cpu")
    batch = _t(_batch(cfg.vocab, B))
    own, again, other = [], [], []
    with torch.no_grad():
        logits, aux = TMm.train_forward(params, cfg, batch, routes=own)
        pinned, aux2 = TMm.train_forward(params, cfg, batch, routes=again,
                                         pinned_routes=own)
        flipped = [r.flip(-1).roll(1, dims=0) for r in own]
        TMm.train_forward(params, cfg, batch, routes=other,
                          pinned_routes=flipped)
    assert torch.equal(logits, pinned) and torch.equal(aux, aux2)
    assert all(torch.equal(a, b) for a, b in zip(own, again))
    assert all(torch.equal(a, b) for a, b in zip(other, flipped))


def test_moe_grads_through_capacity_drops():
    """moe_apply under autograd against jax.grad of the reference's, at a
    capacity that drops most (token, expert) pairs; a token whose every
    pair is dropped gets no gradient through the routed experts."""
    jcfg = JMOE.MoEConfig(d_model=16, d_expert=8, n_experts=8, top_k=2,
                          n_shared=0, capacity_factor=0.25)
    tcfg = TMOE.MoEConfig(d_model=16, d_expert=8, n_experts=8, top_k=2,
                          n_shared=0, capacity_factor=0.25)
    rng = np.random.default_rng(5)
    shapes = {"router": (16, 8), "gate": (8, 16, 8), "up": (8, 16, 8),
              "down": (8, 8, 16)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
         for k, s in shapes.items()}
    x = rng.standard_normal((64, 16)).astype(np.float32)
    cot = rng.standard_normal((64, 16)).astype(np.float32)

    def jloss(p, x):
        y, aux = JMOE.moe_apply(p, jcfg, x)
        return jnp.sum(y * cot) + aux

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    routes = []
    y, aux = TMOE.moe_apply(tp, tcfg, tx, routes)
    (torch.sum(y * torch.tensor(cot)) + aux).backward()
    for k in shapes:
        _grad_close(tp[k].grad.numpy(), np.asarray(jg[0][k]), k)
    _grad_close(tx.grad.numpy(), np.asarray(jg[1]), "x")

    capacity = int(max(1, 0.25 * 64 * 2 // 8))
    _, _, _, kept, order = TMOE.dispatch_slots(routes[0], 8, capacity)
    pair_kept = torch.zeros(64 * 2, dtype=torch.bool)
    pair_kept[order] = kept
    dropped = ~pair_kept.reshape(64, 2).any(-1)
    assert int(dropped.sum()) > 0
    tx.grad = None
    y, _ = TMOE.moe_apply(tp, tcfg, tx)
    torch.sum(y * torch.tensor(cot)).backward()          # routed path only
    assert bool((tx.grad[dropped] == 0).all())
    assert bool((tx.grad[~dropped] != 0).any(-1).all())


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_reference(n_micro):
    """Three steps of make_train_step from the same state and batches: the
    losses and the first step's gradient norm; at n_micro 2 also the first
    step's gradients, the microbatches' mean (one batch's gradients are
    held leaf by leaf by test_grads_match_reference_leaf_by_leaf)."""
    jcfg = JC.get_smoke_config("deepseek-v2-lite")
    tcfg = TC.get_smoke_config("deepseek-v2-lite")
    tree = numpy_weights(jcfg, seed=21)
    batches = [_batch(jcfg.vocab, 4, step) for step in range(3)]
    lr = 1e-3

    jparams = jax.tree.map(jnp.asarray, tree)
    jocfg = JA.AdamWConfig(lr=lr)
    jstate = JA.adamw_init(jparams, jocfg)
    jstep = jax.jit(JS.make_train_step(
        jcfg, jocfg, JS.TrainConfig(n_micro=n_micro),
        JA.cosine_schedule(lr, warmup=1, total=3)))
    if n_micro > 1:
        micro = [jax.tree.map(lambda v: jnp.asarray(v).reshape(
            (n_micro, -1) + v.shape[1:])[i], batches[0])
            for i in range(n_micro)]
        gfn = jax.jit(jax.grad(JMm.loss_fn), static_argnums=1)
        want_g = jax.tree.map(lambda *gs: sum(gs) / n_micro,
                              *[gfn(jparams, jcfg, mb) for mb in micro])
        want_g = model_params_from_numpy(jax.tree.map(np.asarray, want_g),
                                         tcfg, device="cpu")
    want = []
    for b in batches:
        jparams, jstate, mets = jstep(jparams, jstate,
                                      jax.tree.map(jnp.asarray, b))
        want.append((float(mets["loss"]), float(mets["grad_norm"])))

    params = trainable(model_params_from_numpy(tree, tcfg, device="cpu"))
    tocfg = TA.AdamWConfig(lr=lr)
    state = TA.adamw_init(params, tocfg)
    if n_micro > 1:
        _, g1 = loss_and_grads(params, tcfg, _t(batches[0]),
                               TrainConfig(n_micro=n_micro))
        for (k, w), g in zip(want_g.named_parameters(), g1):
            _grad_close(g.numpy(), w.detach().numpy(), k)
    step = make_train_step(tcfg, tocfg, TrainConfig(n_micro=n_micro),
                           TA.cosine_schedule(lr, warmup=1, total=3))
    got = []
    for b in batches:
        params, state, mets = step(params, state, _t(b))
        got.append((float(mets["loss"]), float(mets["grad_norm"])))
    assert int(state["step"]) == 3
    np.testing.assert_allclose([x[0] for x in got], [x[0] for x in want],
                               rtol=1e-4)
    np.testing.assert_allclose(got[0][1], want[0][1], rtol=1e-4)


def test_train_step_keeps_f32_accumulators_for_bf16_params():
    cfg = TC.get_smoke_config("mamba2-370m")
    params = trainable(TMm.init_model(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"))
    batch = SyntheticPipeline.for_model(cfg, S, 4, device="cpu").batch_at(0)
    one = loss_and_grads(params, cfg, batch, TrainConfig(n_micro=1))
    two = loss_and_grads(params, cfg, batch, TrainConfig(n_micro=2))
    assert [g.dtype for g in one[1]] == [p.dtype for p in params.parameters()]
    assert all(g.dtype == torch.float32 for g in two[1])
    assert one[0].dtype == two[0].dtype == torch.float32


# ---------------------------------------------------------------------------
# The fault-tolerant loop and the launcher
# ---------------------------------------------------------------------------

def _loop(cfg, ckpt, total, fault=None):
    params = trainable(TMm.init_model(cfg, torch.Generator().manual_seed(0),
                                      device="cpu", dtype=torch.float32))
    ocfg = TA.AdamWConfig(lr=1e-3)
    return train_loop(make_train_step(cfg, ocfg), params,
                      TA.adamw_init(params, ocfg),
                      SyntheticPipeline.for_model(cfg, S, 2, device="cpu"),
                      ckpt, LoopConfig(total_steps=total, ckpt_every=5,
                                       log_every=1), fault_hook=fault)


def test_loop_survives_induced_failure(tmp_path):
    """The reference's test on a port smoke config: a failure before step
    7, a checkpoint every 5 steps, 12 steps; then a warm start from the
    latest checkpoint replays the last steps exactly."""
    cfg = TC.get_smoke_config("deepseek-v2-lite")
    fired = []

    def fault(step):
        if step == 7 and not fired:
            fired.append(step)
            raise RuntimeError("induced node failure")

    _, _, log = _loop(cfg, CheckpointManager(tmp_path), 12, fault)
    events = [e for e in log if e.get("event") == "restored"]
    assert len(events) == 1 and events[0]["step"] == 5
    assert "induced node failure" in events[0]["error"]
    steps = [e["step"] for e in log if "loss" in e]
    assert steps == list(range(7)) + list(range(5, 12))
    by_step = {}
    for e in log:
        if "loss" in e:
            assert np.isfinite(e["loss"])
            # exact replay from the stateless pipeline and the restore
            assert by_step.setdefault(e["step"], e["loss"]) == e["loss"]
    _, _, again = _loop(cfg, CheckpointManager(tmp_path), 12)
    assert [e["step"] for e in again] == [10, 11]
    assert [e["loss"] for e in again] == [by_step[10], by_step[11]]


def test_loop_restores_the_snapshot_still_being_written(tmp_path,
                                                        monkeypatch):
    """A failure right after a checkpoint step, while its write is still in
    flight, restores that snapshot: the loop finishes the write before it
    chooses (the reference's loop chooses first and finds none)."""
    import time
    from repro_torch.checkpoint import manager
    savez = manager.np.savez

    def slow(*a, **k):
        time.sleep(0.5)
        return savez(*a, **k)

    monkeypatch.setattr(manager.np, "savez", slow)
    cfg = TC.get_smoke_config("mamba2-370m")
    fired = []

    def fault(step):
        if step == 5 and not fired:
            fired.append(step)
            raise RuntimeError("failure during the write")

    _, _, log = _loop(cfg, CheckpointManager(tmp_path), 6, fault)
    assert [e["step"] for e in log if e.get("event")] == [5]
    assert [e["step"] for e in log if "loss" in e] == [0, 1, 2, 3, 4, 5]


def test_cli_smoke_on_cpu(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-370m", "--smoke", "--steps", "4", "--ckpt-every", "2",
         "--ckpt-dir", str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert re.fullmatch(r"\[train\] mamba2-smoke: 0\.07M params", lines[-2])
    assert re.fullmatch(r"\[train\] 4 steps in \S+s; loss \S+ -> \S+; "
                        r"checkpoints: \[2, 4\]", lines[-1])


def test_cli_refuses_the_full_config_and_a_missing_card(monkeypatch):
    """Without --smoke the full config goes to the production-mesh dry run
    (launch/dryrun.run_cell, train_4k on (16, 16)): exit 0 if and only if
    its record is ok (the dry run itself: tests/test_torch_dryrun.py)."""
    from repro_torch.launch import dryrun
    calls = []
    for ok, code in ((True, 0), (False, 1)):
        monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: (
            calls.append((a, k)), {"ok": ok})[1])
        with pytest.raises(SystemExit) as exc:
            launch_train.main(["--arch", "mamba2-370m", "--device", "cpu"])
        assert exc.value.code == code
    assert calls == [(("mamba2-370m", "train_4k", False),
                      {"force": True})] * 2
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            launch_train.main(["--arch", "mamba2-370m", "--smoke"])
