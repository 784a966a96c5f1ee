"""Port parity of the training substrate's AdamW, learning-rate schedule,
data pipeline and checkpoint format (repro_torch.optim, .data,
.checkpoint) against the JAX package, on the CPU.

* adamw_update against repro.optim.adamw.adamw_update on the same
  parameters, gradients and state (nonzero moments at step 2): f32 and
  bf16 parameters, f32 and bf16 moments, a clipped case and a weight-decay
  case (vectors are not decayed). f32 results within rtol 1e-6 (the global
  norm sums in another order, one ulp of the clip scale), bf16 results
  within one bf16 ulp (one rounding of a value that may differ by an ulp
  of f32 before it);
* three AdamW steps with weight decay on a whole model's tree, the JAX
  package's stacked layers against the port's lists of layers
  (decay_mask), for a MoE model with a dense first block, Mamba2 and the
  Zamba2 hybrid (two stacked levels): every leaf within rtol 1e-6;
* cosine_schedule at every step of a short run, within 1e-7 absolute;
* the pipeline's properties (the reference's tests/test_substrates.py:
  a deterministic resume, targets equal to the shifted tokens) and its
  copy chain against the loop it replaces; its tokens come from a torch
  generator and differ from jax.random's (the parity tests inject the
  reference's batch);
* checkpoints either package writes restore in the other bit for bit, and
  the reference's round-trip, keep-last-k and async tests.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.data import pipeline as JP
from repro.optim import adamw as JA
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import pipeline as TP
from repro_torch.data.pipeline import (DataConfig, SyntheticPipeline,
                                       copy_chain)
from repro_torch.models.model import ModelConfig
from repro_torch.optim import adamw as TA

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in bf16 ulps between two bf16 arrays (as ml_dtypes)."""
    def ordered(x):
        i = x.view(np.int16).astype(np.int32)
        return np.where(i < 0, -(i & 0x7FFF), i)
    return np.abs(ordered(a) - ordered(b))


def _close(got: torch.Tensor, want, name: str):
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        g = got.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        assert _bf16_ulps(g, want.astype(ml_dtypes.bfloat16)).max() <= 1, \
            name
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   err_msg=name)


ADAMW_CASES = {
    "plain": dict(weight_decay=0.0, grad_clip=1e9),
    "clipped": dict(weight_decay=0.0, grad_clip=0.5),
    "weight_decay": dict(weight_decay=0.1, grad_clip=1e9),
}


@pytest.mark.parametrize("state_dt", ["f32", "bf16"])
@pytest.mark.parametrize("param_dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_update_matches_reference(case, param_dt, state_dt):
    rng = np.random.default_rng(7)
    shapes = {"b": (8,), "e": (2, 3, 4), "w": (16, 8)}   # sorted: leaf order
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: 0.3 * rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: 0.05 * rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: 0.01 * rng.random(s).astype(np.float32) for k, s in shapes.items()}
    kw = ADAMW_CASES[case]
    pdt, sdt = JAX_DT[param_dt], JAX_DT[state_dt]
    jcfg = JA.AdamWConfig(lr=1e-2, state_dtype=sdt, **kw)
    tcfg = TA.AdamWConfig(lr=1e-2, state_dtype=TORCH_DT[state_dt], **kw)

    jtree = lambda d, dt: {k: jnp.asarray(x).astype(dt) for k, x in d.items()}
    jstate = {"m": jtree(m, sdt), "v": jtree(v, sdt),
              "step": jnp.asarray(2, jnp.int32)}
    want_p, want_s, want_met = JA.adamw_update(jtree(p, pdt), jtree(g, pdt),
                                               jstate, jcfg)

    tlist = lambda d, dt: [torch.tensor(np.asarray(jnp.asarray(d[k])
                                                   .astype(JAX_DT[dt])
                                                   .astype(jnp.float32)))
                           .to(TORCH_DT[dt]) for k in sorted(shapes)]
    params = tlist(p, param_dt)
    state = {"m": tlist(m, state_dt), "v": tlist(v, state_dt),
             "step": torch.tensor(2, dtype=torch.int32)}
    out, state, met = TA.adamw_update(params, tlist(g, param_dt), state, tcfg)
    assert out is params and int(state["step"]) == 3
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(want_met["grad_norm"]), rtol=1e-6)
    for i, k in enumerate(sorted(shapes)):
        _close(params[i], np.asarray(want_p[k]), f"param {k}")
        _close(state["m"][i], np.asarray(want_s["m"][k]), f"m {k}")
        _close(state["v"][i], np.asarray(want_s["v"][k]), f"v {k}")
    if case == "weight_decay":
        # decay moves the matrices and leaves the vector as without decay
        plain = tlist(p, param_dt)
        TA.adamw_update(plain, tlist(g, param_dt),
                        {"m": tlist(m, state_dt), "v": tlist(v, state_dt),
                         "step": torch.tensor(2, dtype=torch.int32)},
                        TA.AdamWConfig(lr=1e-2, weight_decay=0.0,
                                       grad_clip=1e9,
                                       state_dtype=TORCH_DT[state_dt]))
        same = [torch.equal(a, b) for a, b in zip(params, plain)]
        assert same == [True, False, False]          # b, e, w


def test_adamw_first_step_is_lr_sized():
    cfg = TA.AdamWConfig(lr=1e-2, weight_decay=0.0, grad_clip=1e9)
    params = [torch.ones((4, 4))]
    st = TA.adamw_init(params, cfg)
    TA.adamw_update(params, [torch.full((4, 4), 0.5)], st, cfg)
    # bias-corrected first step: delta ~ lr * sign(g)
    np.testing.assert_allclose(1.0 - params[0].numpy(), 1e-2, rtol=1e-3)


def test_grad_norm_is_reported_before_the_clip():
    cfg = TA.AdamWConfig(grad_clip=1.0)
    params = [torch.zeros((8,))]
    st = TA.adamw_init(params, cfg)
    _, _, mets = TA.adamw_update(params, [torch.full((8,), 100.0)], st, cfg)
    np.testing.assert_allclose(float(mets["grad_norm"]), 100.0 * 8 ** 0.5,
                               rtol=1e-6)


def test_bf16_states_track_f32():
    g = torch.Generator().manual_seed(0)
    w = torch.randn((16, 16), generator=g)
    grad = 0.01 * torch.randn((16, 16), generator=g)
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        cfg = TA.AdamWConfig(state_dtype=dt)
        params = [w.clone()]
        st = TA.adamw_init(params, cfg)
        assert st["m"][0].dtype == dt and st["v"][0].dtype == dt
        TA.adamw_update(params, [grad], st, cfg)
        outs[dt] = params[0].numpy()
    np.testing.assert_allclose(outs[torch.float32], outs[torch.bfloat16],
                               atol=1e-4)


def test_adamw_updates_a_module_in_place_without_grad():
    lin = torch.nn.Linear(4, 3)
    before = [p.detach().clone() for p in lin.parameters()]
    ptrs = [p.data_ptr() for p in lin.parameters()]
    cfg = TA.AdamWConfig(lr=1e-2)
    st = TA.adamw_init(lin, cfg)
    grads = [torch.ones_like(p) for p in lin.parameters()]
    TA.adamw_update(lin, grads, st, cfg)
    assert [p.data_ptr() for p in lin.parameters()] == ptrs
    assert all(p.grad is None and p.requires_grad for p in lin.parameters())
    assert all(not torch.equal(a, b) for a, b in zip(before,
                                                     lin.parameters()))


DECAY_ARCHS = ("deepseek-v2-lite", "mamba2-370m", "zamba2-7b")


@pytest.mark.parametrize("arch", DECAY_ARCHS)
def test_adamw_decays_what_the_reference_decays(arch):
    """Three steps of adamw_update with weight decay 0.1 from the same
    weights and gradients (numpy trees in the reference's layout, carried
    into the port by model_params_from_numpy): the reference stacks a
    block's norm scales and SSM vectors over layer axes and decays them as
    matrices, so the port, whose layers are lists, decays them by
    decay_mask."""
    from repro import configs as JC
    from repro_torch import configs as TC
    from repro_torch.convert import model_params_from_numpy
    from torch_parity import numpy_weights
    jcfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
    tree = numpy_weights(jcfg, seed=5)
    rng = np.random.default_rng(6)
    grads = [jax.tree.map(lambda x: (1e-3 * rng.standard_normal(x.shape))
                          .astype(np.float32), tree) for _ in range(3)]
    port = lambda t: model_params_from_numpy(
        jax.tree.map(np.asarray, t), tcfg, device="cpu")

    jparams = jax.tree.map(jnp.asarray, tree)
    jocfg = JA.AdamWConfig(weight_decay=0.1)
    jstate = JA.adamw_init(jparams, jocfg)
    for g in grads:
        jparams, jstate, _ = JA.adamw_update(
            jparams, jax.tree.map(jnp.asarray, g), jstate, jocfg)

    params = port(tree)
    decay = TA.decay_mask(params)
    assert not all(decay) and any(decay)
    tocfg = TA.AdamWConfig(weight_decay=0.1)
    state = TA.adamw_init(params, tocfg)
    for g in grads:
        TA.adamw_update(params, list(port(g).parameters()), state, tocfg,
                        decay=decay)
    for (k, got), want in zip(params.named_parameters(),
                              port(jparams).parameters()):
        _close(got.detach(), want.detach().numpy(), k)


def test_decay_mask_counts_the_stacked_levels():
    """A model's 1-D leaves decay under one stacked level ("blocks") or
    two ("groups"), and not at the top (the final norm) or in the hybrid's
    shared block."""
    from repro_torch import configs as TC
    from repro_torch.models.model import init_model
    for arch, want in (("deepseek-v2-lite", {"final_norm.scale": False,
                                             "blocks.0.ln1.scale": True,
                                             "dense_blocks.0.attn.q_norm":
                                             True, "embed.table": True}),
                       ("zamba2-7b", {"groups.0.0.mamba.dt_bias": True,
                                      "shared_attn.ln.scale": False,
                                      "shared_attn.mlp.gate.w": True})):
        model = init_model(TC.get_smoke_config(arch), device="meta")
        got = dict(zip((k for k, _ in model.named_parameters()),
                       TA.decay_mask(model)))
        assert {k: got[k] for k in want} == want, arch


def test_cosine_schedule_matches_reference():
    want = JA.cosine_schedule(1e-3, warmup=3, total=20)
    got = TA.cosine_schedule(1e-3, warmup=3, total=20)
    for step in range(25):
        w = float(want(jnp.asarray(step, jnp.int32)))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            g = got(arg)
            assert g.dtype == torch.float32
            assert abs(float(g) - w) <= 1e-7, (step, float(g), w)
    assert float(got(0)) == 0.0                     # warmup starts at 0


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

def test_deterministic_resume():
    p = SyntheticPipeline(DataConfig(vocab=100, seq_len=8, global_batch=4),
                          device="cpu")
    a, b = p.batch_at(7), p.batch_at(7)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["targets"], b["targets"])
    c = p.batch_at(8)
    assert not torch.equal(a["tokens"], c["tokens"])
    again = SyntheticPipeline(DataConfig(vocab=100, seq_len=8,
                                         global_batch=4), device="cpu")
    assert torch.equal(again.batch_at(7)["tokens"], a["tokens"])
    other = SyntheticPipeline(DataConfig(vocab=100, seq_len=8,
                                         global_batch=4, seed=1),
                              device="cpu")
    assert not torch.equal(other.batch_at(7)["tokens"], a["tokens"])


def test_targets_are_shifted_tokens():
    p = SyntheticPipeline(DataConfig(vocab=100, seq_len=8, global_batch=2),
                          device="cpu")
    b = p.batch_at(0)
    assert b["tokens"].shape == b["targets"].shape == (2, 8)
    assert b["tokens"].dtype == torch.int64
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_tokens_follow_the_corpus_distribution():
    """Zipf-like squared-uniform marginal (P(token < k) = sqrt(k / vocab))
    with each token copying its predecessor with probability 1/2."""
    vocab = 1000
    b = SyntheticPipeline(DataConfig(vocab=vocab, seq_len=512,
                                     global_batch=16),
                          device="cpu").batch_at(3)
    t = b["tokens"]
    assert int(t.min()) >= 0 and int(t.max()) < vocab
    repeats = float((t[:, 1:] == t[:, :-1]).float().mean())
    assert 0.45 < repeats < 0.6
    np.testing.assert_allclose(float((t < 100).float().mean()),
                               np.sqrt(100 / vocab), atol=0.05)


def test_copy_chain_equals_the_loop():
    g = torch.Generator().manual_seed(3)
    fresh = torch.randint(0, 50, (5, 40), generator=g)
    copy = torch.rand((5, 40), generator=g) < 0.5
    want = fresh.clone()
    for t in range(1, fresh.shape[1]):         # the reference's scan
        want[:, t] = torch.where(copy[:, t], want[:, t - 1], fresh[:, t])
    assert torch.equal(copy_chain(fresh, copy), want)


def test_for_model_and_canonical_corpus_match_reference():
    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=8,
                      vocab=321)
    p = SyntheticPipeline.for_model(cfg, seq_len=12, global_batch=3, seed=5,
                                    device="cpu")
    assert (p.cfg.vocab, p.cfg.seq_len, p.cfg.global_batch, p.cfg.seed) == \
        (321, 12, 3, 5)
    np.testing.assert_array_equal(TP.canonical_corpus(4, 16, 100),
                                  JP.canonical_corpus(4, 16, 100))
    # the stub-input families: the reference's DataConfig, field by field
    # (the VLM's text is the sequence less its patches)
    from repro import configs as JC
    from repro_torch import configs as TC
    for arch in ("llava-next-mistral-7b", "whisper-large-v3"):
        got = SyntheticPipeline.for_model(TC.get_config(arch), seq_len=2048,
                                          global_batch=2, seed=5,
                                          device="cpu").cfg
        want = JP.SyntheticPipeline.for_model(JC.get_config(arch),
                                              seq_len=2048, global_batch=2,
                                              seed=5).cfg
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _trees():
    """The same nested tree of bf16, f32 and int32 leaves in both
    packages (the reference's as jax arrays, the port's as tensors)."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    c = rng.standard_normal((4,)).astype(np.float32)
    d = rng.standard_normal((2, 2, 3)).astype(np.float32)
    jt = {"b": {"d": jnp.asarray(d), "c": jnp.asarray(c).astype(jnp.bfloat16)},
          "a": jnp.asarray(a).astype(jnp.bfloat16),
          "step": jnp.asarray(9, jnp.int32)}
    tt = {"b": {"d": torch.tensor(d),
                "c": torch.tensor(c).to(torch.bfloat16)},
          "a": torch.tensor(a).to(torch.bfloat16),
          "step": torch.tensor(9, dtype=torch.int32)}
    return jt, tt


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.reshape(-1).view(torch.uint8).numpy()


def _jbits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def test_reference_checkpoint_restores_bit_for_bit(tmp_path):
    jt, tt = _trees()
    JCkpt(tmp_path).save(4, jt, blocking=True)
    target = _zeros_like(tt)
    leaves = [target["a"], target["b"]["c"], target["b"]["d"],
              target["step"]]
    back = CheckpointManager(tmp_path).restore(4, target)
    assert back is target
    for got, want in zip(leaves, [jt["a"], jt["b"]["c"], jt["b"]["d"],
                                  jt["step"]]):
        assert got.dtype == tt_dtype(want)
        np.testing.assert_array_equal(_bits(got), _jbits(want))


def tt_dtype(x):
    return {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
            jnp.int32: torch.int32}[jnp.dtype(x.dtype).type]


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    jt, tt = _trees()
    CheckpointManager(tmp_path).save(7, tt, blocking=True)
    manifest = json.loads((tmp_path / "step_00000007" /
                           "manifest.json").read_text())
    assert manifest["dtypes"] == ["bfloat16", "bfloat16", "float32", "int32"]
    assert manifest["shapes"] == [[3, 5], [4], [2, 2, 3], []]
    assert manifest["step"] == 7 and manifest["n_leaves"] == 4
    back = JCkpt(tmp_path).restore(7, jax.tree.map(jnp.zeros_like, jt))
    for got, want in zip(jax.tree.leaves(back), [tt["a"], tt["b"]["c"],
                                                 tt["b"]["d"], tt["step"]]):
        np.testing.assert_array_equal(_jbits(got), _bits(want))


def test_roundtrip(tmp_path):
    cm = CheckpointManager(tmp_path)
    tree = {"a": torch.arange(6).reshape(2, 3).to(torch.bfloat16),
            "b": {"c": torch.ones((4,), dtype=torch.float32)}}
    cm.save(10, tree, blocking=True)
    back = cm.restore(10, _zeros_like(tree))
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"]["c"], tree["b"]["c"])
    assert cm.latest_step() == 10


def test_restore_copies_into_live_tensors(tmp_path):
    cm = CheckpointManager(tmp_path)
    mod = torch.nn.Linear(3, 2)
    state = {"params": mod, "opt": {"m": [torch.ones(2, 3), torch.ones(2)],
                                    "step": torch.tensor(5)}}
    cm.save(1, state, blocking=True)
    want = [p.detach().clone() for p in mod.parameters()]
    ptrs = [p.data_ptr() for p in mod.parameters()]
    with torch.no_grad():
        for p in mod.parameters():
            p.zero_()
    state["opt"]["step"].zero_()
    cm.restore(1, state)
    assert [p.data_ptr() for p in mod.parameters()] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(mod.parameters(), want))
    assert int(state["opt"]["step"]) == 5
    with pytest.raises(ValueError, match="leaf count"):
        cm.restore(1, {"params": mod})


def test_gc_keeps_last_k(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.zeros((2,))}
    for s in (1, 2, 3, 4):
        cm.save(s, tree, blocking=True)
    assert cm.all_steps() == [3, 4]


def test_async_save(tmp_path):
    cm = CheckpointManager(tmp_path)
    tree = {"a": torch.zeros((1000,))}
    cm.save(5, tree, blocking=False)
    tree["a"].fill_(1.0)           # the host copy was taken before return
    cm.wait()
    assert cm.latest_step() == 5
    assert float(cm.restore(5, {"a": torch.ones(1000)})["a"].sum()) == 0.0


def test_a_failed_async_write_is_raised_by_wait(tmp_path):
    cm = CheckpointManager(tmp_path)
    (tmp_path / "step_00000003.tmp").write_text("a file where a dir goes")
    cm.save(3, {"a": torch.zeros(2)}, blocking=False)
    with pytest.raises(FileExistsError):
        cm.wait()
    cm.wait()                      # raised once
