"""Port parity of the model's serving form (repro_torch.models.model):
prefill and decode_step against the JAX package's on the same weights,
made with numpy in the reference's parameter layout and carried across by
convert.model_params_from_numpy, for

* the DeepSeek smoke config (q_lora_rank 48, MoE with a dense first layer);
* a V2-Lite-shaped tiny config (q_lora_rank None, top-3 of 8 experts with
  two shared);
* the DeepSeek smoke config with selection_k > 0 (top-k decode through
  sparse_select at token granularity);
* the Mamba2 smoke config (prefill through ssd_chunk, the recurrent decode);

plus the configs, the MoE dispatch's capacity drops, the MoE layer in bf16,
the indexer's init, and the reference's decode-over-unwritten-slots
behaviour (ROADMAP C), which the port reproduces.

Tolerances. The whole model is held in f32 (bf16 rounds in other places in
the two packages, and a flipped router top-k moves a logit far): logits and
caches at atol 1e-4 / rtol 1e-4 — the port attends in absorbed form where
the reference decompresses (2e-5 per layer, tests/test_mla.py:41-42) and
the SSD recurrence sums in another order (2e-4 / 1e-3 per mixer,
tests/test_ssd_kernel.py:58-61, which the Mamba2 case keeps). The MoE layer
alone in bf16, on equal routes, at 2e-2 absolute and relative (bf16's
2^-8 relative step, a few roundings deep)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core import selection as JSEL
from repro.models import mla as JMLA
from repro.models import model as JMm
from repro.models import moe as JMOE
from repro.models import ssm as JSSM
from repro.models.module import KeyGen, split
from repro_torch import configs as TC
from repro_torch.convert import model_params_from_numpy
from repro_torch.core import selection as TSEL
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.mla_decode import ops as mla_ops
from repro_torch.kernels.sparse_select import ops as sel_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.models import mla as TMLA
from repro_torch.models import model as TMm
from repro_torch.models import moe as TMOE
from repro_torch.models import ssm as TSSM
from repro_torch.models.module import Tree, count_params
from torch_parity import (numpy_weights, ref_fill_decode_state,
                          tiny_v2_lite as _tiny_v2_lite)

TOL = dict(atol=1e-4, rtol=1e-4)
SSM_TOL = dict(atol=2e-4, rtol=1e-3)
B, S, STEPS = 2, 16, 3


class _Ref:
    model, mla, moe = JMm, JMLA, JMOE


class _Port:
    model, mla, moe = TMm, TMLA, TMOE


CASES = {
    "deepseek_smoke": lambda m: (JC if m is _Ref else TC).get_smoke_config(
        "deepseek-v2-lite"),
    "v2_lite_tiny": _tiny_v2_lite,
    "selection": lambda m: dataclasses.replace(
        (JC if m is _Ref else TC).get_smoke_config("deepseek-v2-lite"),
        selection_k=5),
    "mamba2_smoke": lambda m: (JC if m is _Ref else TC).get_smoke_config(
        "mamba2-370m"),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    """The case's prefill of S tokens and STEPS decode steps, reference and
    port, on one weight tree; decode runs on a cache of S + STEPS + 1
    slots."""
    jcfg, tcfg = CASES[request.param](_Ref), CASES[request.param](_Port)
    tree = numpy_weights(jcfg, seed=len(request.param))
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab, (STEPS, B, 1)).astype(np.int32)
    seq = S + STEPS + 1

    jparams = jax.tree.map(jnp.asarray, tree)
    logits, caches = jax.jit(JMm.prefill, static_argnums=1)(
        jparams, jcfg, {"tokens": jnp.asarray(prompt)})
    ref = {"prefill": np.asarray(logits),
           "caches": jax.tree.map(np.asarray, caches), "decode": []}
    state = ref_fill_decode_state(
        jcfg, JMm.init_decode_state(jcfg, B, seq, dtype=jnp.float32), caches)
    dec = jax.jit(JMm.decode_step, static_argnums=1)
    for i in range(STEPS):
        lg, state = dec(jparams, jcfg, state, jnp.asarray(steps[i]),
                        jnp.full((B, 1), S + i, jnp.int32), S + i)
        ref["decode"].append(np.asarray(lg))
    ref["state"] = jax.tree.map(np.asarray, state)

    params = model_params_from_numpy(tree, tcfg, device="cpu")
    counters = (fp_ops.flash_prefill, mla_ops.mla_decode,
                sel_ops.sparse_select, ssd_ops.ssd_intra_chunk)
    before = [c.launches for c in counters]
    routes = []
    logits, caches = TMm.prefill(params, tcfg,
                                 {"tokens": torch.tensor(prompt)},
                                 routes=routes)
    port = {"prefill": logits.numpy(), "routes": routes,
            "caches": jax.tree.map(lambda t: t.numpy().copy(), caches),
            "decode": []}
    state = TMm.fill_decode_state(
        tcfg, TMm.init_decode_state(tcfg, B, seq, dtype=torch.float32,
                                    device="cpu"), caches)
    for i in range(STEPS):
        lg, state = TMm.decode_step(params, tcfg, state,
                                    torch.tensor(steps[i]),
                                    torch.full((B, 1), S + i), S + i)
        port["decode"].append(lg.numpy())
    port["state"] = jax.tree.map(lambda t: t.numpy(), state)
    assert [c.launches for c in counters] == before   # CPU: plain versions
    return request.param, jcfg, tcfg, ref, port


def test_forward_matches_reference():
    """The full-sequence forward: every position's logits and the MoE aux
    term (the reference's prefill slices its last position)."""
    jcfg = JC.get_smoke_config("deepseek-v2-lite")
    tcfg = TC.get_smoke_config("deepseek-v2-lite")
    tree = numpy_weights(jcfg, 4)
    tokens = np.random.default_rng(2).integers(0, 256, (B, S)).astype(
        np.int32)
    want, _, want_aux = jax.jit(JMm.forward, static_argnums=1)(
        jax.tree.map(jnp.asarray, tree), jcfg, {"tokens": jnp.asarray(tokens)})
    params = model_params_from_numpy(tree, tcfg, device="cpu")
    got, caches, aux = TMm.forward(params, tcfg,
                                   {"tokens": torch.tensor(tokens)})
    assert caches is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    last, _ = TMm.prefill(params, tcfg, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), atol=1e-6,
                               rtol=1e-6)


def _tol(name):
    return SSM_TOL if name.startswith("mamba2") else TOL


def test_prefill_matches_reference(run):
    name, jcfg, _, ref, port = run
    assert port["prefill"].shape == (B, 1, jcfg.vocab)
    np.testing.assert_allclose(port["prefill"], ref["prefill"], **_tol(name))


def test_prefill_caches_match_reference(run):
    name, _, _, ref, port = run
    want = jax.tree.leaves(ref["caches"])
    got = jax.tree.leaves(port["caches"])
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **_tol(name))


def test_decode_steps_match_reference(run):
    name, _, _, ref, port = run
    for g, w in zip(port["decode"], ref["decode"]):
        np.testing.assert_allclose(g, w, **_tol(name))
    for g, w in zip(jax.tree.leaves(port["state"]),
                    jax.tree.leaves(ref["state"])):
        np.testing.assert_allclose(g, w, **_tol(name))


def test_cache_layout_is_the_references(run):
    name, jcfg, tcfg, _, port = run
    if name.startswith("mamba2"):
        s = tcfg.ssm
        h, conv = port["caches"]["blocks"]
        assert h.shape == (tcfg.n_layers, B, s.n_heads, s.head_dim,
                           s.d_state)
        assert conv.shape == (tcfg.n_layers, B, s.d_conv - 1,
                              s.d_inner + 2 * s.d_state)
    else:
        assert port["caches"]["dense_blocks"].shape == (1, B, S,
                                                        tcfg.mla.d_qk)
        assert port["caches"]["blocks"].shape == (tcfg.n_layers - 1, B, S,
                                                  tcfg.mla.d_qk)
        assert len(port["routes"]) == tcfg.n_layers - 1
        assert all(r.shape == (B * S, tcfg.moe.top_k)
                   for r in port["routes"])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair", [
    (TMm.ModelConfig, JMm.ModelConfig), (TMOE.MoEConfig, JMOE.MoEConfig),
    (TSSM.Mamba2Config, JSSM.Mamba2Config),
    (TMLA.MLAConfig, JMLA.MLAConfig)], ids=lambda p: p[0].__name__)
def test_config_fields_equal_the_references(pair):
    port, ref = pair
    strip = lambda cls: [(f.name, f.default) for f in
                         dataclasses.fields(cls)]
    assert strip(port) == strip(ref)
    if port is TMOE.MoEConfig:
        assert (port.router_dtype, jnp.dtype(ref.router_dtype)) \
            == (torch.float32, jnp.float32)


ALL_ARCHS = JC.ARCH_IDS + ["deepseek-v2-lite"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_registry_configs_equal_the_references(arch, which):
    get = {"config": "get_config", "smoke": "get_smoke_config"}[which]
    port, ref = getattr(TC, get)(arch), getattr(JC, get)(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.kv_bytes_token_layer == ref.kv_bytes_token_layer


def test_registry_equals_the_references():
    """Every id and alias of the reference resolves in the port, with the
    reference's shapes, long-context archs and dry-run cells."""
    assert TC.ARCH_IDS == JC.ARCH_IDS and TC.ALIASES == JC.ALIASES
    assert TC.LONG_CTX_ARCHS == JC.LONG_CTX_ARCHS
    assert TC.SHAPES.keys() == JC.SHAPES.keys()
    assert all(dataclasses.asdict(TC.SHAPES[k])
               == dataclasses.asdict(JC.SHAPES[k]) for k in TC.SHAPES)
    for arch in list(JC.ALIASES) + JC.ARCH_IDS:
        assert TC.supported_shapes(arch) == JC.supported_shapes(arch)
        assert TC.get_config(arch).name == JC.get_config(arch).name
    assert TC.all_cells() == JC.all_cells()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_equals_the_references(arch):
    jcfg = JC.get_config(arch)
    abstract = jax.eval_shape(lambda k: split(JMm.init_model(jcfg, k))[0],
                              jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(abstract))
    got = count_params(TMm.init_model(TC.get_config(arch), device="meta"))
    assert got == want
    known = {"deepseek-v2-lite": 15_496_769_024, "mamba2-370m": 368_338_432,
             "zamba2-7b": 6_636_442_832}
    assert got == known.get(arch, got)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def test_init_model_draws_on_the_device_from_the_generator():
    cfg = TC.get_smoke_config("deepseek-v2-lite")
    draw = lambda: TMm.init_model(cfg, torch.Generator().manual_seed(0),
                                  device="cpu", dtype=torch.float32)
    a, b = draw(), draw()
    for (name, x), y in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    table = a["embed"]["table"]
    assert float(table.abs().max()) <= 2.0          # truncated on [-2, 2]
    # the reference's fan_in is a tensor's first axis: for the stacked
    # experts (E, d_model, d_expert) that is E
    w = a["blocks"][0]["moe"]["up"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(cfg.moe.n_experts) + 1e-7
    assert float(w.abs().max()) > 2.0 / np.sqrt(cfg.d_model)
    assert a["blocks"][0]["moe"]["router"].dtype == torch.float32
    assert a["blocks"][0]["ln1"]["scale"].eq(1).all()
    bf = TMm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert bf["embed"]["table"].dtype == torch.bfloat16
    assert bf["blocks"][0]["moe"]["router"].dtype == torch.float32


def test_model_params_from_numpy_checks_shapes():
    jcfg = JC.get_smoke_config("mamba2-370m")
    tree = numpy_weights(jcfg, 0)
    tree["blocks"]["mamba"]["in_proj"] = np.zeros((2, 3, 3), np.float32)
    with pytest.raises(ValueError, match="in_proj"):
        model_params_from_numpy(tree, TC.get_smoke_config("mamba2-370m"),
                                device="cpu")
    tree = numpy_weights(jcfg, 0)
    del tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        model_params_from_numpy(tree, TC.get_smoke_config("mamba2-370m"),
                                device="cpu")


def test_indexer_init_and_scores_match_reference():
    cfg = TSEL.IndexerConfig(d_model=2048, d_index=64)
    jcfg = JSEL.IndexerConfig(**dataclasses.asdict(cfg))
    jp, _ = split(JSEL.init_indexer(KeyGen(jax.random.PRNGKey(0)), jcfg,
                                    dtype=jnp.float32))
    tp = TSEL.init_indexer(torch.Generator().manual_seed(0), cfg,
                           dtype=torch.float32, device="cpu")
    assert tp.keys() == jp.keys()
    bound = 2.0 / np.sqrt(cfg.d_model)
    for k in tp:
        assert tuple(tp[k].shape) == jp[k].shape
        # the same law: N(0, 1) truncated on [-2, 2], scaled 1/sqrt(fan_in)
        # (std 0.8796 / sqrt(fan_in)); 131072 draws hold it within 1%
        for v in (tp[k].numpy(), np.asarray(jp[k])):
            assert np.abs(v).max() <= bound + 1e-7
            assert abs(v.std() * np.sqrt(cfg.d_model) / 0.8796 - 1) < 0.01
    assert TSEL.init_indexer(torch.Generator(), cfg, device="cpu")[
        "q_proj"].dtype == torch.bfloat16
    carried = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((40, cfg.d_model)).astype(np.float32)
    want = JSEL.index_scores(jp, jnp.asarray(x),
                             JSEL.index_keys(jp, jnp.asarray(ctx)))
    got = TSEL.index_scores(carried, torch.tensor(x),
                            TSEL.index_keys(carried, torch.tensor(ctx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_weights(cfg, seed, hot_expert=None):
    rng = np.random.default_rng(seed)
    e, dm, df = cfg.n_experts, cfg.d_model, cfg.d_expert
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(
        np.float32)
    p = {"router": w(dm, e), "gate": w(e, dm, df), "up": w(e, dm, df),
         "down": w(e, df, dm), "sh_gate": w(dm, cfg.n_shared * df),
         "sh_up": w(dm, cfg.n_shared * df),
         "sh_down": w(cfg.n_shared * df, dm)}
    if hot_expert is not None:            # one expert every token wants
        p["router"][:, hot_expert] += 0.5
    return p


def test_moe_drops_the_references_pairs_past_capacity():
    """An expert over its capacity drops its latest pairs: the port keeps
    exactly the reference's pairs (its output equals the reference's), and
    some pairs are dropped."""
    cfg = TMOE.MoEConfig(d_model=32, d_expert=16, n_experts=8, top_k=2,
                         n_shared=1)
    jcfg = JMOE.MoEConfig(**dataclasses.asdict(cfg))
    p = _moe_weights(cfg, 0, hot_expert=3)
    x = np.random.default_rng(1).standard_normal((2, 20, 32)).astype(
        np.float32)
    want, want_aux = JMOE.moe_apply(jax.tree.map(jnp.asarray, p), jcfg,
                                    jnp.asarray(x))
    routes = []
    got, aux = TMOE.moe_apply(Tree(jax.tree.map(torch.tensor, p)), cfg,
                              torch.tensor(x), routes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    capacity = int(1.25 * 40 * 2 // 8)
    *_, kept, _ = TMOE.dispatch_slots(routes[0], 8, capacity)
    assert 0 < int((~kept).sum())
    # a decode batch: T = 2 gives capacity 1
    x2 = x[:, :1]
    want2, _ = JMOE.moe_apply(jax.tree.map(jnp.asarray, p), jcfg,
                              jnp.asarray(x2))
    got2, _ = TMOE.moe_apply(Tree(jax.tree.map(torch.tensor, p)), cfg,
                             torch.tensor(x2))
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=1e-5,
                               rtol=1e-5)


def test_moe_bf16_matches_reference_on_equal_routes():
    cfg = TMOE.MoEConfig(d_model=64, d_expert=32, n_experts=8, top_k=2,
                         n_shared=2)
    jcfg = JMOE.MoEConfig(**dataclasses.asdict(cfg))
    p = _moe_weights(cfg, 2)
    x = np.random.default_rng(3).standard_normal((2, 12, 64)).astype(
        np.float32)
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.bfloat16)
          for k, v in p.items()}
    tp = Tree({k: torch.tensor(np.asarray(v, np.float32), dtype=(
        torch.float32 if k == "router" else torch.bfloat16))
        for k, v in jp.items()})
    xb = jnp.asarray(x, jnp.bfloat16)
    jidx, _, _ = JMOE._router(jp, jcfg, xb.reshape(-1, 64))
    want, _ = JMOE.moe_apply(jp, jcfg, xb)
    routes = []
    got, _ = TMOE.moe_apply(tp, cfg, torch.tensor(
        np.asarray(xb, np.float32), dtype=torch.bfloat16), routes)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.sort(routes[0].numpy(), -1),
                                  np.sort(np.asarray(jidx), -1))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


# ---------------------------------------------------------------------------
# the reference's decode attends unwritten slots (ROADMAP C)
# ---------------------------------------------------------------------------

def test_decode_attends_unwritten_slots_as_the_reference_does():
    """decode_step attends the whole static cache: the zero rows past widx
    score 0, not -inf, and take softmax weight, so the same step over a
    longer cache gives other logits. The port reproduces this, equal to the
    reference for both lengths."""
    jcfg = JC.get_smoke_config("deepseek-v2-lite")
    tcfg = TC.get_smoke_config("deepseek-v2-lite")
    tree = numpy_weights(jcfg, 9)
    params = model_params_from_numpy(tree, tcfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    tok = np.array([[3], [7]], np.int32)
    out = {}
    for seq in (4, 12):
        st = JMm.init_decode_state(jcfg, 2, seq, dtype=jnp.float32)
        want, _ = JMm.decode_step(jparams, jcfg, st, jnp.asarray(tok),
                                  jnp.zeros((2, 1), jnp.int32), 0)
        got, _ = TMm.decode_step(
            params, tcfg, TMm.init_decode_state(tcfg, 2, seq,
                                                dtype=torch.float32,
                                                device="cpu"),
            torch.tensor(tok), torch.zeros((2, 1), dtype=torch.int32), 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        out[seq] = got.numpy()
    assert np.abs(out[4] - out[12]).max() > 1e-3


def test_selection_breaks_ties_toward_the_lower_index():
    scores = torch.tensor([[0.0, 2.0, 0.0, 1.0, 2.0, 0.0]])
    got = TMm.top_k_lowest_first(scores, 4)
    _, want = jax.lax.top_k(jnp.asarray(scores.numpy()), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[1, 4, 3, 0]])
