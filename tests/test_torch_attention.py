"""Port parity of GQA attention alone (repro_torch.models.attention against
repro.models.attention): attention and decode_step over MHA, GQA and MQA
head groupings, QKV bias, qk-norm, a RoPE base, non-causal and RoPE-free
(Whisper's encoder) configs, and cross-attention (K/V from another source
width, causal with Sq < Sk, tail-aligned, and not), on the same numpy
weights (every leaf random, biases included), in f32 at atol 2e-6 / rtol
1e-5: one layer, products and softmax in f32 in both packages, summed in
another order (the reference's own f32 kernel bound is 2e-6,
tests/test_kernels.py:40)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models.module import KeyGen, split
from repro_torch.models import attention as TA
from repro_torch.models.module import Tree

TOL = dict(atol=2e-6, rtol=1e-5)
D = 32

CASES = {
    "mha": dict(n_heads=4, n_kv_heads=4),
    "gqa": dict(n_heads=4, n_kv_heads=2),
    "mqa": dict(n_heads=4, n_kv_heads=1),
    "qkv_bias": dict(n_heads=4, n_kv_heads=2, qkv_bias=True),
    "qk_norm": dict(n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True,
                    rope_theta=1e6),
    "non_causal": dict(n_heads=4, n_kv_heads=4, causal=False),
    "no_rope": dict(n_heads=4, n_kv_heads=4, causal=False, use_rope=False),
}


def _weights(kw, seed, d_kv_src=None):
    """The reference's init_attn tree, every leaf drawn at random (numpy),
    and the port's Tree of the same arrays."""
    jcfg = JA.AttnConfig(D, **kw)
    abstract = jax.eval_shape(lambda k: split(JA.init_attn(
        KeyGen(k), jcfg, jnp.float32, d_kv_src))[0], jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(a.shape[0])
                   ).astype(np.float32), abstract)
    return (jcfg, jax.tree.map(jnp.asarray, tree),
            TA.AttnConfig(D, **kw), Tree(jax.tree.map(torch.tensor, tree)))


def _inputs(seed, B, S, d=D):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32) + 3, (B, S)).copy()
    return x, pos


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_matches_reference(case):
    jcfg, jp, tcfg, tp = _weights(CASES[case], seed=1)
    x, pos = _inputs(2, 2, 12)
    want, (wk, wv) = JA.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, (gk, gv) = TA.attention(tp, tcfg, torch.tensor(x), torch.tensor(pos))
    assert got.shape == (2, 12, D) and gk.shape == wk.shape
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w)


@pytest.mark.parametrize("causal", [True, False])
def test_cross_attention_matches_reference(causal):
    """K/V read another source (width 24, 20 positions) than the 12
    queries: d_kv_src, x_kv and kv_positions; causal means the
    tail-aligned band, query i seeing keys up to i + 8."""
    kw = dict(n_heads=4, n_kv_heads=2, causal=causal)
    jcfg, jp, tcfg, tp = _weights(kw, seed=3, d_kv_src=24)
    x, pos = _inputs(4, 2, 12)
    xkv, kpos = _inputs(5, 2, 20, d=24)
    want, (wk, _) = JA.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                 x_kv=jnp.asarray(xkv),
                                 kv_positions=jnp.asarray(kpos))
    got, (gk, _) = TA.attention(tp, tcfg, torch.tensor(x), torch.tensor(pos),
                                x_kv=torch.tensor(xkv),
                                kv_positions=torch.tensor(kpos))
    assert gk.shape == (2, 20, 2, D // 4)
    _close(got, want)
    _close(gk, wk)


@pytest.mark.parametrize("with_len", [False, True])
@pytest.mark.parametrize("case", ["mha", "gqa", "qkv_bias", "qk_norm"])
def test_decode_step_matches_reference(case, with_len):
    """One token against a (B, S, Hkv, hd) cache, all of it or a valid
    prefix per row (cache_len)."""
    jcfg, jp, tcfg, tp = _weights(CASES[case], seed=7)
    hd = tcfg.hd
    rng = np.random.default_rng(8)
    k = rng.standard_normal((2, 10, tcfg.n_kv_heads, hd)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    x = rng.standard_normal((2, 1, D)).astype(np.float32)
    pos = np.array([[10], [6]], np.int32)
    lens = np.array([10, 6], np.int32) if with_len else None
    want, (wk, wv) = JA.decode_step(
        jp, jcfg, jnp.asarray(x), (jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(pos), None if lens is None else jnp.asarray(lens))
    got, (gk, gv) = TA.decode_step(
        tp, tcfg, torch.tensor(x), (torch.tensor(k), torch.tensor(v)),
        torch.tensor(pos), None if lens is None else torch.tensor(lens))
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w)


def test_products_are_f32_from_bf16_operands():
    """_sdpa on bf16 q/k/v computes its logits and output in f32 (the
    reference's preferred_element_type) and rounds o to bf16 once: equal,
    bit for bit, to the f32 computation on the upcast operands, rounded."""
    cfg = TA.AttnConfig(D, 4, 2)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).to(torch.bfloat16)
               for s in ((2, 5, 4, 8), (2, 7, 2, 8), (2, 7, 2, 8)))
    mask = torch.ones((5, 7), dtype=torch.bool).tril(2)[None]
    got = TA._sdpa(cfg, q, k, v, mask)
    want = TA._sdpa(cfg, q.float(), k.float(), v.float(), mask)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_config_and_init_equal_the_references():
    """AttnConfig's fields, hd, scale and kv bytes; init_attn's leaves,
    shapes and dtypes (biases zero, norm scales one)."""
    strip = lambda cls: [(f.name, f.default) for f in
                         dataclasses.fields(cls)]
    assert strip(TA.AttnConfig) == strip(JA.AttnConfig)
    for kw in CASES.values():
        t, j = TA.AttnConfig(40, **kw), JA.AttnConfig(40, **kw)
        assert (t.hd, t.scale, t.kv_bytes_token_layer) == \
            (j.hd, j.scale, j.kv_bytes_token_layer)
        want, _ = split(JA.init_attn(KeyGen(jax.random.PRNGKey(0)), j,
                                     d_kv_src=24))
        got = TA.init_attn(torch.Generator().manual_seed(0), t,
                           dtype=torch.bfloat16, device="cpu", d_kv_src=24)
        assert jax.tree.structure(jax.tree.map(lambda a: 0, got)) == \
            jax.tree.structure(jax.tree.map(lambda a: 0, want))
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        for name in ("q_b", "k_b", "v_b"):
            if name in got:
                assert not got[name].any()
        if "q_norm" in got:
            assert got["q_norm"]["scale"].eq(1).all()
