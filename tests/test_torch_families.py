"""Port parity of the model families the port gained with GQA attention
(repro_torch.models.attention): the serving form (forward, prefill,
decode_step) of the eight smoke configs — Qwen1.5 (MHA, QKV bias), Qwen2.5
(GQA, bias), Qwen3 (GQA, qk-norm), Nemotron-4 (squared ReLU, LayerNorm),
Qwen3-MoE (GQA + MoE), LLaVA-NeXT (patch embeddings ahead of the text),
Zamba2 (groups of Mamba2 layers and a shared attention block, its prefill
through ssd_chunk's plain version on the CPU) and Whisper (encoder-decoder)
— against the JAX package's on the same numpy weights and batch, in f32
(torch_parity.serving_case), and the port's decode against its own forward.

Tolerances, f32 through the whole model: logits, caches and states at atol
1e-4 / rtol 1e-4 (tests/test_torch_model.py's), the hybrid at its SSM
bound, 2e-4 / 1e-3 (the SSD recurrence sums in another order,
tests/test_ssd_kernel.py:58-61)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import model as JMm
from repro_torch import configs as TC
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.mla_decode import ops as mla_ops
from repro_torch.kernels.sparse_select import ops as sel_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.models import model as TMm
from torch_parity import (FAMILY_ARCHS, context_len, family_batch,
                          numpy_weights, serving_case)

TOL = dict(atol=1e-4, rtol=1e-4)
SSM_TOL = dict(atol=2e-4, rtol=1e-3)
B, S, STEPS = 2, 16, 3


def _tol(cfg):
    return SSM_TOL if cfg.family == "hybrid" else TOL


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def run(request):
    counters = (fp_ops.flash_prefill, mla_ops.mla_decode,
                sel_ops.sparse_select, ssd_ops.ssd_intra_chunk)
    before = [c.launches for c in counters]
    out = serving_case(request.param, batch=B, seq=S, steps=STEPS)
    assert [c.launches for c in counters] == before   # CPU: plain versions
    return out


def test_forward_matches_reference(run):
    """Every text position's logits (the VLM's patch positions sliced off,
    as the reference slices them)."""
    jcfg, tcfg, ref, port = run
    assert port["forward"].shape == (B, S, jcfg.vocab)
    np.testing.assert_allclose(port["forward"], ref["forward"], **_tol(tcfg))


def test_prefill_matches_reference(run):
    jcfg, tcfg, ref, port = run
    assert port["prefill"].shape == (B, 1, jcfg.vocab)
    np.testing.assert_allclose(port["prefill"], ref["prefill"], **_tol(tcfg))


def test_prefill_caches_match_reference(run):
    _, tcfg, ref, port = run
    want = jax.tree.leaves(ref["caches"])
    got = jax.tree.leaves(port["caches"])
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **_tol(tcfg))


def test_decode_steps_match_reference(run):
    """Three decode steps from the prefilled state: each step's logits and
    the whole state after them (the unwritten slots attended, C.1)."""
    _, tcfg, ref, port = run
    assert len(port["decode"]) == STEPS
    for g, w in zip(port["decode"], ref["decode"]):
        np.testing.assert_allclose(g, w, **_tol(tcfg))
    want, got = jax.tree.leaves(ref["state"]), jax.tree.leaves(port["state"])
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **_tol(tcfg))


def test_cache_layout_is_the_references(run):
    """The caches' shapes, leaf by leaf, as the module docstring of
    repro_torch.models.model gives them."""
    _, cfg, _, port = run
    c, a = port["caches"], cfg.attn_cfg
    ctx = context_len(cfg, S)
    kv = lambda *lead, s=ctx: [lead + (B, s, a.n_kv_heads, a.hd)] * 2
    shapes = lambda t: [x.shape for x in jax.tree.leaves(t)]
    if cfg.family == "hybrid":
        s = cfg.ssm
        ng, rem = divmod(cfg.n_layers, cfg.hybrid_group)
        ssm = lambda *lead: [lead + (B, s.n_heads, s.head_dim, s.d_state),
                             lead + (B, s.d_conv - 1,
                                     s.d_inner + 2 * s.d_state)]
        assert (ng, rem) == (2, 1)
        assert shapes(c["groups"]) == ssm(ng, cfg.hybrid_group) + kv(ng)
        assert shapes(c["rem"]) == ssm(rem)
    elif cfg.family == "audio":
        assert shapes(c) == kv(cfg.n_layers) + kv(cfg.n_layers,
                                                  s=cfg.enc_seq)
    else:
        assert list(c) == ["blocks"]
        assert shapes(c) == kv(cfg.n_layers)
    n_moe = cfg.n_layers if cfg.family == "moe" else 0
    assert len(port["routes"]) == n_moe
    assert all(r.shape == (B * S, cfg.moe.top_k) for r in port["routes"])


def test_decode_state_layout_is_the_references(run):
    """init_decode_state's leaves have the reference's shapes and dtypes
    (the SSM states in f32, the rest in the requested dtype)."""
    jcfg, tcfg, _, _ = run
    want = JMm.init_decode_state(jcfg, B, 40, abstract=True,
                                 dtype=jnp.bfloat16)
    got = TMm.init_decode_state(tcfg, B, 40, dtype=torch.bfloat16,
                                device="meta")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert (tuple(g.shape), str(g.dtype).split(".")[-1]) == \
            (w.shape, str(w.dtype))


@pytest.mark.parametrize("arch", [a for a in FAMILY_ARCHS
                                  if not a.startswith("qwen3-moe")])
def test_decode_continues_forward(arch):
    """The port's decode step equals its own forward: prefill S tokens into
    a cache of exactly S + 1 context slots, decode token S into the last
    slot (every slot written, so C.1's unwritten slots do not enter), and
    its logits equal the last position's of the forward over all S + 1
    tokens. The hybrid's forward scans its S + 1 = 17 tokens in one SSD
    chunk of 17 (its prefill's 16 in its config's chunks of 8): the chunk
    length is the scan's block, not a weight, and the chunked scan is exact
    for any. The MoE config is left out: its capacity-dropping dispatch
    drops other (token, expert) pairs in a 2-token decode than in a
    34-token forward, in both packages."""
    cfg = TC.get_smoke_config(arch)
    params = model_params_from_numpy(numpy_weights(JC.get_smoke_config(arch),
                                                   3), cfg, device="cpu")
    data = {k: torch.tensor(v) for k, v in
            family_batch(cfg, B, S + 1, seed=4).items()}
    whole = cfg
    if cfg.family == "hybrid":
        whole = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk=S + 1))
    want, _, _ = TMm.forward(params, whole, data)
    _, caches = TMm.prefill(params, cfg,
                            dict(data, tokens=data["tokens"][:, :S]))
    ctx = context_len(cfg, S)
    state = TMm.fill_decode_state(
        cfg, TMm.init_decode_state(cfg, B, ctx + 1, dtype=torch.float32,
                                   device="cpu"), caches)
    got, _ = TMm.decode_step(params, cfg, state, data["tokens"][:, S:],
                             torch.full((B, 1), ctx), ctx)
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, S].numpy(),
                               **_tol(cfg))
