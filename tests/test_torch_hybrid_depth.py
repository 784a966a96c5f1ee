"""A hybrid shallower than one group: the Zamba2 smoke config (groups of 3
Mamba2 layers, each followed by the shared attention block) cut to 2
layers, so it runs no group, only the 2 remaining Mamba2 layers. The
reference scans its zero groups and returns empty group caches; jax.grad
gives the shared block, which the loss does not reach, zero gradients. The
port against it on the reference's weights (convert.py):

* the serving form (tests/torch_parity.serving_case): prefill logits and
  caches (the empty group stacks among them, shapes leaf for leaf), three
  decode steps and the state after them, at the family tests' hybrid
  tolerance (tests/test_torch_families.py: atol 2e-4 / rtol 1e-3);
* train_step.loss_and_grads against jax.grad of the reference's loss_fn:
  loss at rtol 1e-5, every leaf within 1e-4 x its max, the shared block's
  gradient zero in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data.pipeline import DataConfig, SyntheticPipeline
from repro.models import model as JMm
from repro_torch import configs as TC
from repro_torch.convert import model_params_from_numpy
from repro_torch.models.module import trainable
from repro_torch.train.step import TrainConfig, loss_and_grads
from torch_parity import numpy_weights, serving_case

ARCH, LAYERS = "zamba2-7b", 2
SSM_TOL = dict(atol=2e-4, rtol=1e-3)
B, S, STEPS = 2, 16, 3


def _cut(cfg):
    return dataclasses.replace(cfg, n_layers=LAYERS)


@pytest.fixture(scope="module")
def serving():
    return serving_case(ARCH, batch=B, seq=S, steps=STEPS, n_layers=LAYERS)


def test_the_cut_runs_no_group(serving):
    _, tcfg, _, port = serving
    assert tcfg.n_layers < tcfg.hybrid_group
    s, a = tcfg.ssm, tcfg.attn_cfg
    shapes = [tuple(x.shape) for x in jax.tree.leaves(port["caches"]
                                                      ["groups"])]
    assert shapes == [(0, 3, B, s.n_heads, s.head_dim, s.d_state),
                      (0, 3, B, s.d_conv - 1, s.d_inner + 2 * s.d_state),
                      (0, B, S, a.n_kv_heads, a.hd),
                      (0, B, S, a.n_kv_heads, a.hd)]


def test_prefill_matches_reference(serving):
    _, _, ref, port = serving
    np.testing.assert_allclose(port["forward"], ref["forward"], **SSM_TOL)
    np.testing.assert_allclose(port["prefill"], ref["prefill"], **SSM_TOL)


def test_prefill_caches_match_reference(serving):
    _, _, ref, port = serving
    want = jax.tree.leaves(ref["caches"])
    got = jax.tree.leaves(port["caches"])
    assert [g.shape for g in got] == [w.shape for w in want]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **SSM_TOL)


def test_decode_steps_and_state_match_reference(serving):
    _, _, ref, port = serving
    for g, w in zip(port["decode"], ref["decode"]):
        np.testing.assert_allclose(g, w, **SSM_TOL)
    want, got = jax.tree.leaves(ref["state"]), jax.tree.leaves(port["state"])
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **SSM_TOL)


@pytest.fixture(scope="module")
def grads():
    jcfg = _cut(JC.get_smoke_config(ARCH))
    tcfg = _cut(TC.get_smoke_config(ARCH))
    tree = numpy_weights(jcfg, seed=11)
    b = SyntheticPipeline(DataConfig(
        vocab=jcfg.vocab, seq_len=S, global_batch=B, family=jcfg.family,
        d_model=jcfg.d_model)).batch_at(0)
    data = {k: np.asarray(v, np.int32) for k, v in b.items()}
    loss, g = jax.value_and_grad(JMm.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in data.items()})
    want = model_params_from_numpy(jax.tree.map(np.asarray, g), tcfg,
                                   device="cpu")
    params = trainable(model_params_from_numpy(tree, tcfg, device="cpu"))
    lt, got = loss_and_grads(params, tcfg, {k: torch.tensor(v)
                                            for k, v in data.items()},
                             TrainConfig())
    names = [k for k, _ in params.named_parameters()]
    return (float(loss), float(lt), dict(zip(names, got)),
            dict(want.named_parameters()))


def test_loss_matches_reference(grads):
    want, got, _, _ = grads
    assert abs(got - want) <= 1e-5 * abs(want)


def test_every_gradient_leaf_matches_reference(grads):
    _, _, got, want = grads
    assert list(got) == list(want)
    for k, g in got.items():
        w = want[k].detach()
        assert g.shape == w.shape, k
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= 1e-4 * scale or (scale == 0 and err == 0), (k, err,
                                                                  scale)


def test_the_shared_block_gradient_is_zero_in_both(grads):
    _, _, got, want = grads
    shared = [k for k in got if k.startswith("shared_attn.")]
    assert shared
    for k in shared:
        assert not got[k].any() and not want[k].any(), k
    assert any(got[k].any() for k in got if k.startswith("rem."))
