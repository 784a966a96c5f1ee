"""Port parity: the online-softmax merge (repro_torch.core.merge) and the
plain softmax_merge against the JAX package (core.merge and the Pallas
softmax_merge kernel in interpret mode), on the same numpy inputs.

Tolerance: f32 at atol 2e-6 / rtol 1e-5, as the reference kernel tests hold
f32 (tests/test_kernels.py:40); l is an unnormalised sum and is held
relative only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import merge as jm
from repro.kernels.softmax_merge import softmax_merge as softmax_merge_pallas
from repro_torch.core import merge as tm
from repro_torch.kernels.softmax_merge import ops as merge_ops

ATOL, RTOL = 2e-6, 1e-5


def _partial_np(rng, shape=(2, 4), S=16, d_v=8, scale=1.0, masked=None):
    logits = (scale * rng.standard_normal(shape + (S,))).astype(np.float32)
    values = rng.standard_normal(shape + (S, d_v)).astype(np.float32)
    mask = None
    if masked is not None:
        mask = np.ones(shape + (S,), bool)
        mask[masked] = False
    return logits, values, mask


def _both(logits, values, mask=None):
    jp = jm.partial_from_logits(jnp.asarray(logits), jnp.asarray(values),
                                None if mask is None else jnp.asarray(mask))
    tp = tm.partial_from_logits(torch.tensor(logits), torch.tensor(values),
                                None if mask is None else torch.tensor(mask))
    return jp, tp


def _assert_close(tp, jp, atol=ATOL):
    np.testing.assert_allclose(tp.o.numpy(), np.asarray(jp.o), atol=atol,
                               rtol=RTOL)
    np.testing.assert_allclose(tp.m.numpy(), np.asarray(jp.m), atol=atol,
                               rtol=RTOL)
    np.testing.assert_allclose(tp.l.numpy(), np.asarray(jp.l), rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_partial_from_logits_matches(seed):
    jp, tp = _both(*_partial_np(np.random.default_rng(seed), scale=3.0))
    _assert_close(tp, jp)


def test_partial_from_logits_all_masked_row_is_identity():
    rng = np.random.default_rng(2)
    # row (0, 1) fully masked, row (1, 2) half masked
    logits, values, mask = _partial_np(rng, masked=(0, 1))
    mask[1, 2, :8] = False
    jp, tp = _both(logits, values, mask)
    _assert_close(tp, jp)
    assert tp.l[0, 1] == 0 and torch.isneginf(tp.m[0, 1])
    assert torch.all(tp.o[0, 1] == 0)


def test_partial_from_logits_empty_resident_set_is_identity():
    tp = tm.partial_from_logits(torch.zeros((3, 0)), torch.zeros((0, 4)))
    ident = tm.Partial.identity((3,), 4)
    for a, b in zip(tp, ident):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [3, 4])
def test_merge2_matches(seed):
    rng = np.random.default_rng(seed)
    (ja, ta), (jb, tb) = (_both(*_partial_np(rng, scale=2.0))
                          for _ in range(2))
    _assert_close(tm.merge2(ta, tb), jm.merge2(ja, jb))


def test_merge2_identity_is_noop_and_identity_stays_identity():
    jp, tp = _both(*_partial_np(np.random.default_rng(5)))
    ident = tm.Partial.identity(tuple(tp.m.shape), tp.o.shape[-1])
    for out in (tm.merge2(tp, ident), tm.merge2(ident, tp)):
        # (l o) / l rounds once: equal to a ulp, as in the reference
        np.testing.assert_allclose(out.o.numpy(), tp.o.numpy(), rtol=1e-6,
                                   atol=0)
        assert torch.equal(out.m, tp.m) and torch.equal(out.l, tp.l)
    both = tm.merge2(ident, ident)
    assert not torch.isnan(both.o).any()
    assert torch.all(both.l == 0) and torch.all(torch.isneginf(both.m))


@pytest.mark.parametrize("M", [1, 2, 3, 5, 8])
def test_merge_tree_and_stacked_match(M):
    rng = np.random.default_rng(10 + M)
    pairs = [_both(*_partial_np(rng, scale=2.0)) for _ in range(M)]
    jps, tps = [p[0] for p in pairs], [p[1] for p in pairs]
    _assert_close(tm.merge_tree(tps), jm.merge_tree(jps))
    jst = jm.merge_stacked(*(jnp.stack([getattr(p, k) for p in jps])
                             for k in "oml"))
    tst = tm.merge_stacked(*(torch.stack([getattr(p, k) for p in tps])
                             for k in "oml"))
    _assert_close(tst, jst)
    # the one-pass merge equals the tree to round-off
    _assert_close(tst, jm.merge_tree(jps))


def test_merge_equals_full_softmax_over_any_partition():
    rng = np.random.default_rng(20)
    logits, values, _ = _partial_np(rng, shape=(3,), S=64, scale=2.0)
    full = tm.partial_from_logits(torch.tensor(logits), torch.tensor(values))
    cuts = [0, 7, 13, 40, 64]
    parts = [tm.partial_from_logits(torch.tensor(logits[..., a:b]),
                                    torch.tensor(values[..., a:b, :]))
             for a, b in zip(cuts[:-1], cuts[1:])]
    got = tm.merge_tree(parts)
    np.testing.assert_allclose(got.o.numpy(), full.o.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.l.numpy(), full.l.numpy(), rtol=1e-5)


def _stack_np(rng, M, B=3, H=4, d_v=16, identity_slots=True):
    o = rng.standard_normal((M, B, H, d_v)).astype(np.float32)
    m = (3.0 * rng.standard_normal((M, B, H))).astype(np.float32)
    l = (1.0 + 50.0 * rng.random((M, B, H))).astype(np.float32)
    if identity_slots:
        m[0, 0], l[0, 0], o[0, 0] = -np.inf, 0.0, 0.0     # one empty slot
        m[:, 1, 0], l[:, 1, 0], o[:, 1, 0] = -np.inf, 0.0, 0.0  # all empty
    return o, m, l


@pytest.mark.parametrize("M", [2, 4, 8])
def test_plain_softmax_merge_matches_pallas(M):
    """The port's softmax_merge on CPU tensors (its plain version) against
    the reference Pallas kernel in interpret mode, identity slots
    included; the CPU call launches nothing."""
    o, m, l = _stack_np(np.random.default_rng(30 + M), M)
    before = merge_ops.softmax_merge.launches
    got = merge_ops.softmax_merge(torch.tensor(o), torch.tensor(m),
                                  torch.tensor(l))
    assert merge_ops.softmax_merge.launches == before
    want = softmax_merge_pallas(jnp.asarray(o), jnp.asarray(m),
                                jnp.asarray(l))
    _assert_close(got, want)
    assert torch.isneginf(got.m[1, 0]) and got.l[1, 0] == 0
    assert torch.all(got.o[1, 0] == 0)


def test_softmax_merge_rejects_bad_shapes():
    o = torch.zeros((2, 3, 4, 8))
    with pytest.raises(ValueError):
        merge_ops.softmax_merge(o, torch.zeros((2, 3, 5)),
                                torch.zeros((2, 3, 5)))


@pytest.mark.parametrize("M", [1, 2, 4, 16])
def test_softmax_merge_parts_equals_the_stacked_plain_version(M):
    """softmax_merge_parts (the serving path's in-place entry) on CPU
    tensors: the plain version on the stack, bit for bit, identity slots
    included; the CPU call launches nothing."""
    o, m, l = _stack_np(np.random.default_rng(60 + M), M)
    parts = [tm.Partial(torch.tensor(o[i]), torch.tensor(m[i]),
                        torch.tensor(l[i])) for i in range(M)]
    before = merge_ops.softmax_merge.launches
    got = merge_ops.softmax_merge_parts(parts)
    assert merge_ops.softmax_merge.launches == before
    want = merge_ops.softmax_merge_ref(torch.tensor(o), torch.tensor(m),
                                       torch.tensor(l))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.isneginf(got.m[1, 0]) and got.l[1, 0] == 0


def test_softmax_merge_parts_refuses_rather_than_copies():
    """More than MAX_PARTS partials, or a part that is not contiguous,
    raise: the in-place table never stacks behind the caller's back."""
    o, m, l = _stack_np(np.random.default_rng(77), 17)
    parts = [tm.Partial(torch.tensor(o[i]), torch.tensor(m[i]),
                        torch.tensor(l[i])) for i in range(17)]
    assert merge_ops.MAX_PARTS == 16
    with pytest.raises(ValueError, match="1 to 16 partials"):
        merge_ops.softmax_merge_parts(parts)
    with pytest.raises(ValueError, match="1 to 16 partials"):
        merge_ops.softmax_merge_parts([])
    strided = parts[1]._replace(o=torch.tensor(o[1]).transpose(0, 1)
                                .contiguous().transpose(0, 1))
    assert not strided.o.is_contiguous()
    with pytest.raises(ValueError, match="not contiguous"):
        merge_ops.softmax_merge_parts([parts[0], strided])
    with pytest.raises(ValueError, match="want o"):
        merge_ops.softmax_merge_parts([parts[0], parts[1]._replace(
            m=parts[1].m[:1])])
