"""Port parity: block-sparse selected attention (repro_torch.kernels.
sparse_select on CPU tensors, i.e. its plain version) and the selection
call sites of repro_torch.models.mla / core.routing, against the JAX package
on the same numpy inputs — sparse_select_ref, the Pallas sparse_select_decode
in interpret mode, and the masked absorbed_partial / route_simulated.

The port's kernel goes beyond the Pallas one in three cases, each held here
against the reference's masked absorbed_partial (repro/models/mla.py:134),
which attends exactly the selected & valid rows: a selected partial tail
block (rows past the chunk's length are skipped), a ragged kb per batch row
with kb = 0 giving the merge identity, and block_tokens = 1 (token-level
selection: any token mask is sparse_select over its indices).

Tolerances: f32 atol 2e-6 / rtol 1e-5 (tests/test_kernels.py:40); l is an
unnormalised sum and is held relative only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.routing import route_simulated as jax_route_simulated
from repro.kernels.sparse_select import (sparse_select_decode,
                                         sparse_select_ref as jax_ref)
from repro.models import mla as JM
from repro_torch.core.routing import route_simulated
from repro_torch.kernels.sparse_select import ops as sel_ops
from repro_torch.kernels.sparse_select import sparse_select_ref
from repro_torch.models import mla as TM
from repro_torch.serving.selection.types import token_mask

SCALE = 1.0 / np.sqrt(192.0)
ATOL, RTOL = 2e-6, 1e-5
D, D_V = 64, 48
# an MLA geometry with d_qk = 64, d_v = 48 and scale 1/sqrt(192), in both
# packages, for the call sites that take a config
CFG = dict(d_model=64, n_heads=4, kv_lora_rank=D_V, qk_nope_head_dim=176,
           qk_rope_head_dim=D - D_V, v_head_dim=8)
T_CFG, J_CFG = TM.MLAConfig(**CFG), JM.MLAConfig(**CFG)


def _qc(seed, B, R, S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, R, D)).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32))


def _plain(q, ckv, idx, kb=None, lengths=None, block_tokens=64):
    """The port's wrapper on CPU tensors: its plain version, no launch."""
    before = sel_ops.sparse_select.launches
    t = lambda x: None if x is None else torch.tensor(np.asarray(x))
    out = sel_ops.sparse_select(t(q), t(ckv), t(idx).to(torch.int32),
                                None if kb is None
                                else t(kb).to(torch.int32),
                                None if lengths is None
                                else t(lengths).to(torch.int32),
                                d_v=D_V, scale=SCALE,
                                block_tokens=block_tokens)
    assert sel_ops.sparse_select.launches == before
    return out


def _close(got, o, m, l, atol=ATOL):
    np.testing.assert_allclose(got.o.numpy(), np.asarray(o), atol=atol,
                               rtol=RTOL)
    np.testing.assert_allclose(got.m.numpy(), np.asarray(m), atol=atol,
                               rtol=RTOL)
    np.testing.assert_allclose(got.l.numpy(), np.asarray(l), rtol=RTOL)


def _masked_ref(q, ckv_b, mask):
    """The reference's masked absorbed_partial for one batch row."""
    return JM.absorbed_partial(J_CFG, jnp.asarray(q), jnp.asarray(ckv_b),
                               jnp.asarray(mask))


@pytest.mark.parametrize("B,H,S,KB", [(1, 4, 512, 4), (2, 16, 1024, 8),
                                      (2, 128, 2048, 32)])
def test_matches_reference_ref_and_pallas(B, H, S, KB):
    """The TestSparseSelect shapes: the plain version against the JAX
    plain version and the Pallas kernel in interpret mode."""
    q, ckv = _qc(B * 31 + KB, B, H, S)
    rng = np.random.RandomState(B + KB)
    idx = np.stack([np.sort(rng.choice(S // 64, KB, replace=False))
                    for _ in range(B)]).astype(np.int32)
    got = _plain(q, ckv, idx)
    _close(got, *jax_ref(jnp.asarray(q), jnp.asarray(ckv), jnp.asarray(idx),
                         D_V, 64, SCALE))
    pal = sparse_select_decode(jnp.asarray(q), jnp.asarray(ckv),
                               jnp.asarray(idx), d_v=D_V, scale=SCALE)
    _close(got, pal.o, pal.m, pal.l)


def test_selection_budget_invariance():
    """The result depends only on the selected rows, not on the store."""
    q, ckv = _qc(17, 1, 4, 512)
    pad = np.random.default_rng(99).standard_normal((1, 1536, D))
    big = np.concatenate([ckv, pad.astype(np.float32)], axis=1)
    idx = np.array([[0, 2, 5, 7]], np.int32)
    a, b = _plain(q, ckv, idx), _plain(q, big, idx)
    np.testing.assert_allclose(a.o.numpy(), b.o.numpy(), atol=1e-6)


def test_partial_tail_block_is_exact():
    """S = 100 with the tail block (rows 64..99) selected: only its 36 real
    rows count. The Pallas kernel needs S % 64 == 0 and returns non-finite
    output here; the port matches the masked reference."""
    q, ckv = _qc(5, 1, 8, 100)
    idx = np.array([[0, 1]], np.int32)
    got = _plain(q, ckv, idx)
    assert np.isfinite(got.o.numpy()).all()
    want = _masked_ref(q[0], ckv[0], token_mask((0, 1), 64, 100))
    _close(got, want.o[None], want.m[None], want.l[None])
    # the same rows with lengths[b] cutting a full-size cache
    full = np.concatenate([ckv, np.ones((1, 28, D), np.float32)], axis=1)
    _close(_plain(q, full, idx, lengths=[100]), want.o[None], want.m[None],
           want.l[None])


def test_ragged_kb_and_the_identity_row():
    """B = 3 with kb = [3, 1, 0] over padded block tables: each row attends
    its first kb ids, and the kb = 0 row is the merge identity."""
    q, ckv = _qc(9, 3, 8, 320)
    idx = np.array([[4, 0, 2], [3, 9, 9], [1, 1, 1]], np.int32)
    kb = np.array([3, 1, 0], np.int32)
    got = _plain(q, ckv, idx, kb=kb)
    for b, blocks in enumerate(([4, 0, 2], [3])):
        want = _masked_ref(q[b], ckv[b], token_mask(blocks, 64, 320))
        _close(type(got)(*(x[b] for x in got)), want.o, want.m, want.l)
    assert (got.o[2] == 0).all() and (got.l[2] == 0).all()
    assert torch.isneginf(got.m[2]).all()


def test_block_tokens_one_is_token_selection():
    """block_tokens = 1: the block ids are token rows, in any order."""
    q, ckv = _qc(3, 1, 4, 48)
    rows = np.array([[40, 3, 17, 5, 29]], np.int32)
    mask = np.zeros(48, bool)
    mask[rows[0]] = True
    want = _masked_ref(q[0], ckv[0], mask)
    _close(_plain(q, ckv, rows, block_tokens=1), want.o[None], want.m[None],
           want.l[None])


@pytest.mark.parametrize("per_row", [False, True])
def test_masked_absorbed_partial_matches_reference(per_row):
    """A masked absorbed_partial — (S,) or one mask per query row — runs as
    sparse_select at block_tokens = 1 over the mask's indices."""
    rng = np.random.default_rng(int(per_row))
    S = 70
    q = rng.standard_normal((2, T_CFG.n_heads, D)).astype(np.float32)
    ckv = rng.standard_normal((S, D)).astype(np.float32)
    shape = (2, T_CFG.n_heads, S) if per_row else (S,)
    mask = rng.random(shape) < 0.3
    if per_row:
        mask[1, 2] = False                     # one row with nothing selected
    got = TM.absorbed_partial(T_CFG, torch.tensor(q), torch.tensor(ckv),
                              torch.tensor(mask))
    want = _masked_ref(q, ckv, mask)
    np.testing.assert_allclose(got.o.numpy(), np.asarray(want.o), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(np.isneginf(got.m.numpy()),
                                  np.isneginf(np.asarray(want.m)))
    np.testing.assert_allclose(got.l.numpy(), np.asarray(want.l), rtol=RTOL)


def test_route_with_block_ids_matches_masked_reference():
    """route_simulated over three holders, each attending its selected
    blocks (one holder with none, one with its partial tail block),
    against the reference routing the same selection as token masks."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, T_CFG.n_heads, D)).astype(np.float32)
    lens = (128, 96, 64)
    shards = [rng.standard_normal((n, D)).astype(np.float32) for n in lens]
    blocks = [(1,), (0, 1), ()]
    got = route_simulated(T_CFG, torch.tensor(q),
                          [torch.tensor(s) for s in shards], blocks=blocks,
                          block_tokens=64)
    want = jax_route_simulated(
        J_CFG, jnp.asarray(q), [jnp.asarray(s) for s in shards],
        masks=[jnp.asarray(token_mask(b, 64, n))
               for b, n in zip(blocks, lens)])
    _close(got, want.o, want.m, want.l)


def test_wrapper_checks_its_inputs():
    q, ckv = torch.zeros(1, 4, D), torch.zeros(1, 64, D)
    with pytest.raises(ValueError, match="disagree"):
        sel_ops.sparse_select(q, torch.zeros(2, 64, D),
                              torch.zeros(1, 1, dtype=torch.int32), d_v=D_V)
    with pytest.raises(TypeError, match="integers"):
        sel_ops.sparse_select(q, ckv, torch.zeros(1, 1), d_v=D_V)
    with pytest.raises(ValueError, match="block_tokens"):
        sel_ops.sparse_select(q, ckv, torch.zeros(1, 1, dtype=torch.int32),
                              d_v=D_V, block_tokens=0)
    with pytest.raises(ValueError, match="unsupported device"):
        sel_ops.sparse_select(q.to("meta"), ckv.to("meta"),
                              torch.zeros(1, 1, dtype=torch.int32,
                                          device="meta"), d_v=D_V)


def test_plain_version_is_the_gathered_attention():
    """sparse_select_ref over the selected rows equals attention over the
    gathered rows (the scattered-gather FETCH computes the latter)."""
    q, ckv = _qc(23, 1, 8, 256)
    got = sparse_select_ref(torch.tensor(q), torch.tensor(ckv),
                            torch.tensor([[1, 3]], dtype=torch.int32), None,
                            None, D_V, 64, SCALE)
    sel = np.concatenate([ckv[0, 64:128], ckv[0, 192:256]])[None]
    want = TM.mla_decode(torch.tensor(q), torch.tensor(sel), d_v=D_V,
                         scale=SCALE)
    _close(got, want.o, want.m, want.l)
