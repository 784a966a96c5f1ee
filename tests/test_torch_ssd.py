"""Port parity: Mamba2's SSD (repro_torch.kernels.ssd_chunk and
repro_torch.models.ssm) against the JAX package on the same numpy inputs —
the plain ssd_intra_chunk against ssd_intra_chunk_ref and the Pallas kernel
in interpret mode on TestSSDKernel's cases; the port's ssd_chunked against
the reference's both forms; mamba2_forward and mamba2_decode on weights
carried across; decode continuing the forward.

Tolerances (f32): the intra-chunk outputs at atol 1e-4 / rtol 1e-4 and cum
at 1e-5 (tests/test_ssd_kernel.py:26-31); ssd_chunked and the mixer at
atol 2e-4 / rtol 1e-3 (tests/test_ssd_kernel.py:58-61): the exponentiated
decays and the recurrence over chunks sum in another order in each
package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ssd_intra_chunk as jax_ssd_kernel
from repro.kernels.ssd_chunk import ssd_intra_chunk_ref as jax_ssd_ref
from repro.models import ssm as JS
from repro.models.module import KeyGen, split
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk import ssd_intra_chunk, ssd_intra_chunk_ref
from repro_torch.models import ssm as TS
from repro_torch.models.module import Tree

CHUNK_TOL = dict(atol=1e-4, rtol=1e-4)
SCAN_TOL = dict(atol=2e-4, rtol=1e-3)


def _inputs(b, nc, Q, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(b, nc, Q, H, P)
    dt = np.log1p(np.exp(f(b, nc, Q, H))).astype(np.float32)     # softplus
    A = (-np.exp(0.5 * f(H))).astype(np.float32)
    return x, dt, A, f(b, nc, Q, N), f(b, nc, Q, N)


@pytest.mark.parametrize("b,nc,Q,H,P,N,hb", [(1, 2, 16, 4, 8, 16, 4),
                                             (2, 2, 32, 8, 16, 32, 8),
                                             (1, 1, 64, 8, 32, 64, 4)])
def test_plain_intra_chunk_matches_ref_and_pallas(b, nc, Q, H, P, N, hb):
    ins = _inputs(b, nc, Q, H, P, N, seed=Q)
    before = ssd_ops.ssd_intra_chunk.launches
    got = ssd_intra_chunk(*map(torch.tensor, ins), hb=hb)
    assert ssd_ops.ssd_intra_chunk.launches == before
    jins = tuple(map(jnp.asarray, ins))
    for want in (jax_ssd_ref(*jins), jax_ssd_kernel(*jins, hb=hb)):
        for g, w, tol in zip(got, want, (CHUNK_TOL, CHUNK_TOL,
                                         dict(atol=1e-5, rtol=0))):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_plain_intra_chunk_is_finite_on_long_decays():
    """A steep decay makes the above-diagonal exponents overflow; they are
    masked to -inf before exp, so nothing non-finite reaches the outputs."""
    x, dt, A, B, C = _inputs(1, 1, 64, 2, 4, 8, seed=1)
    A = np.full_like(A, -40.0)
    y, st, cum = ssd_intra_chunk_ref(*map(torch.tensor, (x, dt, A, B, C)))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jax_ssd_ref(*map(jnp.asarray,
                                               (x, dt, A, B, C)))[0]),
        **CHUNK_TOL)


def test_wrapper_rejects_bad_shapes():
    x, dt, A, B, C = map(torch.tensor, _inputs(1, 1, 8, 2, 4, 8))
    with pytest.raises(ValueError, match="shapes disagree"):
        ssd_intra_chunk(x, dt[..., :1], A, B, C)
    with pytest.raises(ValueError, match="hb=0"):
        ssd_intra_chunk(x, dt, A, B, C, hb=0)
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_intra_chunk(*(t.to("meta") for t in (x, dt, A, B, C)))


CFG = TS.Mamba2Config(d_model=64, d_state=16, head_dim=8, expand=2, chunk=8)


def _scan_inputs(b, s, seed):
    h, p, n = CFG.n_heads, CFG.head_dim, CFG.d_state
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return (f(b, s, h, p), np.log1p(np.exp(f(b, s, h))).astype(np.float32),
            (-np.exp(0.5 * f(h))).astype(np.float32), f(b, s, n), f(b, s, n),
            0.1 * f(b, h, p, n))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_both_reference_forms(use_kernel, with_h0):
    x, dt, A, B, C, h0 = _scan_inputs(2, 32, 7 + with_h0)
    jcfg = JS.Mamba2Config(**CFG.__dict__)
    h0 = h0 if with_h0 else None
    want_y, want_h = JS.ssd_chunked(
        jcfg, *map(jnp.asarray, (x, dt, A, B, C)),
        None if h0 is None else jnp.asarray(h0), use_kernel=use_kernel)
    for intra in (ssd_intra_chunk, ssd_intra_chunk_ref):
        got_y, got_h = TS.ssd_chunked(
            CFG, *map(torch.tensor, (x, dt, A, B, C)),
            None if h0 is None else torch.tensor(h0), intra=intra)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   **SCAN_TOL)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                                   **SCAN_TOL)


def test_ssd_chunked_rejects_a_partial_chunk():
    x, dt, A, B, C, _ = _scan_inputs(1, 12, 0)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TS.ssd_chunked(CFG, *map(torch.tensor, (x, dt, A, B, C)))


@pytest.fixture(scope="module")
def mixer():
    """One Mamba2 mixer from the reference's init_mamba2 (f32), as numpy, in
    both packages, with nonzero conv bias and dt bias."""
    jcfg = JS.Mamba2Config(**CFG.__dict__)
    params, _ = split(JS.init_mamba2(KeyGen(jax.random.PRNGKey(1)), jcfg,
                                     dtype=jnp.float32))
    np_params = jax.tree.map(lambda a: np.array(a, np.float32), params)
    rng = np.random.default_rng(2)
    np_params["conv_b"] = (0.1 * rng.standard_normal(
        np_params["conv_b"].shape)).astype(np.float32)
    np_params["dt_bias"] = (0.2 * rng.standard_normal(
        np_params["dt_bias"].shape)).astype(np.float32)
    tparams = Tree(jax.tree.map(torch.tensor, np_params))
    return jcfg, jax.tree.map(jnp.asarray, np_params), tparams


def test_mamba2_forward_and_decode_match_reference(mixer):
    jcfg, jparams, tparams = mixer
    rng = np.random.default_rng(3)
    B, S = 2, 24
    x = rng.standard_normal((B, S + 2, CFG.d_model)).astype(np.float32)
    want_y, (want_h, want_c) = JS.mamba2_forward(jparams, jcfg,
                                                 jnp.asarray(x[:, :S]))
    got_y, (got_h, got_c) = TS.mamba2_forward(tparams, CFG,
                                              torch.tensor(x[:, :S]))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **SCAN_TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **SCAN_TOL)
    jstate, tstate = (want_h, want_c), (got_h, got_c)
    for t in (S, S + 1):
        want_d, jstate = JS.mamba2_decode(jparams, jcfg,
                                          jnp.asarray(x[:, t:t + 1]), jstate)
        got_d, tstate = TS.mamba2_decode(tparams, CFG,
                                         torch.tensor(x[:, t:t + 1]), tstate)
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                                   **SCAN_TOL)
        for g, w in zip(tstate, jstate):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **SCAN_TOL)


def test_decode_continues_the_forward(mixer):
    """Decoding token by token after a forward of the first 16 tokens gives
    the forward's outputs and final state over all 24."""
    _, _, tparams = mixer
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((1, 24, CFG.d_model)),
                     dtype=torch.float32)
    full_y, (full_h, full_c) = TS.mamba2_forward(tparams, CFG, x)
    _, state = TS.mamba2_forward(tparams, CFG, x[:, :16])
    for t in range(16, 24):
        y, state = TS.mamba2_decode(tparams, CFG, x[:, t:t + 1], state)
        np.testing.assert_allclose(y.numpy(), full_y[:, t:t + 1].numpy(),
                                   **SCAN_TOL)
    np.testing.assert_allclose(state[0].numpy(), full_h.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(state[1].numpy(), full_c.numpy(), **SCAN_TOL)


@pytest.mark.parametrize("Q,P,N", [(256, 64, 128), (128, 80, 128),
                                   (128, 64, 160)])
def test_kernel_check_refuses_shapes_past_its_tiles(Q, P, N):
    """The card's kernel holds a chunk of Q <= 128 steps, P <= 64 columns
    and N <= 128 state columns in its tiles: the wrapper refuses larger
    ones before it builds or launches anything."""
    ins = tuple(map(torch.tensor, _inputs(1, 1, Q, 2, P, N)))
    with pytest.raises(ValueError, match="takes Q <= 128"):
        ssd_ops._check_cuda(*ins, hb=1)
