"""Port parity: the FETCH splice (repro_torch.core.splice) and the plain
delta_rotate against the JAX package — the Pallas delta_rotate_band in
interpret mode and core.splice.splice_delta_rotate — at nonzero deltas, on
the same numpy inputs. Also the rope helpers the rotation is built from,
and the single-process routing that merges shards.

Tolerance: f32 atol 2e-6 / rtol 1e-5 (tests/test_kernels.py:40)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.routing import route_simulated as jax_route_simulated
from repro.core.splice import splice_delta_rotate as jax_splice
from repro.kernels.delta_rotate import delta_rotate_band as pallas_rotate
from repro.models import layers as JL
from repro.models import mla as JM
from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA
from repro_torch.core.routing import route_batched, route_simulated
from repro_torch.core.splice import splice_delta_rotate
from repro_torch.kernels.delta_rotate import ops as rot_ops
from repro_torch.models import layers as TL
from repro_torch.serving.backends.torch_exec import TINY_MLA

ATOL, RTOL = 2e-6, 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=RTOL)


def test_rope_helpers_match():
    pos = np.arange(0, 4096, 7, dtype=np.int32)
    np.testing.assert_array_equal(TL.rope_freqs(64), JL.rope_freqs(64))
    for got, want in zip(TL.rope_cos_sin(torch.tensor(pos), 64),
                         JL.rope_cos_sin(jnp.asarray(pos), 64)):
        _close(got, want)
    x = np.random.default_rng(0).standard_normal((5, 64)).astype(np.float32)
    _close(TL.delta_rotate(torch.tensor(x), 17, 64),
           JL.delta_rotate(jnp.asarray(x), 17, 64))


@pytest.mark.parametrize("delta", [1, 17, 4095])
@pytest.mark.parametrize("S,d_r", [(128, 8), (512, 64)])
def test_plain_delta_rotate_matches_pallas(delta, S, d_r):
    band = np.random.default_rng(S + delta).standard_normal(
        (S, d_r)).astype(np.float32)
    before = rot_ops.delta_rotate.launches
    got = rot_ops.delta_rotate_band(torch.tensor(band), delta, head_dim=d_r)
    assert rot_ops.delta_rotate.launches == before
    want = pallas_rotate(jnp.asarray(band), jnp.asarray(delta), head_dim=d_r,
                         block_s=128)
    _close(got, want)


@pytest.mark.parametrize("cfg", [TINY_MLA, V2_LITE_MLA])
@pytest.mark.parametrize("delta", [0, 5, 300])
def test_splice_matches_reference(cfg, delta):
    """The port's splice (latent copied, band rotated through the wrapper's
    strided in/out) against the reference splice and against the Pallas
    rotation of the band; the latent columns are bit-identical."""
    ckv = np.random.default_rng(delta).standard_normal(
        (96, cfg.d_qk)).astype(np.float32)
    got = splice_delta_rotate(torch.tensor(ckv), delta, cfg)
    jcfg = JM.MLAConfig(**cfg.__dict__)
    _close(got, jax_splice(jnp.asarray(ckv), delta, jcfg))
    d_c = cfg.kv_lora_rank
    np.testing.assert_array_equal(got[:, :d_c].numpy(), ckv[:, :d_c])
    band = pallas_rotate(jnp.asarray(ckv[:, d_c:]), jnp.asarray(delta),
                         head_dim=cfg.qk_rope_head_dim, block_s=32)
    _close(got[:, d_c:], band)
    if delta == 0:
        np.testing.assert_array_equal(got.numpy(), ckv)


def test_splice_composes_and_leaves_source_alone():
    cfg = TINY_MLA
    ckv = np.random.default_rng(1).standard_normal(
        (32, cfg.d_qk)).astype(np.float32)
    src = torch.tensor(ckv)
    two = splice_delta_rotate(splice_delta_rotate(src, 3, cfg), 4, cfg)
    _close(two, splice_delta_rotate(src, 7, cfg).numpy())
    np.testing.assert_array_equal(src.numpy(), ckv)


def test_delta_rotate_rejects_bad_angles():
    with pytest.raises(ValueError):
        rot_ops.delta_rotate(torch.zeros((4, 8)), torch.zeros(3),
                             torch.zeros(3))


@pytest.mark.parametrize("n_shards", [1, 3])
def test_route_simulated_matches_reference(n_shards):
    cfg = TINY_MLA
    rng = np.random.default_rng(n_shards)
    q = rng.standard_normal((4, cfg.n_heads, cfg.d_qk)).astype(np.float32)
    shards = [rng.standard_normal((20 + 7 * i, cfg.d_qk)).astype(np.float32)
              for i in range(n_shards)]
    want = jax_route_simulated(JM.MLAConfig(**cfg.__dict__), jnp.asarray(q),
                               [jnp.asarray(s) for s in shards])
    got = route_simulated(cfg, torch.tensor(q),
                          [torch.tensor(s) for s in shards])
    _close(got.o, want.o)
    np.testing.assert_allclose(got.l.numpy(), np.asarray(want.l), rtol=RTOL)
    (batched,) = route_batched(cfg, [torch.tensor(q)],
                               [[torch.tensor(s) for s in shards]])
    assert torch.equal(batched.o, got.o)
    with pytest.raises(ValueError):
        route_batched(cfg, [torch.tensor(q)], [])
