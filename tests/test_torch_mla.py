"""Port parity: absorbed-MLA decode (repro_torch.models.mla, the plain
mla_decode) against the JAX package on the same numpy inputs — the Pallas
mla_decode in interpret mode, mla_decode_ref, absorbed_partial and
absorbed_decode with the parameters carried over by mla_params_from_numpy.

Tolerances: f32 atol 2e-6 / rtol 1e-5 (tests/test_kernels.py:40), 5e-6 at
the paper width d_qk = 576 (tests/test_kernels.py:68); l is an
unnormalised sum and is held relative only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.merge import partial_from_logits as jax_partial_from_logits
from repro.kernels.mla_decode import mla_decode as mla_decode_pallas
from repro.kernels.mla_decode import mla_decode_ref as jax_mla_decode_ref
from repro.models import mla as JM
from repro.models.module import KeyGen, split
from repro.serving.backends.jax_exec import TINY_MLA as JAX_TINY
from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA
from repro_torch.convert import mla_params_from_numpy
from repro_torch.kernels.mla_decode import ops as mla_ops
from repro_torch.models import mla as TM
from repro_torch.serving.backends.torch_exec import TINY_MLA

SCALE = 1.0 / np.sqrt(192.0)
RTOL = 1e-5


def _qc(seed, B, H, S, D=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, D)).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32))


def _plain(q, ckv, lengths=None, d_v=48):
    """The port's wrapper on CPU tensors: its plain version, no launch."""
    before = mla_ops.mla_decode.launches
    out = mla_ops.mla_decode(
        torch.tensor(q), torch.tensor(ckv),
        None if lengths is None else torch.tensor(lengths), d_v=d_v,
        scale=SCALE)
    assert mla_ops.mla_decode.launches == before
    return out


def _close(got, want_o, want_m, want_l, atol):
    np.testing.assert_allclose(got.o.numpy(), np.asarray(want_o), atol=atol,
                               rtol=RTOL)
    np.testing.assert_allclose(got.m.numpy(), np.asarray(want_m), atol=atol,
                               rtol=RTOL)
    np.testing.assert_allclose(got.l.numpy(), np.asarray(want_l), rtol=RTOL)


@pytest.mark.parametrize("cfg", [TINY_MLA, V2_LITE_MLA])
def test_config_matches_reference(cfg):
    ref = JM.MLAConfig(**{f: getattr(cfg, f)
                          for f in cfg.__dataclass_fields__})
    assert (cfg.d_qk, cfg.qk_head_dim, cfg.scale, cfg.cache_width) \
        == (ref.d_qk, ref.qk_head_dim, ref.scale, ref.cache_width)
    assert TINY_MLA == TM.MLAConfig(**JAX_TINY.__dict__)
    assert (V2_LITE_MLA.d_qk, V2_LITE_MLA.kv_lora_rank) == (576, 512)


@pytest.mark.parametrize("B,H,S,D,d_v,atol", [
    (1, 4, 128, 64, 48, 2e-6), (2, 16, 256, 64, 48, 2e-6),
    (2, 16, 512, 576, 512, 5e-6)])
def test_plain_mla_decode_matches_pallas_and_ref(B, H, S, D, d_v, atol):
    q, ckv = _qc(B * 1000 + S + D, B, H, S, D)
    got = _plain(q, ckv, d_v=d_v)
    pallas = mla_decode_pallas(jnp.asarray(q), jnp.asarray(ckv), d_v=d_v,
                               scale=SCALE)
    _close(got, pallas.o, pallas.m, pallas.l, atol)
    _close(got, *jax_mla_decode_ref(jnp.asarray(q), jnp.asarray(ckv), d_v,
                                    SCALE), atol)


def test_plain_mla_decode_ragged_lengths():
    q, ckv = _qc(11, 3, 4, 256)
    lengths = np.asarray([64, 192, 256], np.int32)
    got = _plain(q, ckv, lengths)
    pallas = mla_decode_pallas(jnp.asarray(q), jnp.asarray(ckv),
                               jnp.asarray(lengths), d_v=48, scale=SCALE,
                               block_s=64)
    _close(got, pallas.o, pallas.m, pallas.l, 2e-6)
    for b in range(3):
        o, m, l = jax_mla_decode_ref(jnp.asarray(q[b:b + 1]),
                                     jnp.asarray(ckv[b:b + 1, :lengths[b]]),
                                     48, SCALE)
        np.testing.assert_allclose(got.o[b:b + 1].numpy(), np.asarray(o),
                                   atol=2e-6, rtol=RTOL)


def test_plain_mla_decode_length_zero_row_is_identity():
    """A row with no valid entries is the merge identity, as the reference
    jnp construction gives it (partial_from_logits over all-masked
    logits) — not the Pallas kernel, which returns NaN there."""
    q, ckv = _qc(12, 2, 4, 128)
    lengths = np.asarray([128, 0], np.int32)
    got = _plain(q, ckv, lengths)
    logits = jnp.einsum("hd,sd->hs", q[1], ckv[1]) * SCALE
    want = jax_partial_from_logits(logits, jnp.asarray(ckv[1, :, :48]),
                                   jnp.zeros(logits.shape, bool))
    np.testing.assert_array_equal(got.o[1].numpy(), np.asarray(want.o))
    np.testing.assert_array_equal(got.m[1].numpy(), np.asarray(want.m))
    np.testing.assert_array_equal(got.l[1].numpy(), np.asarray(want.l))
    assert np.all(np.isfinite(got.o.numpy()))


def test_mla_decode_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        mla_ops.mla_decode(torch.zeros((2, 4, 64)), torch.zeros((2, 8, 32)),
                           d_v=16)
    with pytest.raises(ValueError):
        mla_ops.mla_decode(torch.zeros((2, 4, 64)), torch.zeros((2, 8, 64)),
                           torch.zeros((3,), dtype=torch.int32), d_v=16)


@pytest.mark.parametrize("cfg,S,m_q,atol", [
    (TINY_MLA, 40, 3, 2e-6), (V2_LITE_MLA, 256, 2, 5e-6)])
@pytest.mark.parametrize("masked", [False, True])
def test_absorbed_partial_matches(cfg, S, m_q, atol, masked):
    rng = np.random.default_rng(S + m_q)
    q = rng.standard_normal((m_q, cfg.n_heads, cfg.d_qk)).astype(np.float32)
    ckv = rng.standard_normal((S, cfg.d_qk)).astype(np.float32)
    mask = rng.random(S) < 0.6 if masked else None
    jcfg = JM.MLAConfig(**cfg.__dict__)
    want = JM.absorbed_partial(jcfg, jnp.asarray(q), jnp.asarray(ckv),
                               None if mask is None else jnp.asarray(mask))
    got = TM.absorbed_partial(cfg, torch.tensor(q), torch.tensor(ckv),
                              None if mask is None else torch.tensor(mask))
    _close(got, want.o, want.m, want.l, atol)
    ref = TM.absorbed_partial_ref(cfg, torch.tensor(q), torch.tensor(ckv),
                                  None if mask is None else torch.tensor(mask))
    _close(ref, want.o, want.m, want.l, atol)


CFG = TM.MLAConfig(d_model=256, n_heads=4, kv_lora_rank=64,
                   qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)


@pytest.fixture(scope="module")
def carried():
    """One parameter tree from the reference's init_mla, as numpy, in both
    packages."""
    jcfg = JM.MLAConfig(**CFG.__dict__)
    params, _ = split(JM.init_mla(KeyGen(jax.random.PRNGKey(0)), jcfg,
                                  dtype=jnp.float32))
    np_params = jax.tree.map(np.asarray, params)
    mod = mla_params_from_numpy(np_params, CFG, device="cpu")
    return jcfg, params, mod


def test_mla_params_from_numpy_carries_every_tensor(carried):
    _, params, mod = carried
    np.testing.assert_array_equal(mod.kv_norm.numpy(),
                                  np.asarray(params["kv_norm"]["scale"]))
    for name in ("q_proj", "kv_down", "k_up", "v_up", "o_proj"):
        np.testing.assert_array_equal(getattr(mod, name).numpy(),
                                      np.asarray(params[name]))


def test_absorbed_decode_matches_reference(carried):
    jcfg, params, mod = carried
    rng = np.random.default_rng(7)
    B, S = 2, 48
    x = (0.1 * rng.standard_normal((B, 1, CFG.d_model))).astype(np.float32)
    cache = rng.standard_normal((B, S, CFG.d_qk)).astype(np.float32)
    pos = np.full((B, 1), S, np.int32)
    want_out, want_entry = JM.absorbed_decode(
        params, jcfg, jnp.asarray(x), jnp.asarray(cache), jnp.asarray(pos))
    got_out, got_entry = mod.decode(torch.tensor(x), torch.tensor(cache),
                                    torch.tensor(pos))
    np.testing.assert_allclose(got_entry.numpy(), np.asarray(want_entry),
                               atol=2e-6, rtol=RTOL)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=2e-6, rtol=RTOL)


def test_mla_params_from_numpy_rejects_wrong_shapes(carried):
    _, params, _ = carried
    bad = dict(jax.tree.map(np.asarray, params))
    bad["k_up"] = np.zeros((3, 3, 3), np.float32)
    with pytest.raises(ValueError, match="k_up"):
        mla_params_from_numpy(bad, CFG, device="cpu")
