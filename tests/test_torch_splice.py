"""Port parity: the FETCH splice (repro_torch.core.splice) and the plain
delta_rotate against the JAX package — the Pallas delta_rotate_band in
interpret mode and core.splice.splice_delta_rotate — at nonzero deltas, on
the same numpy inputs, in f32 and bf16. Also the rope helpers the rotation
is built from, and the single-process routing that merges shards.

Tolerance: f32 atol 2e-6 / rtol 1e-5 (tests/test_kernels.py:40). bf16: one
bf16 ulp of the expected value (2^-7 of the largest power of two not above
it, so 2^-8 relative at the least), with a 1e-6 absolute floor: both sides
compute in f32 and round once, but rope_cos_sin may differ by an f32 ulp
between XLA and torch, which can move a rounding by one bf16 step (and a
near-cancelling f32 result by ~1e-7). The latent columns are held bit for
bit in both types."""

import ctypes
import ctypes.util
import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.routing import route_simulated as jax_route_simulated
from repro.core.splice import splice_delta_rotate as jax_splice
from repro.kernels.delta_rotate import delta_rotate_band as pallas_rotate
from repro.models import layers as JL
from repro.models import mla as JM
from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA
from repro_torch.core import splice as port_splice
from repro_torch.core.routing import route_batched, route_simulated
from repro_torch.core.splice import splice_delta_rotate
from repro_torch.kernels.delta_rotate import ops as rot_ops
from repro_torch.models import layers as TL
from repro_torch.serving.backends.torch_exec import TINY_MLA

ATOL, RTOL = 2e-6, 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=RTOL)


@pytest.fixture
def round_to_nearest():
    """The calling thread's IEEE rounding mode pinned to round-to-nearest
    (fesetround) for the test, the mode it found restored after, and a
    warning naming that mode where it was another. At positions up to 4095
    one step of f32 rounding in the angle moves cos and sin by up to
    2.4e-4: a thread left in another mode by native code an earlier test
    ran in this process would round torch's angle products, computed on
    this thread, differently from XLA's."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    before = libm.fegetround()
    if before != 0:                         # FE_TONEAREST
        warnings.warn(f"test_rope_helpers_match found the thread's rounding "
                      f"mode at {before:#x}, not round-to-nearest")
    assert libm.fesetround(0) == 0
    yield
    libm.fesetround(before)


def test_rope_helpers_match(round_to_nearest):
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


DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}


def _chunk(seed, shape, dtype):
    """Standard normal numpy data in `dtype`, handed to both packages."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(DTYPES[dtype][0])


def _as_torch(x, dtype):
    return torch.from_numpy(x.astype(np.float32)).to(DTYPES[dtype][1])


def _to_np(t):
    return t.to(torch.float32).numpy()


def _close_dtype(got, want, dtype):
    """f32: ATOL / RTOL; bf16: one bf16 ulp of want (1e-6 floor)."""
    want = np.asarray(want).astype(np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        return
    _, e = np.frexp(np.abs(want))
    ulp = np.ldexp(np.float32(1.0), e - 8)     # 2^(floor(log2|w|) - 7)
    err = np.abs(got - want)
    assert (err <= np.maximum(ulp, 1e-6)).all(), float(err.max())


def _pallas_rotate_fn(cfg):
    """The reference's Pallas rotation in interpret mode as the splice's
    rotate_fn, on (S, d_r) bands (the kernel's layout)."""
    return lambda band, delta: pallas_rotate(
        band, jnp.float32(delta), head_dim=cfg.qk_rope_head_dim,
        theta=cfg.rope_theta, block_s=32, interpret=True)


@pytest.mark.parametrize("rotation", ["plain", "pallas"])
@pytest.mark.parametrize("cfg", [TINY_MLA, V2_LITE_MLA],
                         ids=["tiny", "v2_lite"])
@pytest.mark.parametrize("delta", [0, 5, 300, 4095])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_splice_matches_reference_in_both_dtypes(dtype, delta, cfg,
                                                  rotation):
    """The port's splice (one splice_rotate over the rows) against the
    reference splice with its plain rotation and with the Pallas kernel
    (interpret mode) as rotate_fn; latent columns bit for bit, the source
    untouched."""
    ckv = _chunk(delta + 1, (96, cfg.d_qk), dtype)
    src = _as_torch(ckv, dtype)
    kept = src.clone()
    got = splice_delta_rotate(src, delta, cfg)
    assert got.dtype == src.dtype and got.shape == src.shape
    jcfg = JM.MLAConfig(**cfg.__dict__)
    want = jax_splice(jnp.asarray(ckv), delta, jcfg,
                      rotate_fn=(_pallas_rotate_fn(cfg)
                                 if rotation == "pallas" else None))
    assert want.dtype == DTYPES[dtype][2]
    _close_dtype(_to_np(got), want, dtype)
    d_c = cfg.kv_lora_rank
    assert torch.equal(got[:, :d_c], src[:, :d_c])
    assert torch.equal(src, kept)


def test_splice_takes_leading_dims_in_one_call(monkeypatch):
    """A (3, 96, 576) stack, as one model's layers of a chunk, is one
    splice_rotate call, each layer equal to its own splice."""
    cfg = V2_LITE_MLA
    stack = _as_torch(_chunk(11, (3, 96, cfg.d_qk), "bf16"), "bf16")
    calls = []

    def counted(src, *args, **kw):
        calls.append(tuple(src.shape))
        return rot_ops.splice_rotate(src, *args, **kw)

    monkeypatch.setattr(port_splice, "splice_rotate", counted)
    got = splice_delta_rotate(stack, 300, cfg)
    monkeypatch.undo()
    assert calls == [(3 * 96, cfg.d_qk)] and got.shape == stack.shape
    for layer in range(3):
        assert torch.equal(got[layer],
                           splice_delta_rotate(stack[layer], 300, cfg))
    want = jax_splice(jnp.asarray(stack.to(torch.float32).numpy(),
                                  jnp.bfloat16), 300,
                      JM.MLAConfig(**cfg.__dict__))
    _close_dtype(_to_np(got), want, "bf16")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_splice_into_a_pool_slice(dtype):
    """out= rows of a larger pool: the moved copy lands there, the pool's
    other rows and the source stay as they were; out=src splices in
    place."""
    cfg = V2_LITE_MLA
    src = _as_torch(_chunk(5, (96, cfg.d_qk), dtype), dtype)
    kept = src.clone()
    pool = _as_torch(_chunk(6, (300, cfg.d_qk), dtype), dtype)
    before = pool.clone()
    dst = pool[100:196]
    got = splice_delta_rotate(src, 17, cfg, out=dst)
    assert got is dst
    want = splice_delta_rotate(src, 17, cfg)
    assert torch.equal(pool[100:196], want)
    assert torch.equal(pool[:100], before[:100])
    assert torch.equal(pool[196:], before[196:])
    assert torch.equal(src, kept)
    inplace = src.clone()
    assert splice_delta_rotate(inplace, 17, cfg, out=inplace) is inplace
    assert torch.equal(inplace, want)
    with pytest.raises(ValueError):
        splice_delta_rotate(src, 17, cfg, out=pool[:95])


def test_delta_cos_sin_memo_is_the_same_values():
    """A Python delta's (cos, sin) is memoised; a tensor delta is computed
    afresh; both equal rope_cos_sin of the delta."""
    a = rot_ops.delta_cos_sin(17, 64)
    assert rot_ops.delta_cos_sin(17, 64) is a
    fresh = rot_ops.delta_cos_sin(torch.tensor(17), 64)
    assert fresh is not a
    want = TL.rope_cos_sin(torch.tensor(17.0), 64)
    for got, w, f in zip(a, want, fresh):
        assert torch.equal(got, w) and torch.equal(f, w)


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
