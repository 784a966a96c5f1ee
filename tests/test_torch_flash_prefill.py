"""Port parity: the causal latent flash prefill (repro_torch.kernels.
flash_prefill, its plain version on CPU tensors) against the JAX package's
flash_prefill_ref and the Pallas kernel in interpret mode, on the cases of
tests/test_kernels.py:TestFlashPrefill (Sq < Sk included), plus a ragged
Sk that no block of the Pallas kernel divides, and the absorbed prefill
form of mla_attention against the reference's decompressed one.

The wrapper's dtype contract: q and ckv both f32 or both bf16 (the card
picks the f32 or the bf16 kernel by it), anything else a TypeError on every
device; CPU tensors of either dtype take the plain version and return f32.
mla_attention hands the inner op the model's own dtype, uncast.

Tolerances: f32 atol 3e-6 / rtol 1e-5 for the kernel (tests/test_kernels.py
:207-208); the absorbed against the decompressed attention at atol 2e-5 /
rtol 1e-4 (tests/test_mla.py:41-42: the two forms sum in other orders); in
bf16 2e-2 absolute and relative (both packages round the projections to
bf16, in other places)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill import flash_prefill as jax_flash_prefill
from repro.kernels.flash_prefill import flash_prefill_ref as jax_ref
from repro.models import mla as JM
from repro.models.module import KeyGen, split
from repro_torch.convert import mla_params_from_numpy
from repro_torch.kernels.flash_prefill import flash_prefill, flash_prefill_ref
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.mla_decode.ops import split_plan
from repro_torch.models import mla as TM

SCALE = 1.0 / np.sqrt(192.0)
ATOL, RTOL = 3e-6, 1e-5


def _qc(seed, B, Sq, Sk, H, D=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, D)).astype(np.float32))


def _plain(q, ckv, d_v=48):
    before = fp_ops.flash_prefill.launches
    out = flash_prefill(torch.tensor(q), torch.tensor(ckv), d_v=d_v,
                        scale=SCALE)
    assert fp_ops.flash_prefill.launches == before
    return out.numpy()


@pytest.mark.parametrize("B,Sq,Sk,H", [(1, 64, 64, 2), (2, 128, 256, 4),
                                       (1, 256, 256, 8)])
def test_plain_matches_ref_and_pallas(B, Sq, Sk, H):
    q, ckv = _qc(Sq + Sk, B, Sq, Sk, H)
    got = _plain(q, ckv)
    assert got.shape == (B, Sq, H, 48) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(ckv), 48, SCALE)),
        atol=ATOL, rtol=RTOL)
    pallas = jax_flash_prefill(jnp.asarray(q), jnp.asarray(ckv), d_v=48,
                               scale=SCALE, block_q=64, block_k=64)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("Sq,Sk", [(50, 50), (37, 101), (1, 77)])
def test_ragged_lengths_match_ref(Sq, Sk):
    """Sq and Sk that no tile divides (the Pallas kernel asserts they are
    multiples of its blocks; the port's kernel masks the ragged edge)."""
    q, ckv = _qc(Sq * Sk, 2, Sq, Sk, 3)
    np.testing.assert_allclose(
        _plain(q, ckv),
        np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(ckv), 48, SCALE)),
        atol=ATOL, rtol=RTOL)


def test_tail_alignment_and_causality():
    """Query i sees exactly rows [0, Sk - Sq + i]: changing a later row
    leaves it unchanged, and the last query equals full attention."""
    q, ckv = _qc(3, 1, 8, 20, 2)
    base = _plain(q, ckv)
    moved = ckv.copy()
    moved[0, 15] += 10.0                    # row 15: seen from query 3 on
    after = _plain(q, moved)
    np.testing.assert_array_equal(after[0, :3], base[0, :3])
    assert not np.allclose(after[0, 3:], base[0, 3:])
    full = flash_prefill_ref(torch.tensor(q[:, -1:]), torch.tensor(ckv), 48,
                             SCALE).numpy()
    np.testing.assert_allclose(base[:, -1:], full, atol=ATOL, rtol=RTOL)


def test_rejects_bad_inputs():
    with pytest.raises(ValueError, match="Sq=9 > Sk=8"):
        flash_prefill(torch.zeros((1, 9, 2, 16)), torch.zeros((1, 8, 16)),
                      d_v=8)
    with pytest.raises(ValueError):
        flash_prefill(torch.zeros((1, 4, 2, 16)), torch.zeros((1, 8, 12)),
                      d_v=8)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_prefill(torch.zeros((1, 4, 2, 16), device="meta"),
                      torch.zeros((1, 8, 16), device="meta"), d_v=8)


CFG = TM.MLAConfig(d_model=96, n_heads=4, kv_lora_rank=32,
                   qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)


@pytest.fixture(scope="module")
def carried():
    jcfg = JM.MLAConfig(**CFG.__dict__)
    params, _ = split(JM.init_mla(KeyGen(jax.random.PRNGKey(3)), jcfg,
                                  dtype=jnp.float32))
    np_params = jax.tree.map(np.asarray, params)
    return jcfg, np_params


@pytest.mark.parametrize("dtype,atol,rtol", [
    ("float32", 2e-5, 1e-4), ("bfloat16", 2e-2, 2e-2)])
def test_absorbed_prefill_matches_reference(carried, dtype, atol, rtol):
    """The port's mla_attention (absorbed, through flash_prefill) against
    the reference's decompressed mla_attention on the same weights: the
    output and the latent cache entries."""
    jcfg, np_params = carried
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(11)
    B, S = 2, 24
    x = rng.standard_normal((B, S, CFG.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), np_params)
    want_out, want_e = JM.mla_attention(jparams, jcfg, jnp.asarray(x, jdt),
                                        jnp.asarray(pos))
    mod = mla_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt), np.float32),
                     np_params), CFG, dtype=tdt, device="cpu")
    got_out, got_e = TM.mla_attention(
        mod, CFG, torch.tensor(np.asarray(jnp.asarray(x, jdt), np.float32),
                               dtype=tdt), torch.tensor(pos))
    assert got_out.dtype == tdt and got_e.dtype == tdt
    np.testing.assert_allclose(got_e.float().numpy(),
                               np.asarray(want_e, np.float32),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(got_out.float().numpy(),
                               np.asarray(want_out, np.float32),
                               atol=atol, rtol=rtol)


def test_mla_attention_takes_the_plain_op_explicitly(carried):
    """The prefill inner op is an argument: the plain version gives the same
    result as the wrapper (on CPU tensors the wrapper runs it)."""
    _, np_params = carried
    mod = mla_params_from_numpy(np_params, CFG, device="cpu")
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((1, 16, CFG.d_model)),
                     dtype=torch.float32)
    pos = torch.arange(16, dtype=torch.int32)[None]
    a, ea = TM.mla_attention(mod, CFG, x, pos)
    b, eb = TM.mla_attention(mod, CFG, x, pos, prefill_fn=flash_prefill_ref)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(ea, eb, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_hands_prefill_fn_the_model_dtype(carried, dtype):
    """No cast before the inner op: a bf16 model's queries and entries reach
    it in bf16 (on the card: the bf16 kernel), an f32 model's in f32."""
    _, np_params = carried
    tdt = getattr(torch, dtype)
    mod = mla_params_from_numpy(np_params, CFG, dtype=tdt, device="cpu")
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((2, 12, CFG.d_model)),
                     dtype=torch.float32).to(tdt)
    pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    seen = []

    def spy(q, ckv, *, d_v, scale):
        seen.append((q.dtype, ckv.dtype, q.is_contiguous(),
                     ckv.is_contiguous()))
        return flash_prefill_ref(q, ckv, d_v, scale)

    out, entries = TM.mla_attention(mod, CFG, x, pos, prefill_fn=spy)
    assert seen == [(tdt, tdt, True, True)]
    assert out.dtype == tdt and entries.dtype == tdt


@pytest.mark.parametrize("Sq,Sk,H", [(24, 24, 4), (7, 19, 3)])
def test_wrapper_takes_bf16_to_the_plain_version_on_cpu(Sq, Sk, H):
    """bf16 CPU operands: the plain version, f32 out, equal bit for bit to
    the plain version of their f32 casts; no kernel launch counted."""
    q, ckv = _qc(Sq + 31 * Sk, 2, Sq, Sk, H)
    qb = torch.tensor(q).to(torch.bfloat16)
    cb = torch.tensor(ckv).to(torch.bfloat16)
    before = (fp_ops.flash_prefill.launches,
              dict(fp_ops.flash_prefill.launches_by_dtype))
    got = flash_prefill(qb, cb, d_v=48, scale=SCALE)
    assert (fp_ops.flash_prefill.launches,
            fp_ops.flash_prefill.launches_by_dtype) == before
    assert got.dtype == torch.float32 and got.shape == (2, Sq, H, 48)
    want = flash_prefill_ref(qb.float(), cb.float(), 48, SCALE)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("q_dtype,c_dtype", [
    ("float32", "bfloat16"), ("bfloat16", "float32"),
    ("float16", "float16"), ("float64", "float64")])
def test_mixed_or_other_dtypes_raise_type_error(device, q_dtype, c_dtype):
    q = torch.zeros((1, 4, 2, 16), dtype=getattr(torch, q_dtype),
                    device=device)
    ckv = torch.zeros((1, 8, 16), dtype=getattr(torch, c_dtype),
                      device=device)
    with pytest.raises(TypeError, match="both f32 or both bf16"):
        flash_prefill(q, ckv, d_v=8)


@pytest.mark.parametrize("shape,d_v,strided,match", [
    ((1, 8, 16, 580), 512, False, "D % 8 == 0"),
    ((1, 8, 16, 640), 512, False, "D <= 576"),
    ((1, 8, 16, 576), 504, False, "d_v % 16 == 0"),
    ((1, 8, 16, 576), 512, True, "row/batch strides divisible by 8"),
])
def test_bf16_kernel_checks_refuse_what_it_cannot_take(shape, d_v, strided,
                                                       match):
    """The bf16 kernel's shape and stride checks (run before any launch)
    raise a clear error; the launch itself is on the card only."""
    B, Sq, H, D = shape
    q = torch.zeros(shape, dtype=torch.bfloat16)
    width = D + 4 if strided else D          # a row pitch of D + 4 elements
    ckv = torch.zeros((B, Sq, width), dtype=torch.bfloat16)[..., :D]
    with pytest.raises(ValueError, match=match):
        fp_ops.check_bf16(q, ckv, d_v)


def test_bf16_kernel_checks_take_the_model_layout():
    q = torch.zeros((2, 40, 16, 576), dtype=torch.bfloat16)
    ckv = torch.zeros((2, 40, 576), dtype=torch.bfloat16)
    fp_ops.check_bf16(q, ckv, 512)


@pytest.mark.parametrize("B,R,Sk", [(1, 4096, 2048), (1, 32768, 2048),
                                    (1, 640, 300), (2, 308, 101),
                                    (1, 64, 64), (3, 48, 5000)])
def test_bf16_split_plan_covers_the_cache_in_whole_tiles(B, R, Sk):
    """The bf16 kernel's plan (one block of 64 rows per SM, 64-row tiles):
    spans are whole tiles that cover Sk, split only while the blocks do not
    fill the SMs, each at least two tiles."""
    plan = fp_ops.BF16_PLAN
    split_len, n_split = split_plan(B, R, Sk, 132, **plan)
    assert split_len % plan["tile"] == 0
    assert (n_split - 1) * split_len < Sk <= n_split * split_len
    blocks = -(-R // plan["rows"]) * B
    assert n_split == 1 or blocks * n_split <= 132
    assert n_split == 1 or split_len >= 2 * plan["tile"]


@pytest.mark.parametrize("B,R,Sk", [(1, 32768, 2048), (1, 4096, 2048),
                                    (2, 32000, 2000), (1, 640, 300),
                                    (2, 308, 101), (1, 64, 64)])
def test_f32_split_plan_covers_the_cache_in_whole_tiles(B, R, Sk):
    """The f32 kernel's plan (one block of 64 rows per SM, 16-row tiles):
    spans are whole tiles that cover Sk, split only while the blocks do not
    fill the SMs, each at least two tiles."""
    plan = fp_ops.F32_PLAN
    split_len, n_split = split_plan(B, R, Sk, 132, **plan)
    assert split_len % plan["tile"] == 0
    assert (n_split - 1) * split_len < Sk <= n_split * split_len
    blocks = -(-R // plan["rows"]) * B
    assert n_split == 1 or blocks * n_split <= 132
    assert n_split == 1 or split_len >= 2 * plan["tile"]


@pytest.mark.parametrize("D,d_v,ok", [(576, 512, True), (40, 32, True),
                                      (580, 512, False), (578, 512, False),
                                      (576, 516, False)])
def test_f32_kernel_check_takes_what_the_kernel_takes(D, d_v, ok):
    """The f32 kernel's shared tiles hold D <= 576 columns in whole float4
    copies and at most 512 output columns: the wrapper refuses the rest
    before any launch."""
    q = torch.zeros((1, 3, 2, D))
    ckv = torch.zeros((1, 5, D))
    if ok:
        fp_ops._check_f32(q, ckv, d_v)
    else:
        with pytest.raises(ValueError, match="flash_prefill kernel"):
            fp_ops._check_f32(q, ckv, d_v)
