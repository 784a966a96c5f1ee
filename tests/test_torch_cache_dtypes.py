"""The decode kernels' caches in bf16 and f16 (repro_torch.kernels
mla_decode and sparse_select), on the CPU.

On a card both kernels read a bf16 or f16 cache in place, each value
turned into f32 where it is used, so a call equals the f32 kernel on the
cache cast to f32 bit for bit (chip_smoke.py phase 3 holds that on the
card). On the CPU the wrapper takes its plain version on that cast, so the
same call equals the f32 call on ckv.float() bit for bit here too; these
tests hold that, the wrapper's checks of a cache it would read in place,
and both kernels against the JAX package's Pallas kernels in interpret
mode on the same bf16 / f16 inputs.

Tolerance against the JAX package: 5e-2 absolute (and relative on l), the
reference's own bf16 kernel tolerance (tests/test_kernels.py:50): both
sides compute in f32 from the same 16-bit values, but the Pallas kernel
takes q in the 16-bit type where the port takes q in f32 and rounds it to
that type first here, and the sums run in other orders.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.mla_decode import mla_decode as mla_decode_pallas
from repro.kernels.sparse_select import sparse_select_decode
from repro_torch.kernels.mla_decode import ops as mla_ops
from repro_torch.kernels.sparse_select import ops as sel_ops

SCALE = 1.0 / np.sqrt(192.0)
D, D_V = 64, 48
ATOL = 5e-2
DTYPES = {"bf16": (torch.bfloat16, ml_dtypes.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, np.float16, jnp.float16)}


def _qc(seed, B, R, S, name):
    """q and ckv from a seed, rounded to the 16-bit type `name` (numpy)."""
    _, np_dt, _ = DTYPES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, R, D)).astype(np_dt)
    ckv = rng.standard_normal((B, S, D)).astype(np_dt)
    return q, ckv


def _t(x, name):
    """A numpy 16-bit array as a torch tensor of that type (through f32:
    exact)."""
    return torch.tensor(np.asarray(x, np.float32)).to(DTYPES[name][0])


def _bits_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _near(got, want, atol=ATOL):
    np.testing.assert_allclose(got.o.numpy(), np.asarray(want.o, np.float32),
                               atol=atol, rtol=atol)
    np.testing.assert_allclose(got.m.numpy(), np.asarray(want.m, np.float32),
                               atol=atol, rtol=atol)
    np.testing.assert_allclose(got.l.numpy(), np.asarray(want.l, np.float32),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("B,R,S,lengths", [
    (1, 16, 256, None), (2, 64, 128, None), (3, 8, 200, (200, 37, 0))])
def test_mla_decode_cache_equals_its_f32_cast(name, B, R, S, lengths):
    q, ckv = _qc(B * 100 + R + S, B, R, S, name)
    q32 = torch.tensor(np.asarray(q, np.float32))
    c16 = _t(ckv, name)
    lens = None if lengths is None else torch.tensor(lengths,
                                                     dtype=torch.int32)
    before = mla_ops.mla_decode.launches
    got = mla_ops.mla_decode(q32, c16, lens, d_v=D_V, scale=SCALE)
    want = mla_ops.mla_decode(q32, c16.float(), lens, d_v=D_V, scale=SCALE)
    assert mla_ops.mla_decode.launches == before
    assert got.o.dtype == torch.float32 and _bits_equal(got, want)
    # a 16-bit q is cast to f32 as well
    assert _bits_equal(mla_ops.mla_decode(_t(q, name), c16, lens, d_v=D_V,
                                          scale=SCALE), want)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("B,R,S,KB,bt", [
    (1, 16, 512, 4, 64), (2, 64, 256, 3, 64), (1, 8, 300, 37, 1)])
def test_sparse_select_cache_equals_its_f32_cast(name, B, R, S, KB, bt):
    q, ckv = _qc(B * 31 + KB, B, R, S, name)
    rng = np.random.default_rng(KB + bt)
    idx = torch.tensor(np.stack([np.sort(rng.choice(
        -(-S // bt), KB, replace=False)) for _ in range(B)]).astype(np.int32))
    q32 = torch.tensor(np.asarray(q, np.float32))
    c16 = _t(ckv, name)
    before = sel_ops.sparse_select.launches
    got = sel_ops.sparse_select(q32, c16, idx, d_v=D_V, scale=SCALE,
                                block_tokens=bt)
    want = sel_ops.sparse_select(q32, c16.float(), idx, d_v=D_V,
                                 scale=SCALE, block_tokens=bt)
    assert sel_ops.sparse_select.launches == before
    assert _bits_equal(got, want)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("B,H,S", [(1, 4, 256), (2, 16, 512)])
def test_mla_decode_matches_pallas(name, B, H, S):
    """The port on a 16-bit q and cache against mla_decode_pallas (the
    reference's kernel, interpret mode) on the same values."""
    q, ckv = _qc(B * 7 + S, B, H, S, name)
    jdt = DTYPES[name][2]
    got = mla_ops.mla_decode(_t(q, name), _t(ckv, name), d_v=D_V,
                             scale=SCALE)
    want = mla_decode_pallas(jnp.asarray(q, jdt), jnp.asarray(ckv, jdt),
                             d_v=D_V, scale=SCALE, block_s=128)
    _near(got, want)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("B,H,S,KB", [(1, 4, 512, 4), (2, 16, 1024, 8)])
def test_sparse_select_matches_pallas(name, B, H, S, KB):
    """The port on a 16-bit q and cache against sparse_select_decode (the
    reference's Pallas kernel, interpret mode) on the same values."""
    q, ckv = _qc(B * 13 + KB, B, H, S, name)
    rng = np.random.RandomState(B + KB)
    idx = np.stack([np.sort(rng.choice(S // 64, KB, replace=False))
                    for _ in range(B)]).astype(np.int32)
    jdt = DTYPES[name][2]
    got = sel_ops.sparse_select(_t(q, name), _t(ckv, name),
                                torch.tensor(idx), d_v=D_V, scale=SCALE)
    want = sparse_select_decode(jnp.asarray(q, jdt), jnp.asarray(ckv, jdt),
                                jnp.asarray(idx), d_v=D_V, scale=SCALE)
    _near(got, want)


def test_cache_operands_cast_only_where_no_kernel_reads_in_place():
    """On the CPU (the plain version) a 16-bit cache is cast to f32 and an
    f32 one passes as it is; q is always f32; a non-float cache raises."""
    q = torch.zeros(1, 16, 64, dtype=torch.bfloat16)
    c16 = torch.randn(1, 32, 64).to(torch.bfloat16)
    q2, c2 = mla_ops.cache_operands("mla_decode", q, c16)
    assert q2.dtype == torch.float32 and c2.dtype == torch.float32
    assert torch.equal(c2, c16.float())
    c32 = torch.randn(1, 32, 64)
    assert mla_ops.cache_operands("mla_decode", q, c32)[1] is c32
    with pytest.raises(TypeError, match="floating point"):
        mla_ops.cache_operands("mla_decode", q, torch.zeros(1, 32, 64,
                                                            dtype=torch.int32))


@pytest.mark.parametrize("dtype,shape,strides,match", [
    (torch.float64, (1, 32, 64), None, "f32, bf16 or f16"),
    (torch.bfloat16, (1, 32, 60), None, "divisible by 8"),
    (torch.float16, (1, 32, 64), (32 * 68, 68, 1), "divisible by 8"),
    (torch.float32, (1, 32, 64), (32 * 66, 66, 1), "divisible by 4")])
def test_cache_check_refuses_what_the_loops_cannot_read(dtype, shape,
                                                        strides, match):
    """The cache a kernel reads in place: f32, bf16 or f16, its row and
    batch strides and D whole 16-byte units (4 f32 or 8 16-bit values)."""
    q = torch.zeros(1, 16, shape[2])
    ckv = torch.zeros(shape, dtype=dtype)
    if strides is not None:
        ckv = torch.empty_strided(shape, strides, dtype=dtype)
    with pytest.raises((TypeError, ValueError), match=match):
        mla_ops.check_cache(q, ckv, D_V, "mla_decode")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cache_check_takes_the_cache_shapes_of_the_main_path(dtype):
    """V2-Lite's cache (D = 576, d_v = 512) contiguous and as a row view of
    a wider buffer with a row stride in whole 16-byte units; d_v must be
    too (8 16-bit values)."""
    q = torch.zeros(1, 16, 576)
    mla_ops.check_cache(q, torch.zeros(2, 64, 576, dtype=dtype), 512, "x")
    wide = torch.zeros(2, 64, 584, dtype=dtype)[:, :, :576]
    mla_ops.check_cache(q, wide, 512, "x")
    if dtype != torch.float32:
        with pytest.raises(ValueError, match="d_v"):
            mla_ops.check_cache(q, torch.zeros(1, 64, 576, dtype=dtype),
                                508, "x")
    assert mla_ops.DTYPES[dtype] == {torch.float32: 0, torch.bfloat16: 1,
                                     torch.float16: 2}[dtype]
