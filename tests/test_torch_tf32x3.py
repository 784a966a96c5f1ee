"""The arithmetic of split-TF32 (3xTF32) products, emulated on the CPU.

flash_prefill's f32 kernel (csrc/flash_prefill.cu) and ssd_chunk's
(csrc/ssd_chunk.cu) run their matrix products on the tensor cores with f32
operands written as big + small, big = tf32(a) and small = tf32(a - big),
and a . b taken as small_a big_b + big_a small_b + big_a big_b with f32
sums (csrc/tf32x3.cuh). This file emulates that in plain torch:

  * tf32(a): round to nearest, ties away from zero, on the f32 bit pattern,
    keeping 10 mantissa bits (what cvt.rna.tf32.f32 does);
  * the three rounded products, each an f32 matrix product, summed in f32.

It then holds each kernel's computation, built from those products, against
the kernel's plain version at the kernel's own tolerance: flash_prefill on
causal V2-Lite-width inputs (H = 16, D = 576, d_v = 512) at Sq = Sk = 256,
1e-5 absolute and relative; the SSD intra-chunk step at mamba2-370m's
chunk (Q = 128, N = 128, P = 64), 1e-4 absolute and relative for y, the
chunk states and cum. The companion cases show that one TF32 product
(tf32(a) tf32(b)) misses those tolerances on the same inputs, so the check
can fail.

The SSD kernel keeps cum = cumsum(dt A) in step order, one f32 add a step:
on the card that is bit for bit what the plain version's torch.cumsum does
(a sequential f32 scan along a dimension that is not the innermost), so
the emulation takes cum from the same torch.cumsum call. A scan in any
other order (a warp scan, emulated here) moves cum by a few ulps at
|cum| ~ 200, and that alone takes y past its tolerance even with exact
f32 products: the last case shows it. Inputs are drawn from a numpy seed as chip_smoke.py phase 3 draws
them: standard normal q, ckv, x, B, C; dt = softplus(normal); A =
-exp(0.5 normal)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_prefill import flash_prefill_ref
from repro_torch.kernels.ssd_chunk import ssd_intra_chunk_ref

FLASH_TOL = (1e-5, 1e-5)      # chip_smoke.py TOL["flash_prefill"]
SSD_TOL = (1e-4, 1e-4)        # chip_smoke.py TOL["ssd_chunk"]
SCALE = 1 / 192 ** 0.5        # V2-Lite's softmax scale


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero: add half of the dropped 13 bits to the magnitude, then clear
    them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a, b):
    """a @ b as three TF32 products summed in f32, the small terms
    first."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def mm1(a, b):
    """a @ b as one TF32 product."""
    return tf32(a) @ tf32(b)


def within(got, want, tol) -> bool:
    atol, rtol = tol
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _prefill_inputs(Sq=256, Sk=256, H=16, D=576, seed=6):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, Sq, H, D)).astype(np.float32)
    ckv = rng.standard_normal((1, Sk, D)).astype(np.float32)
    return torch.from_numpy(q), torch.from_numpy(ckv)


def prefill_emulated(q, ckv, d_v, scale, mm):
    """The f32 kernel's arithmetic: S = Q K^T through `mm`, scaled and
    causally masked (tail-aligned), p = exp(S - rowmax) in f32, o = (p V
    through `mm`) / sum p."""
    _, Sq, H, D = q.shape
    Sk = ckv.shape[1]
    qr = q[0].reshape(Sq * H, D)                   # row r is position r / H
    s = mm(qr, ckv[0].T.contiguous()) * scale
    pos = torch.arange(Sq * H) // H + (Sk - Sq)
    s = s.masked_fill(torch.arange(Sk)[None, :] > pos[:, None],
                      float("-inf"))
    p = torch.exp(s - s.max(dim=1, keepdim=True).values)
    o = mm(p, ckv[0, :, :d_v].contiguous()) / p.sum(dim=1, keepdim=True)
    return o.reshape(1, Sq, H, d_v)


def _ssd_inputs(b=1, nc=2, Q=128, H=4, P=64, N=128, seed=7):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(b, nc, Q, H, P)
    dt = np.log1p(np.exp(f(b, nc, Q, H))).astype(np.float32)
    A = (-np.exp(0.5 * f(H))).astype(np.float32)
    return tuple(map(torch.from_numpy, (x, dt, A, f(b, nc, Q, N),
                                        f(b, nc, Q, N))))


def warp_scan(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last axis (length <= 128) in a warp
    scan's order: 32 lanes of 4 consecutive steps, each lane summing its
    four in step order, a Kogge-Stone scan of the lane totals over 5
    shuffle rounds, then each lane's exclusive prefix added to its four
    sums."""
    Q = v.shape[-1]
    w = torch.zeros(v.shape[:-1] + (128,), dtype=torch.float32)
    w[..., :Q] = v
    lanes = w.reshape(v.shape[:-1] + (32, 4))
    run = lanes.clone()
    for j in range(1, 4):
        run[..., j] = run[..., j - 1] + lanes[..., j]
    tot = run[..., 3].clone()
    off = 1
    while off < 32:
        shifted = torch.zeros_like(tot)
        shifted[..., off:] = tot[..., :-off]
        tot = tot + shifted
        off *= 2
    excl = torch.zeros_like(tot)
    excl[..., 1:] = tot[..., :-1]
    out = run + excl[..., None]           # lane 0 adds an exact 0
    return out.reshape(v.shape[:-1] + (128,))[..., :Q]


def step_order_cum(dt, A):
    """cum as the plain version computes it (module docstring)."""
    return torch.cumsum(dt * A[None, None, None], dim=2)


def warp_scan_cum(dt, A):
    cum = warp_scan((dt * A[None, None, None]).permute(0, 1, 3, 2))
    return cum.permute(0, 1, 3, 2).contiguous()


def ssd_emulated(x, dt, A, B, C, mm, cum_of=step_order_cum):
    """The SSD kernel's arithmetic per (batch, chunk, head): cum from
    `cum_of`; CB = C B^T, y = (CB o gate) (dt x) and the state
    (w o dt x)^T B through `mm`; the gate exactly 0 above the diagonal."""
    b, nc, Q, H, P = x.shape
    cum = cum_of(dt, A)                                      # (b, nc, Q, H)
    y = torch.empty_like(x)
    states = torch.empty((b, nc, H, P, B.shape[-1]))
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    for i in range(b):
        for c in range(nc):
            Bm, Cm = B[i, c], C[i, c]
            cb = mm(Cm, Bm.T.contiguous())
            for h in range(H):
                ch = cum[i, c, :, h]
                expo = (ch[:, None] - ch[None, :]).masked_fill(
                    ~causal, float("-inf"))
                xt = dt[i, c, :, h, None] * x[i, c, :, h]
                y[i, c, :, h] = mm(torch.where(causal, cb * torch.exp(expo),
                                               torch.zeros(())), xt)
                w = torch.exp(ch[-1] - ch)
                states[i, c, h] = mm((w[:, None] * xt).T.contiguous(), Bm)
    return y, states, cum


@pytest.mark.parametrize("Sq,Sk", [(256, 256), (64, 256)])
def test_prefill_3xtf32_meets_the_f32_tolerance(Sq, Sk):
    q, ckv = _prefill_inputs(Sq, Sk)
    want = flash_prefill_ref(q, ckv, 512, SCALE)
    got = prefill_emulated(q, ckv, 512, SCALE, mm3)
    assert within(got, want, FLASH_TOL), float((got - want).abs().max())


def test_prefill_one_tf32_product_misses_it():
    q, ckv = _prefill_inputs()
    want = flash_prefill_ref(q, ckv, 512, SCALE)
    assert not within(prefill_emulated(q, ckv, 512, SCALE, mm1), want,
                      FLASH_TOL)


def test_ssd_3xtf32_meets_its_tolerance():
    ins = _ssd_inputs()
    for got, want in zip(ssd_emulated(*ins, mm3), ssd_intra_chunk_ref(*ins)):
        assert within(got, want, SSD_TOL), float((got - want).abs().max())


def test_ssd_one_tf32_product_misses_it():
    ins = _ssd_inputs()
    got = ssd_emulated(*ins, mm1)
    want = ssd_intra_chunk_ref(*ins)
    assert not within(got[0], want[0], SSD_TOL)
    assert not within(got[1], want[1], SSD_TOL)


def test_ssd_reordered_cum_misses_it():
    """Exact f32 products, cum by a warp scan: y leaves its tolerance."""
    ins = _ssd_inputs()
    got = ssd_emulated(*ins, lambda a, b: a @ b, cum_of=warp_scan_cum)
    want = ssd_intra_chunk_ref(*ins)
    assert within(got[2], want[2], SSD_TOL)
    assert not within(got[0], want[0], SSD_TOL)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                                 # TF32's at 1.0
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [one + ulp, -(one + ulp), one, one + ulp,
                                3.0]
    big, small = split(torch.tensor([1.0 + 2.0 ** -20], dtype=torch.float32))
    assert big.item() == 1.0 and small.item() == 2.0 ** -20


def test_warp_scan_is_a_prefix_sum():
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 128)).astype(np.float32))
    np.testing.assert_allclose(warp_scan(v).numpy(),
                               np.cumsum(v.double().numpy(), axis=-1),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(warp_scan(v[:, :24]).numpy(),
                               np.cumsum(v[:, :24].double().numpy(), -1),
                               rtol=0, atol=1e-5)
