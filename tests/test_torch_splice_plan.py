"""The plan of the splice kernel (repro_torch.kernels.delta_rotate.ops
.splice_plan), on the CPU with made-up pointers, pitches and shapes: which
path a launch takes (16-byte vectors or one element an item), how the grid
is sized, and, through a numpy model of csrc/delta_rotate.cu's item walk,
that the grid visits every item of every row once and that the items cover
every column of a row once, giving the plain version's values bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.delta_rotate import ops as rot_ops
from repro_torch.kernels.delta_rotate import delta_cos_sin, delta_rotate_ref

N_SM = 132                # the H100 SXM's SMs
BASE = 0x7F3A_0000_0000   # a 256-byte aligned device address
F32, BF16 = 4, 2          # element sizes
D_QK, D_C, D_R = 576, 512, 64   # DeepSeek-V2-Lite's latent rows


def plan_of(rows, elem=F32, d_c=D_C, d_r=D_R, ldx=D_QK, ldy=D_QK,
            x_off=0, y_off=0):
    return rot_ops.splice_plan(BASE + x_off * elem, ldx, BASE + y_off * elem,
                               ldy, rows, d_c, d_r, elem, N_SM)


@pytest.mark.parametrize("elem,width", [(F32, 4), (BF16, 8)])
def test_v2_lite_splice_takes_the_16_byte_path(elem, width):
    plan = plan_of(2048, elem)
    assert plan.vec and plan.width == width
    assert plan.per_row == (D_C + D_R // 2) // width   # 136 f32, 68 bf16


@pytest.mark.parametrize("elem", [F32, BF16])
def test_band_at_column_512_takes_the_16_byte_path(elem):
    """The band-only entry on ckv[:, 512:] of 576-wide rows, written into
    the same columns of the moved copy."""
    plan = plan_of(2048, elem, d_c=0, x_off=D_C, y_off=D_C)
    assert plan.vec and plan.per_row == D_R // 2 // plan.width


@pytest.mark.parametrize("case", ["x offset", "y offset", "odd x pitch",
                                  "odd y pitch", "d2 % W", "d_c % W"])
@pytest.mark.parametrize("elem", [F32, BF16])
def test_misaligned_calls_take_the_scalar_path(case, elem):
    kw = {"x offset": {"x_off": 1}, "y offset": {"y_off": 1},
          "odd x pitch": {"ldx": 577}, "odd y pitch": {"ldy": 579},
          "d2 % W": {"d_r": 12 if elem == F32 else 8},
          "d_c % W": {"d_c": 510}}[case]
    plan = plan_of(2048, elem, **kw)
    assert not plan.vec and plan.width == 1
    d_c, d_r = kw.get("d_c", D_C), kw.get("d_r", D_R)
    assert plan.per_row == d_c + d_r // 2


def test_grid_sizing():
    """One round of UNROLL items a thread where that still fills the card,
    one item a thread for the small band; a whole model's stack in waves of
    blocks, every thread still one round."""
    v2 = plan_of(2048)
    items = 2048 * v2.per_row
    assert v2.blocks * v2.threads * rot_ops.UNROLL >= items
    assert v2.blocks >= rot_ops.FILL_BLOCKS * N_SM
    band = plan_of(2048, d_c=0, x_off=D_C, y_off=D_C)
    assert band.blocks * band.threads == 2048 * band.per_row   # one each
    stack = plan_of(27 * 2048, BF16)
    assert stack.blocks == -(-27 * 2048 * stack.per_row
                             // (stack.threads * rot_ops.UNROLL))   # 3672
    for rows in (1, 37, 2048, 4096, 27 * 2048):
        for elem, x_off in ((F32, 0), (BF16, 0), (F32, 1), (BF16, 1)):
            p = plan_of(rows, elem, x_off=x_off)
            assert p.blocks * p.threads * rot_ops.UNROLL >= rows * p.per_row
    assert plan_of(0).blocks == 0 and plan_of(0, BF16).blocks == 0


@pytest.mark.parametrize("d_r", [0, 3, 130, 256])
def test_plan_rejects_bands_the_kernel_does_not_take(d_r):
    with pytest.raises(ValueError):
        plan_of(16, d_r=d_r)


def walk(plan, rows):
    """The test's model of splice_kernel's loop: thread t starts at item t,
    (row, k) advance by the grid's stride with one carry, UNROLL items a
    round, until the row passes the last. Returns how often each (row,
    item) is visited."""
    G = plan.blocks * plan.threads
    d_row, d_k = divmod(G, plan.per_row)
    row, k = np.divmod(np.arange(G), plan.per_row)
    seen = np.zeros((rows, plan.per_row), np.int64)
    while (row < rows).any():
        for _ in range(rot_ops.UNROLL):
            live = row < rows
            np.add.at(seen, (row[live], k[live]), 1)
            row, k = row + d_row, k + d_k
            carry = k >= plan.per_row
            k[carry] -= plan.per_row
            row[carry] += 1
    return seen


@pytest.mark.parametrize("rows,elem,d_c,extra", [
    (1, F32, D_C, {}), (37, F32, D_C, {}), (2048, F32, D_C, {}),
    (37, BF16, D_C, {}), (2048, BF16, D_C, {}),
    (2048, F32, 0, {"x_off": D_C, "y_off": D_C}),
    (37, F32, D_C, {"x_off": 1}), (300, BF16, D_C, {"ldx": 577}),
    (27 * 2048, BF16, D_C, {})])
def test_the_grid_visits_every_item_once(rows, elem, d_c, extra):
    plan = plan_of(rows, elem, d_c=d_c, **extra)
    assert (walk(plan, rows) == 1).all()


def emulate(plan, src, cos, sin, d_c):
    """splice_kernel's items on the CPU: latent vector k copies columns
    [kW, (k+1)W), band pair p rotates columns d_c + [pW, (p+1)W) with
    d_c + d2 + [pW, (p+1)W) in f32 (numpy float32: each product and the
    difference / sum rounded on its own), rounding once to the storage
    type. Every column of out is written exactly once."""
    rows, d_qk = src.shape
    d2, W = (d_qk - d_c) // 2, plan.width
    lat = d_c // W
    x = src.to(torch.float32).numpy()
    out = np.full_like(x, np.nan)
    writes = np.zeros(x.shape, np.int64)
    c, s = cos.numpy(), sin.numpy()
    for k in range(plan.per_row):
        if k < lat:
            cols = slice(k * W, (k + 1) * W)
            out[:, cols] = x[:, cols]
            writes[:, cols] += 1
            continue
        p = (k - lat) * W
        c1 = slice(d_c + p, d_c + p + W)
        c2 = slice(d_c + d2 + p, d_c + d2 + p + W)
        x1, x2 = x[:, c1], x[:, c2]
        cc, ss = c[p:p + W], s[p:p + W]
        out[:, c1] = x1 * cc - x2 * ss
        out[:, c2] = x2 * cc + x1 * ss
        writes[:, c1] += 1
        writes[:, c2] += 1
    assert (writes == 1).all()
    return torch.from_numpy(out).to(src.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_off", [0, 1])
@pytest.mark.parametrize("delta", [0, 17, 4095])
def test_the_items_are_the_plain_splice_bit_for_bit(dtype, x_off, delta):
    g = torch.Generator().manual_seed(delta + x_off)
    src = torch.randn((37, D_QK), generator=g).to(dtype)
    plan = plan_of(37, src.element_size(), x_off=x_off)
    assert plan.vec == (x_off == 0)
    cos, sin = delta_cos_sin(delta, D_R)
    got = emulate(plan, src, cos, sin, D_C)
    assert torch.equal(got[:, :D_C], src[:, :D_C])
    assert torch.equal(got[:, D_C:], delta_rotate_ref(src[:, D_C:], cos,
                                                      sin))
    assert torch.equal(got, rot_ops.splice_rotate(src, cos, sin, D_C))
