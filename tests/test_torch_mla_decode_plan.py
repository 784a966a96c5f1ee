"""The plan of the mla_decode kernel (repro_torch.kernels.mla_decode.ops),
on the CPU: which loop a call takes, how S is split into spans, and that
the spans' plain partials merged in slot order are the whole attention.
Also pins split_plan, which the flash_prefill kernels keep.

Tolerance: the merged spans against mla_decode_ref, 1e-6 absolute and
relative in f32 (the same logits, summed over the spans in another order).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.mla_decode import mla_decode_ref
from repro_torch.kernels.mla_decode import ops as mla_ops
from repro_torch.kernels.softmax_merge import softmax_merge_ref

N_SM = 132                # the H100 SXM's SMs

# (B, R, S): a single request, model decode (B = 2 over a 2056-slot cache),
# the group loop's edges, the ROUTE groups of chip_smoke.py phase 3, ragged
# and tiny caches
SHAPES = [(1, 16, 2048), (2, 16, 2056), (3, 16, 2048), (1, 1, 2048),
          (1, 63, 2048), (1, 64, 2048), (1, 65, 2048), (3, 64, 2048),
          (1, 256, 2048), (1, 4096, 2048), (1, 16384, 2048),
          (1, 65536, 8), (2, 308, 101), (1, 40, 300), (1, 16, 1),
          (4, 64, 5000), (60, 16, 2048), (200, 16, 2048)]


def decode_spans(plan, S, length=None):
    """[begin, end) of each span of a batch row with `length` valid cache
    rows (None: S): the test's model of span_of in csrc/mla_decode.cu,
    which cuts span z as tiles [z T / n, (z + 1) T / n) of the T tiles of
    S, whole tiles but for the one holding S's end, and ends it at the
    row's length; begin >= end is an empty span."""
    tile, n = mla_ops.LOOPS[plan.loop].tile, plan.n_split
    tiles = math.ceil(S / tile)
    length = S if length is None else max(0, min(length, S))
    return [((z * tiles // n) * tile,
             min(length, ((z + 1) * tiles // n) * tile)) for z in range(n)]


def _blocks(B, R, plan):
    return math.ceil(R / mla_ops.LOOPS[plan.loop].rows) * B * plan.n_split


@pytest.mark.parametrize("B,R,S", SHAPES)
def test_plan_covers_every_row_and_position_once(B, R, S):
    plan = mla_ops.decode_plan(B, R, S, N_SM)
    lp = mla_ops.LOOPS[plan.loop]
    row_tiles = math.ceil(R / lp.rows)
    assert (row_tiles - 1) * lp.rows < R <= row_tiles * lp.rows
    for length in (None, S // 3, 0):
        spans = decode_spans(plan, S, length)
        assert len(spans) == plan.n_split
        end = S if length is None else length
        seen = np.zeros(S, np.int64)
        for begin, stop in spans:
            seen[begin:max(begin, stop)] += 1
        assert (seen[:end] == 1).all() and (seen[end:] == 0).all()
        bounds = [b for b, _ in decode_spans(plan, S)]
        assert bounds == sorted(bounds) and bounds[0] == 0


@pytest.mark.parametrize("B,R,S", SHAPES)
def test_spans_are_whole_tiles_but_the_last(B, R, S):
    plan = mla_ops.decode_plan(B, R, S, N_SM)
    tile = mla_ops.LOOPS[plan.loop].tile
    spans = decode_spans(plan, S)
    assert all(begin % tile == 0 and begin < stop for begin, stop in spans)
    assert all(stop % tile == 0 for _, stop in spans[:-1])
    assert spans[-1][1] == S
    sizes = {(stop - begin + tile - 1) // tile for begin, stop in spans}
    assert max(sizes) - min(sizes) <= 1          # balanced


@pytest.mark.parametrize("B,R,S", SHAPES)
def test_plan_fills_the_card_and_stays_co_resident(B, R, S):
    """A split launch is cooperative: its blocks never outnumber what fits
    on the card at once. Within that, it splits as far as whole tiles and
    co-residency allow; with at most 12 row tiles (132 - 120) that is at
    least min(120, work tiles) blocks."""
    plan = mla_ops.decode_plan(B, R, S, N_SM)
    lp = mla_ops.LOOPS[plan.loop]
    capacity = N_SM * lp.blocks_per_sm
    base = math.ceil(R / lp.rows) * B
    tiles = math.ceil(S / lp.tile)
    blocks = _blocks(B, R, plan)
    if plan.n_split > 1:
        assert blocks <= capacity
    assert plan.n_split == tiles or blocks + base > capacity
    if base <= capacity - 120:
        assert blocks >= min(120, base * tiles)


def test_plan_shapes_of_the_main_path():
    """The splits the kernel's design names (csrc/mla_decode.cu): the ROUTE
    groups of 4096 and 16 384 rows on the 256-row tiles of "group", 256
    rows on group32's 32-row spans."""
    plan = mla_ops.decode_plan
    assert plan(1, 4096, 2048, N_SM) == ("group", 2)       # 128 blocks
    assert plan(1, 16384, 2048, N_SM) == ("group", 1)      # 256 blocks
    assert plan(1, 256, 2048, N_SM) == ("group32", 33)     # 132 blocks
    assert _blocks(2, 16, plan(2, 16, 2056, N_SM)) >= 120


@pytest.mark.parametrize("R", [1, 16, 63, 64, 65, 4096])
@pytest.mark.parametrize("B", [1, 2, 3, 60])
def test_group_loop_exactly_from_64_rows(B, R):
    plan = mla_ops.decode_plan(B, R, 2048, N_SM)
    assert (plan.loop in ("group", "group32")) == (R >= 64)
    assert plan == mla_ops.loop_plan(plan.loop, B, R, 2048, N_SM)


@pytest.mark.parametrize("B,R,S", [s for s in SHAPES if s[1] < 64])
def test_16_row_loop_is_the_one_whose_busiest_sm_walks_fewer_rows(B, R, S):
    """decode_plan's rule below 64 rows: attend16 on a tie, unless its spans
    outnumber the SMs."""
    plans = {name: mla_ops.loop_plan(name, B, R, S, N_SM)
             for name in ("tiled16", "attend16")}
    rows = {name: mla_ops.busiest_sm_rows(p, B, R, S, N_SM)
            for name, p in plans.items()}
    tie_to_tiled = (rows["tiled16"] == rows["attend16"]
                    and plans["attend16"].n_split > N_SM)
    want = ("tiled16" if rows["tiled16"] < rows["attend16"] or tie_to_tiled
            else "attend16")
    assert mla_ops.decode_plan(B, R, S, N_SM).loop == want


# (B, R, S) -> loop: the 16-row shapes of chip_smoke.py phase 3, where the
# rule picks the loop the card timed faster (PERF.md, the 16-row rule; at
# (1, 16, 8192) a tie whose attend16 merges 256 spans, tiled16 132)
@pytest.mark.parametrize("B,R,S,loop", [
    (1, 16, 2048, "tiled16"), (2, 16, 2056, "attend16"),
    (3, 16, 2048, "tiled16"), (4, 16, 2048, "attend16"),
    (16, 16, 2048, "attend16"), (1, 48, 2048, "tiled16"),
    (2, 16, 520, "tiled16"), (1, 16, 8192, "tiled16")])
def test_16_row_loop_of_the_timed_shapes(B, R, S, loop):
    assert mla_ops.decode_plan(B, R, S, N_SM).loop == loop


@pytest.mark.parametrize("B,R,S", [(1, 16, 8192), (2, 16, 8192),
                                   (1, 16, 16384), (4, 16, 2048),
                                   (2, 16, 2056), (16, 16, 2048)])
def test_16_row_tie_goes_to_tiled16_past_one_span_an_sm(B, R, S):
    """On a tie of busiest-SM rows, attend16 merges its spans in every
    block of a row tile: past n_sm spans tiled16, whose split stops at
    n_sm, merges fewer."""
    tiled, attend = (mla_ops.loop_plan(name, B, R, S, N_SM)
                     for name in ("tiled16", "attend16"))
    assert (mla_ops.busiest_sm_rows(tiled, B, R, S, N_SM)
            == mla_ops.busiest_sm_rows(attend, B, R, S, N_SM))
    want = "tiled16" if attend.n_split > N_SM else "attend16"
    assert mla_ops.decode_plan(B, R, S, N_SM).loop == want
    assert tiled.n_split <= N_SM


GROUP_SHAPES = [(1, 64, 2048), (1, 256, 2048), (1, 512, 2048),
                (1, 1024, 2048), (1, 4096, 2048), (1, 16384, 2048),
                (2, 256, 2048), (1, 256, 8192), (3, 64, 2048), (4, 64, 5000),
                (1, 65536, 8), (1, 640, 300)]


@pytest.mark.parametrize("B,R,S", GROUP_SHAPES)
def test_group_loop_is_the_one_whose_busiest_sm_does_less_work(B, R, S):
    """decode_plan's rule from 64 rows: the group loop whose busiest SM
    walks fewer query-row x cache-row pairs, "group" on a tie."""
    work = {name: mla_ops.busiest_sm_rows(
                mla_ops.loop_plan(name, B, R, S, N_SM), B, R, S, N_SM)
            * mla_ops.LOOPS[name].rows for name in ("group", "group32")}
    assert work == {name: mla_ops.busiest_sm_work(
        mla_ops.loop_plan(name, B, R, S, N_SM), B, R, S, N_SM)
        for name in ("group", "group32")}
    want = "group32" if work["group32"] < work["group"] else "group"
    assert mla_ops.decode_plan(B, R, S, N_SM).loop == want


def test_group_loop_geometry():
    """The group loop: 64 query rows over 256-row cache tiles, one block an
    SM (csrc/decode_group.cuh); group32 the same rows over 32-row tiles
    (csrc/decode_tiled.cuh Group32); their codes in the C entries."""
    assert mla_ops.LOOPS["group"] == (0, 64, 256, 1)
    assert mla_ops.LOOPS["group32"] == (3, 64, 32, 1)
    assert mla_ops.LOOPS["tiled16"] == (1, 16, 16, 1)
    assert mla_ops.LOOPS["attend16"] == (2, 16, 32, 2)


# (B, R, S, loop) -> (n_split, busiest-SM cache rows): the group loops'
# split and the cache rows the busiest SM walks, by hand: 4096 rows are 64
# row tiles, two spans of 4 256-row tiles fill 128 SMs; 16 384 rows are 256
# row tiles, two a busiest SM, each over all 8 tiles; 256 rows are 4 row
# tiles, group32 cuts 64 tiles into 33 spans (132 blocks, 2 tiles the
# longest), group 8 tiles into 8 spans (32 blocks, 1 tile each)
@pytest.mark.parametrize("B,R,S,loop,n,rows", [
    (1, 4096, 2048, "group", 2, 1024), (1, 4096, 2048, "group32", 2, 1024),
    (1, 16384, 2048, "group", 1, 4096),
    (1, 16384, 2048, "group32", 1, 4096),
    (1, 256, 2048, "group", 8, 256), (1, 256, 2048, "group32", 33, 64),
    (1, 1024, 2048, "group", 8, 256), (1, 1024, 2048, "group32", 8, 256)])
def test_group_loop_spans_and_busiest_sm(B, R, S, loop, n, rows):
    plan = mla_ops.loop_plan(loop, B, R, S, N_SM)
    assert plan.n_split == n
    assert mla_ops.busiest_sm_rows(plan, B, R, S, N_SM) == rows
    spans = decode_spans(plan, S)
    assert all((e - b) <= math.ceil(math.ceil(S / mla_ops.LOOPS[loop].tile)
                                    / n) * mla_ops.LOOPS[loop].tile
               for b, e in spans)


@pytest.mark.parametrize("B,R,S,lengths", [
    (1, 16, 2048, None), (2, 16, 2056, None), (3, 64, 2048, (2048, 1000, 0)),
    (1, 65, 700, None), (2, 16, 300, (77, 0)), (1, 8, 2048, (40,)),
    (2, 128, 256, (256, 31)), (4, 16, 2048, (2048, 1000, 517, 0))])
def test_merged_span_partials_equal_the_whole(B, R, S, lengths):
    """The plain partial of every span (an empty one included: past a row's
    length, or the whole of a length-0 row), merged by softmax_merge_ref in
    slot order, equals mla_decode_ref over the whole cache."""
    rng = np.random.default_rng(B * 1000 + R + S)
    D, d_v, scale = 64, 48, 1 / math.sqrt(192)
    q = torch.tensor(rng.standard_normal((B, R, D)).astype(np.float32))
    ckv = torch.tensor(rng.standard_normal((B, S, D)).astype(np.float32))
    lens = None if lengths is None else torch.tensor(lengths,
                                                     dtype=torch.int32)
    plan = mla_ops.decode_plan(B, R, S, N_SM)
    assert plan.n_split > 1
    o, m, l = [], [], []
    empty = 0
    for z in range(plan.n_split):
        po, pm, pl = [], [], []
        for b in range(B):
            begin, stop = decode_spans(
                plan, S, None if lengths is None else lengths[b])[z]
            n = max(0, stop - begin)
            empty += n == 0
            part = mla_decode_ref(
                q[b:b + 1], ckv[b:b + 1, begin:begin + max(n, 1)],
                torch.tensor([n], dtype=torch.int32), d_v, scale)
            po.append(part.o)
            pm.append(part.m)
            pl.append(part.l)
        o.append(torch.cat(po))
        m.append(torch.cat(pm))
        l.append(torch.cat(pl))
    got = softmax_merge_ref(torch.stack(o), torch.stack(m), torch.stack(l))
    want = mla_decode_ref(q, ckv, lens, d_v, scale)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    if lengths is not None:
        assert empty > 0
        for b, n in enumerate(lengths):
            if n == 0:
                assert bool((got.o[b] == 0).all())
                assert bool(torch.isneginf(got.m[b]).all())
                assert bool((got.l[b] == 0).all())


# split_plan, for the f32 (F32_PLAN) and bf16 (BF16_PLAN) flash_prefill
# kernels, its two callers: the results of the parent tree
SPLIT_PLAN_PINS = [
    ((1, 16, 2048), (64, 32), (128, 16)),
    ((1, 256, 2048), (64, 32), (128, 16)),
    ((1, 4096, 2048), (1024, 2), (1024, 2)),
    ((3, 16, 2048), (64, 32), (128, 16)),
    ((1, 16, 512), (64, 8), (128, 4)),
    ((1, 16, 2080), (96, 22), (192, 11)),
    ((2, 16, 2056), (96, 22), (192, 11)),
    ((1, 32768, 2048), (2048, 1), (2048, 1)),
    ((1, 640, 300), (64, 5), (192, 2)),
    ((2, 308, 101), (64, 2), (128, 1)),
    ((12, 16, 2048), (192, 11), (192, 11)),
    ((1, 16, 1), (32, 1), (64, 1)),
]


@pytest.mark.parametrize("shape,f32,bf16", SPLIT_PLAN_PINS)
def test_split_plan_is_pinned_for_its_callers(shape, f32, bf16):
    assert mla_ops.split_plan(*shape, N_SM, **fp_ops.F32_PLAN) == f32
    assert mla_ops.split_plan(*shape, N_SM, **fp_ops.BF16_PLAN) == bf16
