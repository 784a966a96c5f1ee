"""The plan of the sparse_select kernel (repro_torch.kernels.sparse_select
.ops.select_plan), on the CPU: which of mla_decode's loops a call takes,
how the T = KB * block_tokens selected positions are split into spans
(csrc/decode_launch.cuh span_of), and that the spans' plain partials
merged in slot order are the whole selected attention.

Tolerance: the merged spans against sparse_select_ref, 1e-6 absolute and
relative in f32 (the same logits, summed over the spans in another
order).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.mla_decode import ops as mla_ops
from repro_torch.kernels.softmax_merge import softmax_merge_ref
from repro_torch.kernels.sparse_select import ops as sel_ops
from repro_torch.kernels.sparse_select import sparse_select_ref

N_SM = 132                # the H100 SXM's SMs


def select_spans(plan, T, end):
    """[begin, end) of each span of a batch row whose selection ends at
    position `end` (kb[b] * bt): the test's model of span_of in
    csrc/decode_launch.cuh, which cuts span z as tiles [z n_t / n, (z + 1)
    n_t / n) of the n_t tiles of T and ends it at the row's end; begin >=
    end is an empty span (the identity)."""
    tile, n = mla_ops.LOOPS[plan.loop].tile, plan.n_split
    tiles = math.ceil(T / tile)
    return [((z * tiles // n) * tile, min(end, ((z + 1) * tiles // n) * tile))
            for z in range(n)]


# (tag, B, R, KB, block_tokens) -> (loop, n_split): a serve request at
# m_q = 1, 4, 8, 16 over 8 selected 64-token blocks, 16-, 64- and
# 256-request groups over all 32 blocks (group32's 32-row tiles, then the
# group loop's 256-row tiles), model (b)'s selection decode (512 token ids, B = 2), a
# ragged batch, and absorbed_partial's per-row masks (R = 1 a batch row):
# 40 rows split, 300 rows unsplit
PLAN_SHAPES = {
    "serve m_q=1": ((1, 16, 8, 64), ("tiled16", 32)),
    "serve m_q=4": ((1, 64, 8, 64), ("group32", 16)),
    "serve m_q=8": ((1, 128, 8, 64), ("group32", 16)),
    "serve m_q=16": ((1, 256, 8, 64), ("group32", 16)),
    "R=256 kb=32": ((1, 256, 32, 64), ("group32", 33)),
    "R=1024 kb=32": ((1, 1024, 32, 64), ("group", 8)),
    "R=4096 kb=32": ((1, 4096, 32, 64), ("group", 2)),
    "model (b)": ((2, 16, 512, 1), ("tiled16", 32)),
    "ragged": ((3, 16, 8, 64), ("tiled16", 32)),
    "per-row 40": ((40, 1, 60, 1), ("attend16", 2)),
    "per-row 300": ((300, 1, 60, 1), ("attend16", 1)),
}


@pytest.mark.parametrize("tag", sorted(PLAN_SHAPES))
def test_plan_of_the_main_path_shapes(tag):
    (B, R, KB, bt), want = PLAN_SHAPES[tag]
    plan = sel_ops.select_plan(B, R, KB, bt, N_SM)
    assert tuple(plan) == want
    assert plan == mla_ops.decode_plan(B, R, KB * bt, N_SM)
    lp = mla_ops.LOOPS[plan.loop]
    blocks = math.ceil(R / lp.rows) * B * plan.n_split
    if plan.n_split > 1:                  # a cooperative launch fits
        assert blocks <= N_SM * lp.blocks_per_sm


def test_one_request_fills_the_card_with_one_tile_a_span():
    """One serve request over 8 blocks: 32 spans of one 16-row tile; model
    (b)'s two sequences: 64 blocks."""
    plan = sel_ops.select_plan(1, 16, 8, 64, N_SM)
    assert plan == ("tiled16", 32)
    assert all(stop - begin == 16
               for begin, stop in select_spans(plan, 512, 512))
    plan = sel_ops.select_plan(2, 16, 512, 1, N_SM)
    assert 2 * plan.n_split == 64


@pytest.mark.parametrize("tag", sorted(PLAN_SHAPES))
def test_every_selected_position_is_covered_once(tag):
    """Whatever a row's kb (all, part of it, none), its spans cover each of
    its kb * bt positions exactly once and none past them."""
    (B, R, KB, bt), _ = PLAN_SHAPES[tag]
    plan = sel_ops.select_plan(B, R, KB, bt, N_SM)
    T = KB * bt
    for kb in sorted({KB, KB - 1, KB // 3, 1, 0}):
        end = max(0, kb) * bt
        spans = select_spans(plan, T, end)
        assert len(spans) == plan.n_split
        seen = np.zeros(T, np.int64)
        for begin, stop in spans:
            seen[begin:max(begin, stop)] += 1
        assert (seen[:end] == 1).all() and (seen[end:] == 0).all()


# (B, R, S, block ids per row, kb per row or None, block_tokens): a serve
# request over 8 of 32 blocks, a ragged batch with a tail block past the
# chunk's end and a kb = 0 row, token-level selection at model (b)'s B = 2,
# per-row masks at R = 1 with a kb = 0 row, a 64-row request over every
# block, and ids past the row's kb that must not count
MERGE_CASES = {
    "serve": (1, 16, 2048, [[1, 4, 5, 9, 17, 20, 28, 31]], None, 64),
    "ragged": (3, 16, 2080, [[0, 3, 7, 9, 12, 20, 31, 32],
                             [32, 5, 1, 0, 0, 0, 0, 0], [0] * 8],
               [8, 3, 0], 64),
    "model_b": (2, 16, 90, [[(i * 7 + b) % 90 for i in range(64)]
                            for b in range(2)], None, 1),
    "per_row": (5, 1, 50, [[(i * 3 + b) % 50 for i in range(40)]
                           for b in range(5)], [40, 7, 1, 33, 0], 1),
    "group": (1, 64, 256, [list(range(4))], None, 64),
    "past_kb": (2, 16, 256, [[3, 0, 2, 1], [1, 2, 3, 0]], [2, 4], 64),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merged_span_partials_equal_the_whole(case):
    """The plain partial of every span (sparse_select_ref over the span's
    positions of the block table at block_tokens = 1, an empty span the
    identity), merged by softmax_merge_ref in slot order, equals
    sparse_select_ref over the whole selection."""
    B, R, S, ids, kb, bt = MERGE_CASES[case]
    rng = np.random.default_rng(B * 1000 + R + S)
    D, d_v, scale = 64, 48, 1 / math.sqrt(192)
    q = torch.tensor(rng.standard_normal((B, R, D)).astype(np.float32))
    ckv = torch.tensor(rng.standard_normal((B, S, D)).astype(np.float32))
    idx = torch.tensor(ids, dtype=torch.int32)
    kbt = None if kb is None else torch.tensor(kb, dtype=torch.int32)
    KB = idx.shape[1]
    T = KB * bt
    plan = sel_ops.select_plan(B, R, KB, bt, N_SM)
    assert plan.n_split > 1
    # the position -> cache row map of each batch row, -1 for none
    t = np.arange(T)
    rows = [np.where(np.asarray(ids[b])[t // bt] >= 0,
                     np.asarray(ids[b])[t // bt] * bt + t % bt, -1)
            for b in range(B)]
    o, m, l = [], [], []
    empty = 0
    for z in range(plan.n_split):
        po, pm, pl = [], [], []
        for b in range(B):
            end = (KB if kb is None else kb[b]) * bt
            begin, stop = select_spans(plan, T, end)[z]
            pos = rows[b][begin:max(begin, stop)]
            empty += pos.size == 0
            part = sparse_select_ref(
                q[b:b + 1], ckv[b:b + 1],
                torch.tensor(pos[None] if pos.size else [[-1]],
                             dtype=torch.int32), None, None, d_v, 1, scale)
            po.append(part.o)
            pm.append(part.m)
            pl.append(part.l)
        o.append(torch.cat(po))
        m.append(torch.cat(pm))
        l.append(torch.cat(pl))
    got = softmax_merge_ref(torch.stack(o), torch.stack(m), torch.stack(l))
    want = sparse_select_ref(q, ckv, idx, kbt, None, d_v, bt, scale)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    if kb is not None:
        assert empty > 0
        for b, n in enumerate(kb):
            if n == 0:
                assert bool((got.o[b] == 0).all())
                assert bool(torch.isneginf(got.m[b]).all())
                assert bool((got.l[b] == 0).all())


def test_wrapper_refuses_what_the_loops_cannot_take():
    """D > 576 or d_v % 4 != 0 raise, naming the limit, before any launch
    (the wrapper's CUDA checks, called on CPU tensors of those shapes); no
    caller passes either."""
    q = torch.zeros(1, 16, 580)
    with pytest.raises(ValueError, match="D <= 576"):
        sel_ops._check_cuda(q, torch.zeros(1, 64, 580),
                            torch.zeros(1, 1, dtype=torch.int32), None, None,
                            512, 64)
    q = torch.zeros(1, 16, 576)
    with pytest.raises(ValueError, match="d_v % 4 == 0"):
        sel_ops._check_cuda(q, torch.zeros(1, 64, 576),
                            torch.zeros(1, 1, dtype=torch.int32), None, None,
                            510, 64)
