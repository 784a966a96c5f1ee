"""Card-only tests of the port (marker `gpu`): each hand-written kernel
against its plain PyTorch version on the card, at main-path shapes, and the
exec backend through all three kernels. They skip, with the reason, where
no CUDA card is present; on the card run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances (f32): mla_decode, sparse_select and flash_prefill 1e-5
absolute and relative (another summation order over the attended rows and
D); softmax_merge 1e-6 (it rounds as the plain version does);
delta_rotate (the band entry and the splice, f32 and bf16) bit for bit;
ssd_chunk 1e-4 absolute and relative (tests/test_ssd_kernel.py:26-29: the
gated products and the state sums in another order, with outputs of
order 10-100). flash_prefill with bf16 operands (its tensor-core kernel)
2e-2 absolute and relative against the plain version on the same bf16
inputs: the kernel rounds P to bf16 before the PV product, <= 2^-9
relative per weight, where the plain version keeps P in f32; that stays
under the reference's own bf16 5e-2 (tests/test_kernels.py:50)."""

import math
import warnings

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100: see the module "
                    "docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, atol, rtol=0.0):
    torch.cuda.synchronize()
    same = got == want
    assert bool((same | ((got - want).abs()
                         <= atol + rtol * want.abs())).all())


def _decode_inputs(dev, B, R, S, lengths):
    g = torch.Generator(device=dev).manual_seed(R + S)
    q = torch.randn((B, R, 576), device=dev, generator=g)
    ckv = torch.randn((B, S, 576), device=dev, generator=g)
    lens = None if lengths is None else torch.tensor(
        lengths, dtype=torch.int32, device=dev)
    return q, ckv, lens


# (B, R, S, lengths): a single request, ROUTE groups of 256, 4096 and
# 16 384 rows (the golden's four 1024-row requests), the group loop's edges
# at 63 / 64 / 65 rows, model decode (B = 2 x 16 rows over 2056 slots),
# ragged lengths with an empty row in each loop (tiled16, group, attend16),
# the group loop split over a short cache at B = 2
@pytest.mark.parametrize("B,R,S,lengths", [
    (1, 16, 2048, None), (1, 256, 2048, None), (1, 4096, 2048, None),
    (3, 16, 2048, (2048, 1000, 0)), (1, 40, 300, None),
    (1, 63, 2048, None), (1, 64, 2048, None), (1, 65, 2048, None),
    (1, 16384, 2048, None), (2, 16, 2056, None),
    (3, 64, 2048, (2048, 1000, 0)), (4, 16, 2048, (2048, 1000, 517, 0)),
    (2, 96, 300, (300, 0))])
def test_mla_decode_kernel_matches_plain(dev, B, R, S, lengths):
    from repro_torch.kernels.mla_decode import mla_decode, mla_decode_ref
    q, ckv, lens = _decode_inputs(dev, B, R, S, lengths)
    before = mla_decode.launches
    got = mla_decode(q, ckv, lens, d_v=512, scale=1 / math.sqrt(192))
    assert mla_decode.launches == before + 1
    want = mla_decode_ref(q, ckv, lens, 512, 1 / math.sqrt(192))
    for a, b in zip(got, want):
        _close(a, b, 1e-5, 1e-5)
    if lengths is not None:
        assert bool((got.o[-1] == 0).all())
        assert bool((got.l[-1] == 0).all())
        assert bool(torch.isneginf(got.m[-1]).all())


@pytest.mark.parametrize("B,R,S", [(1, 16, 2048), (2, 16, 2056),
                                   (1, 256, 2048), (1, 4096, 2048)])
def test_mla_decode_two_calls_are_bit_identical(dev, B, R, S):
    """The spans merge in slot order, never in order of arrival."""
    from repro_torch.kernels.mla_decode import mla_decode
    q, ckv, _ = _decode_inputs(dev, B, R, S, None)
    first = mla_decode(q, ckv, d_v=512, scale=1 / math.sqrt(192))
    second = mla_decode(q, ckv, d_v=512, scale=1 / math.sqrt(192))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("M", [1, 2, 4, 8])
def test_softmax_merge_kernel_matches_plain(dev, M):
    from repro_torch.kernels.softmax_merge import (softmax_merge,
                                                   softmax_merge_ref)
    g = torch.Generator(device=dev).manual_seed(M)
    o = torch.randn((M, 16, 16, 512), device=dev, generator=g)
    m = 3 * torch.randn((M, 16, 16), device=dev, generator=g)
    l = 1 + 100 * torch.rand((M, 16, 16), device=dev, generator=g)
    m[0, :8], l[0, :8], o[0, :8] = -math.inf, 0.0, 0.0
    got = softmax_merge(o, m, l)
    want = softmax_merge_ref(o, m, l)
    for a, b in zip(got, want):
        _close(a, b, 1e-6, 1e-6)


@pytest.mark.parametrize("delta", [0, 1, 17, 4095])
def test_delta_rotate_kernel_matches_plain(dev, delta):
    """The band-only entry on ckv[:, 512:] of 576-wide rows, f32 and bf16:
    bit for bit the plain version, one launch a call."""
    from repro_torch.kernels.delta_rotate import (delta_cos_sin, delta_rotate,
                                                  delta_rotate_ref)
    g = torch.Generator(device=dev).manual_seed(delta)
    cos, sin = delta_cos_sin(delta, 64)
    for dtype in (torch.float32, torch.bfloat16):
        ckv = torch.randn((2048, 576), device=dev, generator=g).to(dtype)
        moved = torch.empty_like(ckv)
        before = delta_rotate.launches
        got = delta_rotate(ckv[:, 512:], cos, sin, out=moved[:, 512:])
        assert delta_rotate.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, delta_rotate_ref(ckv[:, 512:], cos, sin))


def _splice_want(src, cos, sin, d_c=512):
    """The plain splice on the card: the latent copied, the band through
    the plain rotation."""
    from repro_torch.kernels.delta_rotate import delta_rotate_ref
    want = src.clone()
    want[..., d_c:] = delta_rotate_ref(src[..., d_c:], cos, sin)
    return want


@pytest.mark.parametrize("path", ["vec16", "scalar"])
@pytest.mark.parametrize("S", [0, 1, 37, 2048])
@pytest.mark.parametrize("delta", [0, 1, 17, 4095])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_splice_kernel_matches_plain(dev, dtype, delta, S, path):
    """splice_rotate over S rows of 576: the 16-byte path on an aligned
    source, the one-element path on a source one element off alignment
    (a storage offset of one); bit for bit the plain splice, the source
    unchanged, one launch a call (none for S = 0)."""
    from repro_torch.kernels.delta_rotate import ops as rot_ops
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    g = torch.Generator(device=dev).manual_seed(S + delta)
    flat = torch.randn((S * 576 + 1,), device=dev, generator=g).to(dt)
    off = 1 if path == "scalar" else 0
    src = flat[off:off + S * 576].view(S, 576)
    kept = src.clone()
    cos, sin = rot_ops.delta_cos_sin(delta, 64)
    plan = rot_ops.launch_plan(src, torch.empty_like(src), 512)
    assert plan.vec == (path == "vec16") or S == 0    # no rows, no path
    before = rot_ops.delta_rotate.launches
    got = rot_ops.splice_rotate(src, cos, sin, 512)
    assert rot_ops.delta_rotate.launches == before + (1 if S else 0)
    torch.cuda.synchronize()
    assert torch.equal(got, _splice_want(src, cos, sin))
    assert torch.equal(src, kept)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_splice_kernel_stack_and_pool(dev, dtype):
    """splice_delta_rotate over V2-Lite's 27 layers of a 2048-token chunk
    in one launch, and into rows of a pool (its other rows untouched), bit
    for bit the plain splice; no other device kernel."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA as cfg
    from repro_torch.core.splice import splice_delta_rotate
    from repro_torch.kernels.delta_rotate import ops as rot_ops
    g = torch.Generator(device=dev).manual_seed(27)
    stack = torch.randn((27, 2048, 576), device=dev, generator=g).to(dtype)
    kept = stack.clone()
    cos, sin = rot_ops.delta_cos_sin(17, 64)
    splice_delta_rotate(stack[0], 17, cfg)               # warm the build
    torch.cuda.synchronize()
    before = rot_ops.delta_rotate.launches
    with warnings.catch_warnings():
        # torch's notice that a profiler cycle clears its events
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = splice_delta_rotate(stack, 17, cfg)
            torch.cuda.synchronize()
    assert rot_ops.delta_rotate.launches == before + 1
    kernels = [e.key for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0]
    assert len(kernels) == 1 and "splice_kernel" in kernels[0], kernels
    assert torch.equal(got, _splice_want(stack, cos, sin))
    assert torch.equal(stack, kept)
    pool = torch.randn((3 * 2048, 576), device=dev, generator=g).to(dtype)
    pool_kept = pool.clone()
    dst = pool[2048:4096]
    assert splice_delta_rotate(stack[3], 4095, cfg, out=dst) is dst
    torch.cuda.synchronize()
    assert torch.equal(dst, _splice_want(stack[3], *rot_ops.delta_cos_sin(
        4095, 64)))
    assert torch.equal(pool[:2048], pool_kept[:2048])
    assert torch.equal(pool[4096:], pool_kept[4096:])


def test_exec_backend_runs_the_kernels(dev):
    from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA
    from repro_torch.kernels.delta_rotate import ops as rot_ops
    from repro_torch.kernels.mla_decode import ops as mla_ops
    from repro_torch.kernels.softmax_merge import ops as merge_ops
    from repro_torch.serving.backends.torch_exec import (TorchExecBackend,
                                                         max_oracle_err)
    from repro_torch.serving.engine import Request, ServingEngine
    counters = (mla_ops.mla_decode, merge_ops.softmax_merge,
                rot_ops.delta_rotate)
    before = [fn.launches for fn in counters]
    eng = ServingEngine(4, pool_tokens=10**6,
                        backend=TorchExecBackend(V2_LITE_MLA))
    eng.register_chunk("doc", holder=1, length=2048)
    eng.register_chunk("hot", holder=2, length=2048)
    reqs = [Request(0, home=0, chunk_ids=["doc"], m_q=1,
                    expected_reuse_steps=100_000),
            Request(1, home=3, chunk_ids=["doc", "hot"], m_q=4)]
    eng.schedule_step(reqs)
    assert max_oracle_err(eng, reqs, 1) <= 1e-5
    assert all(fn.launches > b for fn, b in zip(counters, before))
    assert "fetch" in {r.primitive for r in eng.log}   # the splice ran


# (R, S, block ids per row, kb per row or None, block_tokens): one request
# (m_q = 1, R = 16), m_q = 4 (R = 64) and a 16-request group (R = 256) over
# 8 and all 32 blocks of a 2048-token chunk, a ragged batch with an empty
# row and a selected tail block of a 2080-token chunk, token-level
# selection of 37 scattered rows, model (b)'s selection decode (B = 2
# sequences of 16 heads, 512 token ids of a 522-slot cache), and the
# per-row masks of absorbed_partial (R = 1 a batch row, ragged kb ending in
# an empty row): 40 rows (a split launch) and 300 rows (an unsplit one)
SPARSE_CASES = {
    "r16_kb8": (16, 2048, [[1, 4, 5, 9, 17, 20, 28, 31]], None, 64),
    "r16_kb32": (16, 2048, [list(range(32))], None, 64),
    "r64_kb8": (64, 2048, [[2, 6, 7, 10, 16, 22, 27, 29]], None, 64),
    "r256_kb8": (256, 2048, [[0, 2, 3, 11, 12, 19, 25, 30]], None, 64),
    "r256_kb32": (256, 2048, [list(range(32))], None, 64),
    "ragged_tail": (16, 2080, [[0, 3, 7, 9, 12, 20, 31, 32], [32, 5, 1] + [0] * 5,
                               [0] * 8], [8, 3, 0], 64),
    "token_level": (16, 2048, [[(i * 331) % 2048 for i in range(37)]], None,
                    1),
    "model_b_bt1": (16, 522, [sorted((i * 97 + b) % 522 for i in range(512))
                              for b in range(2)], None, 1),
    "per_row_r1_b40": (1, 300, [[(i * 7 + b) % 300 for i in range(60)]
                                for b in range(40)],
                       [(b * 13) % 61 for b in range(39)] + [0], 1),
    "per_row_r1_b300": (1, 300, [[(i * 11 + b) % 300 for i in range(60)]
                                 for b in range(300)],
                        [(b * 7) % 61 for b in range(299)] + [0], 1),
}


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_select_kernel_matches_plain(dev, case):
    from repro_torch.kernels.mla_decode import mla_decode_ref
    from repro_torch.kernels.sparse_select import (sparse_select,
                                                   sparse_select_ref)
    R, S, ids, kb, bt = SPARSE_CASES[case]
    B = len(ids)
    g = torch.Generator(device=dev).manual_seed(R + S + bt)
    q = torch.randn((B, R, 576), device=dev, generator=g)
    ckv = torch.randn((B, S, 576), device=dev, generator=g)
    idx = torch.tensor(ids, dtype=torch.int32, device=dev)
    kbt = None if kb is None else torch.tensor(kb, dtype=torch.int32,
                                               device=dev)
    scale = 1 / math.sqrt(192)
    before = sparse_select.launches
    got = sparse_select(q, ckv, idx, kbt, d_v=512, scale=scale,
                        block_tokens=bt)
    assert sparse_select.launches == before + 1
    want = sparse_select_ref(q, ckv, idx, kbt, None, 512, bt, scale)
    for a, b in zip(got, want):
        _close(a, b, 1e-5, 1e-5)
    if kb is not None:
        assert bool((got.o[-1] == 0).all()) and bool((got.l[-1] == 0).all())
        assert bool(torch.isneginf(got.m[-1]).all())
    if len(ids[0]) * bt == S:              # every row selected: dense decode
        dense = mla_decode_ref(q, ckv, None, 512, scale)
        for a, b in zip(got, dense):
            _close(a, b, 1e-5, 1e-5)


@pytest.mark.parametrize("case", ["r16_kb8", "r64_kb8", "r256_kb32",
                                  "ragged_tail", "model_b_bt1",
                                  "per_row_r1_b40"])
def test_sparse_select_two_calls_are_bit_identical(dev, case):
    """The spans merge in slot order inside the launch, never in order of
    arrival."""
    from repro_torch.kernels.sparse_select import sparse_select
    R, S, ids, kb, bt = SPARSE_CASES[case]
    B = len(ids)
    g = torch.Generator(device=dev).manual_seed(R + S + bt)
    q = torch.randn((B, R, 576), device=dev, generator=g)
    ckv = torch.randn((B, S, 576), device=dev, generator=g)
    idx = torch.tensor(ids, dtype=torch.int32, device=dev)
    kbt = None if kb is None else torch.tensor(kb, dtype=torch.int32,
                                               device=dev)
    first, second = (sparse_select(q, ckv, idx, kbt, d_v=512,
                                   scale=1 / math.sqrt(192), block_tokens=bt)
                     for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _merge_inputs(dev, M, m_q, d_v):
    """M partials of (m_q, 16, d_v) with identity slots: slot 0 empty for
    half the rows, every slot empty for one row."""
    g = torch.Generator(device=dev).manual_seed(M * 100 + m_q + d_v)
    o = torch.randn((M, m_q, 16, d_v), device=dev, generator=g)
    m = 3 * torch.randn((M, m_q, 16), device=dev, generator=g)
    l = 1 + 100 * torch.rand((M, m_q, 16), device=dev, generator=g)
    m[0, :, :8], l[0, :, :8], o[0, :, :8] = -math.inf, 0.0, 0.0
    m[:, 0, 0], l[:, 0, 0], o[:, 0, 0] = -math.inf, 0.0, 0.0
    return o, m, l


@pytest.mark.parametrize("M", [1, 2, 4, 16, 17, 40])
@pytest.mark.parametrize("m_q,d_v", [(1, 512), (16, 512), (3, 30)])
def test_softmax_merge_entries_are_bit_identical_to_plain(dev, M, m_q, d_v):
    """Both entries of the merge kernel equal the plain version on the card
    bit for bit, and each other: the stacked entry at every M (past 16 its
    slot loop), the in-place entry up to its 16 slots, at a serve request's
    rows and at a d_v that takes the kernel's scalar path."""
    from repro_torch.kernels.softmax_merge import (softmax_merge,
                                                   softmax_merge_parts,
                                                   softmax_merge_ref)
    from repro_torch.core.merge import Partial
    o, m, l = _merge_inputs(dev, M, m_q, d_v)
    want = softmax_merge_ref(o, m, l)
    before = softmax_merge.launches
    got = softmax_merge(o, m, l)
    assert softmax_merge.launches == before + 1
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if M <= 16:
        parts = [Partial(o[i].clone(), m[i].clone(), l[i].clone())
                 for i in range(M)]
        in_place = softmax_merge_parts(parts)
        assert softmax_merge.launches == before + 2
        torch.cuda.synchronize()
        for a, b in zip(in_place, want):
            assert torch.equal(a, b)


def test_masked_partial_runs_sparse_select(dev):
    from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA
    from repro_torch.kernels.sparse_select import ops as sel_ops
    from repro_torch.models.mla import absorbed_partial, absorbed_partial_ref
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((2, 16, 576), device=dev, generator=g)
    ckv = torch.randn((300, 576), device=dev, generator=g)
    mask = torch.rand((2, 16, 300), device=dev, generator=g) < 0.2
    before = sel_ops.sparse_select.launches
    got = absorbed_partial(V2_LITE_MLA, q, ckv, mask)
    assert sel_ops.sparse_select.launches == before + 1
    want = absorbed_partial_ref(V2_LITE_MLA, q, ckv, mask)
    for a, b in zip(got, want):
        _close(a, b, 1e-5, 1e-5)


def test_exec_backend_runs_the_selection_regime(dev):
    from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA
    from repro_torch.kernels.sparse_select import ops as sel_ops
    from repro_torch.serving.backends.torch_exec import (TorchExecBackend,
                                                         max_oracle_err)
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.selection import IndexerService
    from repro_torch.kernels.softmax_merge import softmax_merge
    before = sel_ops.sparse_select.launches
    eng = ServingEngine(4, pool_tokens=10**6, instances_per_pod=2,
                        backend=TorchExecBackend(V2_LITE_MLA),
                        selector=IndexerService(mla=V2_LITE_MLA))
    eng.register_chunk("a", holder=1, length=2048)
    eng.register_chunk("b", holder=2, length=2080)
    reqs = [Request(0, home=0, chunk_ids=["a", "b"], m_q=4, k_selected=512),
            Request(1, home=3, chunk_ids=["b"], m_q=1, k_selected=128),
            Request(2, home=3, chunk_ids=["a"], m_q=8)]
    for _ in range(2):
        merges = softmax_merge.launches
        eng.schedule_step(reqs)
        # one merge launch per merged request, its partials read in place
        assert softmax_merge.launches - merges == len(
            eng.outputs_of(eng.step_idx)) == len(reqs)
        assert eng.plans[-1].selections
        assert max_oracle_err(eng, reqs, eng.step_idx) <= 1e-5
    assert sel_ops.sparse_select.launches > before


# (B, Sq, Sk, H): a V2-Lite sequence, a tail-aligned chunk of it, a ragged
# length, a short prefill (its cache span split across blocks) and heads
# that do not fill a 16-row block; the f32 kernel's tile edges: 65 and 127
# positions (one row past a 64-row block of four positions; a last block
# of three, its cache span ending one row short of a 32-row tile), and
# H = 3, where a position's rows straddle two warps' 16-row score tiles and
# the diagonal cache tile is masked differently in each
PREFILL_CASES = {"full": (1, 2048, 2048, 16), "tail": (1, 256, 2048, 16),
                 "ragged": (2, 2000, 2000, 16), "short": (1, 40, 300, 16),
                 "h4": (2, 77, 101, 4), "edge65": (1, 65, 65, 16),
                 "edge127": (1, 127, 127, 16), "h3": (1, 50, 70, 3)}


# (atol, rtol) of flash_prefill's kernel by operand dtype (module docstring)
PREFILL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}


@pytest.mark.parametrize("dtype", sorted(PREFILL_TOL))
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_flash_prefill_kernel_matches_plain(dev, case, dtype):
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_ref)
    B, Sq, Sk, H = PREFILL_CASES[case]
    g = torch.Generator(device=dev).manual_seed(Sq + Sk)
    dt = getattr(torch, dtype)
    q = torch.randn((B, Sq, H, 576), device=dev, generator=g).to(dt)
    ckv = torch.randn((B, Sk, 576), device=dev, generator=g).to(dt)
    before = (flash_prefill.launches, dict(flash_prefill.launches_by_dtype))
    got = flash_prefill(q, ckv, d_v=512, scale=1 / math.sqrt(192))
    assert flash_prefill.launches == before[0] + 1
    assert flash_prefill.launches_by_dtype == {
        k: n + (k == dtype) for k, n in before[1].items()}
    assert got.dtype == torch.float32
    _close(got, flash_prefill_ref(q, ckv, 512, 1 / math.sqrt(192)),
           *PREFILL_TOL[dtype])


# (b, nc, Q, H, P, N, hb): mamba2-370m's geometry, a head block that does
# not divide H, and the reference kernel test's small shapes; one head a
# block (the second warp group idle), an odd head block, all 32 heads in
# one block, one chunk per sequence
SSD_CASES = {"mamba2": (1, 16, 128, 32, 64, 128, 4),
             "hb5": (2, 3, 128, 32, 64, 128, 5),
             "small": (2, 2, 32, 8, 16, 32, 8), "odd": (1, 2, 24, 6, 12, 20, 4),
             "hb1": (1, 2, 128, 32, 64, 128, 1),
             "hb3": (1, 2, 128, 32, 64, 128, 3),
             "hb32": (1, 2, 128, 32, 64, 128, 32),
             "nc1": (2, 1, 128, 32, 64, 128, 4)}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_chunk_kernel_matches_plain(dev, case):
    from repro_torch.kernels.ssd_chunk import (ssd_intra_chunk,
                                               ssd_intra_chunk_ref)
    b, nc, Q, H, P, N, hb = SSD_CASES[case]
    g = torch.Generator(device=dev).manual_seed(Q + H)
    x = torch.randn((b, nc, Q, H, P), device=dev, generator=g)
    dt = torch.nn.functional.softplus(
        torch.randn((b, nc, Q, H), device=dev, generator=g))
    A = -torch.exp(0.5 * torch.randn((H,), device=dev, generator=g))
    B = torch.randn((b, nc, Q, N), device=dev, generator=g)
    C = torch.randn((b, nc, Q, N), device=dev, generator=g)
    before = ssd_intra_chunk.launches
    got = ssd_intra_chunk(x, dt, A, B, C, hb=hb)
    assert ssd_intra_chunk.launches == before + 1
    for a, w in zip(got, ssd_intra_chunk_ref(x, dt, A, B, C)):
        _close(a, w, 1e-4, 1e-4)


@pytest.mark.parametrize("case", ["full", "short", "h3"])
def test_flash_prefill_two_calls_are_bit_identical(dev, case):
    """The f32 kernel (and the span merge of a short prefill) sums in a
    fixed order: two calls on the same inputs give the same bits."""
    from repro_torch.kernels.flash_prefill import flash_prefill
    B, Sq, Sk, H = PREFILL_CASES[case]
    g = torch.Generator(device=dev).manual_seed(Sq + Sk)
    q = torch.randn((B, Sq, H, 576), device=dev, generator=g)
    ckv = torch.randn((B, Sk, 576), device=dev, generator=g)
    a = flash_prefill(q, ckv, d_v=512, scale=1 / math.sqrt(192))
    b = flash_prefill(q, ckv, d_v=512, scale=1 / math.sqrt(192))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["mamba2", "hb5", "odd"])
def test_ssd_chunk_two_calls_are_bit_identical(dev, case):
    from repro_torch.kernels.ssd_chunk import ssd_intra_chunk
    b, nc, Q, H, P, N, hb = SSD_CASES[case]
    g = torch.Generator(device=dev).manual_seed(Q + H)
    x = torch.randn((b, nc, Q, H, P), device=dev, generator=g)
    dt = torch.nn.functional.softplus(
        torch.randn((b, nc, Q, H), device=dev, generator=g))
    A = -torch.exp(0.5 * torch.randn((H,), device=dev, generator=g))
    B = torch.randn((b, nc, Q, N), device=dev, generator=g)
    C = torch.randn((b, nc, Q, N), device=dev, generator=g)
    first = ssd_intra_chunk(x, dt, A, B, C, hb=hb)
    second = ssd_intra_chunk(x, dt, A, B, C, hb=hb)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite", "mamba2-370m"])
def test_model_smoke_runs_the_kernels(dev, arch):
    """The smoke configs' prefill and decode on the card, kernels against
    the plain ops on the same weights."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    cfg = get_smoke_config(arch)
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab, (2, 32), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    outs = {}
    for name, ops in (("kernels", M.KERNELS), ("plain", M.PLAIN)):
        logits, caches = M.prefill(params, cfg, {"tokens": tok}, ops=ops)
        state = M.fill_decode_state(cfg, M.init_decode_state(
            cfg, 2, 40, dtype=torch.float32, device=dev), caches)
        step, state = M.decode_step(params, cfg, state, tok[:, :1],
                                    torch.full((2, 1), 32, device=dev), 32,
                                    ops=ops)
        outs[name] = (logits, step)
    for a, b in zip(outs["kernels"], outs["plain"]):
        _close(a, b, 1e-4, 1e-4)


# ---------------------------------------------------------------------------
# The instance mesh on the card: one stream per serving instance
# ---------------------------------------------------------------------------

SPIN_CYCLES = 20_000_000      # ~10 ms of a GPU spin on the source's stream


def _mesh(dev, n=8):
    from repro_torch.core.instance_mesh import InstanceMesh
    return InstanceMesh(n, dev)


def test_concurrent_cooperative_launches_on_instance_streams(dev):
    """mla_decode and sparse_select size their split spans to the blocks the
    whole card holds and launch them cooperatively. Eight instances issue a
    single request each at once, on their own streams: every launch runs
    (none is refused as too large, none hangs) and equals the plain
    version, and the same launch on one stream gives the same bits."""
    from repro_torch.kernels.mla_decode import mla_decode, mla_decode_ref
    from repro_torch.kernels.sparse_select import (sparse_select,
                                                   sparse_select_ref)
    mesh = _mesh(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    qs = [torch.randn((1, 16, 576), device=dev, generator=g)
          for _ in range(mesh.n)]
    ckvs = [torch.randn((1, 2048, 576), device=dev, generator=g)
            for _ in range(mesh.n)]
    idx = torch.tensor([[1, 4, 5, 9, 17, 20, 28, 31]], dtype=torch.int32,
                       device=dev)
    torch.cuda.synchronize()
    mesh.begin()
    got = []
    for i in range(mesh.n):
        with mesh.on(i):
            got.append((mla_decode(qs[i], ckvs[i], d_v=512, scale=0.05),
                        sparse_select(qs[i], ckvs[i], idx, d_v=512,
                                      scale=0.05)))
    mesh.synchronize()
    for i, (dense, sel) in enumerate(got):
        want = mla_decode_ref(qs[i], ckvs[i], None, 512, 0.05)
        for a, b in zip(dense, want):
            _close(a, b, 1e-5, 1e-5)
        want = sparse_select_ref(qs[i], ckvs[i], idx, None, None, 512, 64,
                                 0.05)
        for a, b in zip(sel, want):
            _close(a, b, 1e-5, 1e-5)
        alone = mla_decode(qs[i], ckvs[i], d_v=512, scale=0.05)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(dense, alone))


@pytest.mark.parametrize("fused", [True, False], ids=["one_launch", "pull"])
def test_splice_after_a_cross_stream_pull_reads_the_pulled_bytes(dev, fused):
    """The splice launches with programmatic dependent launch, held only by
    the previous kernel in its stream. Here the holder writes the chunk
    behind a spin on its own stream; the requester's splice follows a
    cross-stream event (one launch from the holder's rows) or a copy_ (the
    pull, then the splice in place). Either way it reads the bytes written
    before it: bit for bit the plain splice."""
    from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA as cfg
    from repro_torch.core.splice import fetch_chunk, splice_delta_rotate
    from repro_torch.kernels.delta_rotate import delta_cos_sin
    mesh = _mesh(dev, 4)
    holder, requester = 1, 3
    g = torch.Generator(device=dev).manual_seed(11)
    data = torch.randn((2048, 576), device=dev, generator=g)
    with mesh.on(holder):
        chunk = torch.zeros_like(data)
    with mesh.on(requester):
        pool = torch.full((4096, 576), 7.0, device=dev)
    torch.cuda.synchronize()
    with mesh.on(holder, data):
        torch.cuda._sleep(SPIN_CYCLES)
        chunk.copy_(data)
    if fused:
        fetch_chunk(mesh, pool, chunk, 17, 1024, cfg, holder, requester)
    else:
        fetch_chunk(mesh, pool, chunk, None, 1024, cfg, holder, requester)
        with mesh.on(requester):
            rows = pool[1024:3072]
            splice_delta_rotate(rows, 17, cfg, out=rows)
    mesh.synchronize()
    cos, sin = delta_cos_sin(17, 64)
    assert torch.equal(pool[1024:3072], _splice_want(data, cos.to(dev),
                                                     sin.to(dev)))
    assert bool((pool[:1024] == 7.0).all() and (pool[3072:] == 7.0).all())


def test_merge_after_a_cross_stream_return_reads_the_returned_partials(dev):
    """softmax_merge launches with programmatic dependent launch too. The
    holder's partials are written behind a spin on its stream and return
    to the requester (pairwise_return) and to every home (fanout_exchange,
    copies into identity-filled stacks); the merges that follow them on
    the requesters' streams equal the plain merge bit for bit."""
    from repro_torch.core.merge import Partial
    from repro_torch.core.routing import (fanout_exchange, merge_on,
                                          pairwise_return)
    from repro_torch.kernels.softmax_merge import (softmax_merge_parts,
                                                   softmax_merge_ref)
    mesh = _mesh(dev, 4)
    holder, requester = 2, 0
    g = torch.Generator(device=dev).manual_seed(5)

    def rand_partial(lead):
        return Partial(o=torch.randn(lead + (512,), device=dev, generator=g),
                       m=3 * torch.randn(lead, device=dev, generator=g),
                       l=1 + 100 * torch.rand(lead, device=dev, generator=g))
    src = rand_partial((16, 16))
    local = rand_partial((16, 16))
    stacked = rand_partial((mesh.n, 16, 16))
    with mesh.on(holder):
        held = Partial(*(torch.zeros_like(t) for t in src))
        held_fan = Partial(*(torch.zeros_like(t) for t in stacked))
    torch.cuda.synchronize()
    with mesh.on(holder, *src, *stacked):
        torch.cuda._sleep(SPIN_CYCLES)
        for a, b in zip(held + held_fan, src + stacked):
            a.copy_(b)
    parts = [None] * mesh.n
    parts[holder] = held
    back = pairwise_return(mesh, parts, holder, requester)[requester]
    with mesh.on(requester, *local):
        pair = softmax_merge_parts([local, back])
    parts[holder] = held_fan
    ex = fanout_exchange(mesh, parts, to=[0, 1, 3])
    fan = {h: merge_on(mesh, h, ex[h]) for h in (0, 1, 3)}
    mesh.synchronize()
    want = softmax_merge_ref(*(torch.stack([a, b]) for a, b in zip(local,
                                                                   src)))
    assert all(torch.equal(a, b) for a, b in zip(pair, want))
    for h, got in fan.items():
        want = softmax_merge_ref(*(t[h:h + 1] for t in stacked))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _exec_counters():
    from repro_torch.kernels.delta_rotate import ops as rot_ops
    from repro_torch.kernels.mla_decode import ops as mla_ops
    from repro_torch.kernels.softmax_merge import ops as merge_ops
    from repro_torch.kernels.sparse_select import ops as sel_ops
    return (mla_ops.mla_decode, sel_ops.sparse_select,
            merge_ops.softmax_merge, rot_ops.delta_rotate)


def _mesh_engine(fused, depth=1):
    from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA
    from repro_torch.serving.backends.shard_map import ShardMapExecBackend
    from repro_torch.serving.engine import (EngineConfig, Request,
                                            ServingEngine)
    eng = ServingEngine(4, pool_tokens=10**6,
                        cfg=EngineConfig(pipeline_depth=depth),
                        instances_per_pod=2,
                        backend=ShardMapExecBackend(V2_LITE_MLA,
                                                    fused=fused))
    for i, cid in enumerate(("doc", "hot", "warm")):
        eng.register_chunk(cid, holder=1 + i, length=2048)
    fetchy = Request(0, home=0, chunk_ids=["doc"], m_q=1,
                     expected_reuse_steps=100_000)
    steps = [[fetchy, Request(1, home=3, chunk_ids=["doc", "hot"], m_q=4),
              Request(2, home=0, chunk_ids=["hot", "warm"], m_q=16),
              Request(3, home=1, chunk_ids=["hot"], m_q=2)],
             [fetchy, Request(1, home=3, chunk_ids=["doc", "hot"], m_q=4),
              Request(4, home=2, chunk_ids=["warm"], m_q=8)]] * 2
    return eng, steps


def test_fused_at_pipeline_depth_2_matches_serial(dev):
    """The fused mode with two steps in flight (the caching allocator
    reuses memory across the instances' streams) gives the serial mode's
    outputs, within 1e-6, and meets the oracle."""
    from repro_torch.serving.backends.torch_exec import max_oracle_err
    runs = {}
    for fused, depth in ((True, 2), (False, 1)):
        eng, steps = _mesh_engine(fused, depth)
        for reqs in steps:
            eng.schedule_step(reqs)
        eng.flush()
        for step, reqs in enumerate(steps, start=1):
            assert max_oracle_err(eng, reqs, step) <= 1e-5
        runs[fused] = eng
    assert {"route", "fetch"} <= {r.primitive for r in runs[True].log}
    for step in range(1, len(steps) + 1):
        fo, so = runs[True].outputs_of(step), runs[False].outputs_of(step)
        assert sorted(fo) == sorted(so)
        for rid in fo:
            for a, b in zip(fo[rid], so[rid]):
                _close(a, b, 1e-6)


def test_fused_step_runs_the_kernels_on_several_streams(dev):
    """One fused step under the profiler: mla_decode, sparse_select,
    softmax_merge and delta_rotate all launch (their counters), the
    profiler sees their device kernels (the decode loops mla_decode and
    sparse_select share, merge_kernel, splice_kernel), and the kernels run
    on more than one stream."""
    import json
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.deepseek_v2_lite import V2_LITE_MLA
    from repro_torch.serving.backends.shard_map import ShardMapExecBackend
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.selection import ShardMapIndexerService
    eng = ServingEngine(4, pool_tokens=10**6, instances_per_pod=2,
                        backend=ShardMapExecBackend(V2_LITE_MLA),
                        selector=ShardMapIndexerService(mla=V2_LITE_MLA))
    for i, cid in enumerate(("doc", "hot", "warm")):
        eng.register_chunk(cid, holder=1 + i, length=2048)
    reqs = [Request(0, home=0, chunk_ids=["doc"], m_q=1,
                    expected_reuse_steps=100_000),
            Request(1, home=3, chunk_ids=["doc", "hot"], m_q=4),
            Request(2, home=0, chunk_ids=["hot", "warm"], m_q=2,
                    k_selected=512)]
    eng.schedule_step([Request(9, home=0, chunk_ids=["warm"], m_q=1)])
    torch.cuda.synchronize()
    counters = _exec_counters()
    before = [fn.launches for fn in counters]
    with warnings.catch_warnings():
        # the profiler's notice that it keeps one cycle's events
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.schedule_step(reqs)
            torch.cuda.synchronize()
    assert all(fn.launches > b for fn, b in zip(counters, before))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            kernels = [e for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
    names = " ".join(e["name"] for e in kernels)
    assert "tiled_kernel" in names or "attend_kernel" in names, names
    assert "merge_kernel" in names and "splice_kernel" in names, names
    assert len({e["args"].get("stream") for e in kernels}) > 1


# ---------------------------------------------------------------------------
# The training path on the card
# ---------------------------------------------------------------------------

def _tiny_v2_lite():
    """V2-Lite's shape at smoke width (tests/torch_parity.py's config, in
    the port's classes)."""
    from repro_torch.models.mla import MLAConfig
    from repro_torch.models.model import ModelConfig
    from repro_torch.models.moe import MoEConfig
    return ModelConfig(
        name="v2-lite-tiny", family="moe", n_layers=3, d_model=64,
        vocab=256, attn_type="mla", n_heads=4, n_kv_heads=4,
        mla=MLAConfig(d_model=64, n_heads=4, kv_lora_rank=32,
                      q_lora_rank=None, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        d_ff=128, first_k_dense=1,
        moe=MoEConfig(d_model=64, d_expert=32, n_experts=8, top_k=3,
                      n_shared=2))


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One train step of the tiny V2-Lite shape in f32 (n_micro 2) on the
    card and on the CPU from the same weights and batch: no kernel launched,
    equal routes, the loss, every gradient leaf and the gradient norm within
    1e-4 (atol scaled by the leaf's max |grad|)."""
    import copy
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import model as M
    from repro_torch.models.module import trainable
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import (TrainConfig, loss_and_grads,
                                        make_train_step)
    cfg = _tiny_v2_lite()
    cpu = trainable(M.init_model(cfg, torch.Generator().manual_seed(0),
                                 device="cpu", dtype=torch.float32))
    card = trainable(copy.deepcopy(cpu).to(dev))
    batch = SyntheticPipeline.for_model(cfg, 32, 4, device="cpu").batch_at(0)
    tcfg = TrainConfig(n_micro=2)
    routes = {}
    for name, params in (("cpu", cpu), ("card", card)):
        b = {k: v.to(params.embed.table.device) for k, v in batch.items()}
        routes[name] = []
        M.loss_fn(params, cfg, b, routes=routes[name])
    assert all(torch.equal(a.cpu(), b_) for a, b_ in zip(routes["card"],
                                                          routes["cpu"]))
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    counters = _exec_counters() + (fp_ops.flash_prefill,
                                   ssd_ops.ssd_intra_chunk)
    before = [c.launches for c in counters]
    loss_c, g_c = loss_and_grads(card, cfg, {k: v.to(dev) for k, v in
                                             batch.items()}, tcfg)
    loss_h, g_h = loss_and_grads(cpu, cfg, batch, tcfg)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before
    assert math.isclose(float(loss_c), float(loss_h), rel_tol=1e-4)
    for a, b_ in zip(g_c, g_h):
        tol = 1e-4 * float(b_.abs().max())
        assert bool(((a.cpu() - b_).abs() <= tol + 1e-4 * b_.abs()).all())
    mets = {}
    for name, params, b in (("card", card, {k: v.to(dev) for k, v in
                                            batch.items()}),
                            ("cpu", cpu, batch)):
        ocfg = AdamWConfig(lr=1e-3)
        _, _, m = make_train_step(cfg, ocfg, tcfg)(params,
                                                   adamw_init(params, ocfg), b)
        mets[name] = (float(m["loss"]), float(m["grad_norm"]))
    assert math.isclose(mets["card"][0], mets["cpu"][0], rel_tol=1e-4)
    assert math.isclose(mets["card"][1], mets["cpu"][1], rel_tol=1e-4)


def test_train_cli_on_the_card(dev, tmp_path):
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "deepseek-v2-lite", "--smoke", "--steps", "4", "--ckpt-every", "2",
         "--ckpt-dir", str(tmp_path), "--device", "cuda"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.join(root, "src")})
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[-2] == "[train] deepseek-smoke: 0.21M params"
    assert lines[-1].startswith("[train] 4 steps in ")
    assert lines[-1].endswith("checkpoints: [2, 4]")


# ---------------------------------------------------------------------------
# The model families (GQA attention, the hybrid, VLM, audio) and the faults
# C.2 and C.3 on the card
# ---------------------------------------------------------------------------

def _hybrid_small():
    """Zamba2's shape at a narrow width the ssd_chunk kernel takes (Q 64,
    P 64, N 64, 8 heads): 7 Mamba2 layers, 2 groups of 3 and 1 more."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.ssm import Mamba2Config
    return dataclasses.replace(
        get_smoke_config("zamba2-7b"), d_model=256,
        ssm=Mamba2Config(d_model=256, d_state=64, head_dim=64, expand=2,
                         chunk=64))


def test_hybrid_prefill_kernels_match_plain(dev):
    """The hybrid's prefill of 2 x 128 tokens and 2 decode steps through the
    ssd_chunk kernel (once per Mamba2 layer) and through its plain version,
    f32: logits, every cache leaf (SSM states, conv tails, the shared
    block's K/V) and the decode state within 1e-4."""
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.models import model as M
    cfg = _hybrid_small()
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab, (2, 130), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    outs = {}
    for name, ops in (("kernels", M.KERNELS), ("plain", M.PLAIN)):
        before = ssd_ops.ssd_intra_chunk.launches
        logits, caches = M.prefill(params, cfg, {"tokens": tok[:, :128]},
                                   ops=ops)
        launched = ssd_ops.ssd_intra_chunk.launches - before
        assert launched == (cfg.n_layers if name == "kernels" else 0)
        state = M.fill_decode_state(cfg, M.init_decode_state(
            cfg, 2, 130, dtype=torch.float32, device=dev), caches)
        steps = []
        for i in range(2):
            lg, state = M.decode_step(params, cfg, state,
                                      tok[:, 128 + i:129 + i],
                                      torch.full((2, 1), 128 + i,
                                                 device=dev), 128 + i,
                                      ops=ops)
            steps.append(lg)
        outs[name] = [logits, *steps, *_leaves(caches), *_leaves(state)]
    for a, b in zip(outs["kernels"], outs["plain"]):
        _close(a, b, 1e-4, 1e-4)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("arch", ["qwen3-32b", "llava-next-mistral-7b",
                                  "whisper-large-v3"])
def test_gqa_decode_matches_forward(dev, arch):
    """Prefill 31 tokens into a cache of exactly 32 context slots, decode
    token 31 (every slot written): its logits equal the forward's at
    position 31 over all 32 tokens, f32, within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import model as M
    cfg = get_smoke_config(arch)
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=torch.float32)
    batch = SyntheticPipeline.for_model(
        cfg, 32 + (cfg.vlm_patches if cfg.family == "vlm" else 0), 2,
        device=dev).batch_at(0)
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in batch.items() if k != "targets"}
    S = batch["tokens"].shape[1] - 1
    want, _, _ = M.forward(params, cfg, batch)
    _, caches = M.prefill(params, cfg,
                          dict(batch, tokens=batch["tokens"][:, :S]))
    ctx = S + (cfg.vlm_patches if cfg.family == "vlm" else 0)
    state = M.fill_decode_state(cfg, M.init_decode_state(
        cfg, 2, ctx + 1, dtype=torch.float32, device=dev), caches)
    got, _ = M.decode_step(params, cfg, state, batch["tokens"][:, S:],
                           torch.full((2, 1), ctx, device=dev), ctx)
    _close(got[:, 0], want[:, S], 1e-4, 1e-4)


def test_batch_on_the_card_equals_the_cpus(dev):
    """C.2: the same seed and step give the same batch, tokens, targets
    and the stub frame embeddings, on the card as on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticPipeline
    for arch in ("deepseek-v2-lite", "whisper-large-v3",
                 "llava-next-mistral-7b"):
        cfg = get_smoke_config(arch)
        for step in (0, 7):
            a = SyntheticPipeline.for_model(cfg, 129, 16, seed=3,
                                            device=dev).batch_at(step)
            b = SyntheticPipeline.for_model(cfg, 129, 16, seed=3,
                                            device="cpu").batch_at(step)
            assert a.keys() == b.keys()
            assert all(a[k].device.type == "cuda" and torch.equal(
                a[k].cpu(), b[k]) for k in a)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", ["mla_decode", "sparse_select",
                                  "softmax_merge", "softmax_merge_parts",
                                  "ssd_intra_chunk"])
def test_kernels_take_narrow_operands_and_return_f32(dev, name, dtype):
    """C.3 on the card: bf16 / f16 operands launch the f32 kernel on their
    upcast and return f32, bit for bit the kernel's result on the f32
    operands."""
    from repro_torch.core.merge import Partial
    from repro_torch.kernels.mla_decode import ops as mla_ops
    from repro_torch.kernels.softmax_merge import ops as merge_ops
    from repro_torch.kernels.sparse_select import ops as sel_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    g = torch.Generator(device=dev).manual_seed(5)
    f = lambda *s: torch.randn(s, device=dev, generator=g)
    idx = torch.tensor([[1, 0], [2, 3]], dtype=torch.int32, device=dev)
    calls = {
        "mla_decode": (lambda q, c: mla_ops.mla_decode(q, c, d_v=512,
                                                       scale=0.04),
                       (f(2, 16, 576), f(2, 300, 576))),
        "sparse_select": (lambda q, c: sel_ops.sparse_select(
            q, c, idx, d_v=512, scale=0.04),
            (f(2, 16, 576), f(2, 256, 576))),
        "softmax_merge": (merge_ops.softmax_merge,
                          (f(3, 2, 16, 512), f(3, 2, 16),
                           f(3, 2, 16).abs())),
        "softmax_merge_parts": (lambda o, m, l: merge_ops.softmax_merge_parts(
            [Partial(o[i], m[i], l[i]) for i in range(3)]),
            (f(3, 2, 16, 512), f(3, 2, 16), f(3, 2, 16).abs())),
        "ssd_intra_chunk": (lambda *a: ssd_ops.ssd_intra_chunk(*a, hb=4),
                            (f(1, 4, 128, 8, 64), f(1, 4, 128, 8).abs(),
                             -f(8).abs(), f(1, 4, 128, 64),
                             f(1, 4, 128, 64)))}
    fn, ins = calls[name]
    narrow = [t.to(dtype) for t in ins]
    got, want = fn(*narrow), fn(*(t.float() for t in narrow))
    torch.cuda.synchronize()
    assert all(t.dtype == torch.float32 and t.device.type == "cuda"
               for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
