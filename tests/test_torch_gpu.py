"""Card-only tests of the port (marker `gpu`): each hand-written kernel
against its plain PyTorch version on the card, at main-path shapes, and the
exec backend through all three kernels. They skip, with the reason, where
no CUDA card is present; on the card run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances (f32): mla_decode and sparse_select 1e-5 absolute and relative
(another summation order over the attended rows and D); softmax_merge and
delta_rotate 1e-6 (they round as the plain versions do)."""

import math

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


@pytest.mark.parametrize("R,S,lengths", [(16, 2048, None), (256, 2048, None),
                                         (4096, 2048, None),
                                         (16, 2048, (2048, 1000, 0)),
                                         (40, 300, None)])
def test_mla_decode_kernel_matches_plain(dev, R, S, lengths):
    from repro_torch.kernels.mla_decode import mla_decode, mla_decode_ref
    g = torch.Generator(device=dev).manual_seed(R + S)
    B = 1 if lengths is None else len(lengths)
    q = torch.randn((B, R, 576), device=dev, generator=g)
    ckv = torch.randn((B, S, 576), device=dev, generator=g)
    lens = None if lengths is None else torch.tensor(
        lengths, dtype=torch.int32, device=dev)
    before = mla_decode.launches
    got = mla_decode(q, ckv, lens, d_v=512, scale=1 / math.sqrt(192))
    assert mla_decode.launches == before + 1
    want = mla_decode_ref(q, ckv, lens, 512, 1 / math.sqrt(192))
    for a, b in zip(got, want):
        _close(a, b, 1e-5, 1e-5)
    if lengths is not None:
        assert bool((got.l[-1] == 0).all())
        assert bool(torch.isneginf(got.m[-1]).all())


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
    from repro_torch.kernels.delta_rotate import (delta_cos_sin, delta_rotate,
                                                  delta_rotate_ref)
    g = torch.Generator(device=dev).manual_seed(delta)
    ckv = torch.randn((2048, 576), device=dev, generator=g)
    cos, sin = delta_cos_sin(delta, 64)
    moved = torch.empty_like(ckv)
    got = delta_rotate(ckv[:, 512:], cos, sin, out=moved[:, 512:])
    _close(got, delta_rotate_ref(ckv[:, 512:], cos, sin), 1e-6)


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


# (R, S, block ids per row, kb per row or None, block_tokens): one request
# and a 16-request group over 8 and all 32 blocks of a 2048-token chunk, a
# ragged batch with an empty row and a selected tail block of a 2080-token
# chunk, and token-level selection of 37 scattered rows
SPARSE_CASES = {
    "r16_kb8": (16, 2048, [[1, 4, 5, 9, 17, 20, 28, 31]], None, 64),
    "r16_kb32": (16, 2048, [list(range(32))], None, 64),
    "r256_kb8": (256, 2048, [[0, 2, 3, 11, 12, 19, 25, 30]], None, 64),
    "r256_kb32": (256, 2048, [list(range(32))], None, 64),
    "ragged_tail": (16, 2080, [[0, 3, 7, 9, 12, 20, 31, 32], [32, 5, 1] + [0] * 5,
                               [0] * 8], [8, 3, 0], 64),
    "token_level": (16, 2048, [[(i * 331) % 2048 for i in range(37)]], None,
                    1),
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
        eng.schedule_step(reqs)
        assert eng.plans[-1].selections
        assert max_oracle_err(eng, reqs, eng.step_idx) <= 1e-5
    assert sel_ops.sparse_select.launches > before
