"""The faults repaired in the port (ROADMAP C.2, C.3) and the stub modality
inputs, on the CPU; their card halves are in tests/test_torch_gpu.py.

* C.2: SyntheticPipeline.batch_at draws on a CPU generator whatever the
  pipeline's device, then moves the batch there.
* C.3: the four kernel wrappers that took f32 only (mla_decode,
  sparse_select, softmax_merge in both entries, ssd_intra_chunk) take bf16
  and f16 operands, cast to f32 inside as the reference's kernels do, and
  return f32: bit for bit their result on the upcast operands. Integer index
  arguments and non-float operands still raise TypeError.
* The VLM's and the audio model's stub inputs: shapes, dtypes, scale,
  determinism; and launch.train --smoke on both configs, on the CPU.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.core.merge import Partial
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.kernels.mla_decode import ops as mla_ops
from repro_torch.kernels.softmax_merge import ops as merge_ops
from repro_torch.kernels.sparse_select import ops as sel_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.launch import train as launch_train


# ---------------------------------------------------------------------------
# C.2
# ---------------------------------------------------------------------------

def test_batch_is_drawn_on_the_cpu_whatever_its_device(monkeypatch):
    """Every draw of batch_at takes a CPU generator, for a pipeline on the
    meta device as for one on the CPU; the batch then lands on the
    pipeline's device with the same shapes and dtypes."""
    seen = []
    for name in ("rand", "randn"):
        real = getattr(torch, name)

        def spy(*a, _real=real, **k):
            seen.append(k["generator"].device)
            return _real(*a, **k)
        monkeypatch.setattr(torch, name, spy)
    cfg = TC.get_smoke_config("whisper-large-v3")
    got = {dev: SyntheticPipeline.for_model(cfg, 16, 2, device=dev)
           .batch_at(3) for dev in ("meta", "cpu")}
    assert seen and set(seen) == {torch.device("cpu")}
    assert all(v.device.type == "meta" for v in got["meta"].values())
    assert {k: (v.shape, v.dtype) for k, v in got["meta"].items()} == \
        {k: (v.shape, v.dtype) for k, v in got["cpu"].items()}


# ---------------------------------------------------------------------------
# C.3
# ---------------------------------------------------------------------------

def _f(g, *shape):
    return torch.randn(shape, generator=g)


def _mla(g):
    return (lambda q, ckv: mla_ops.mla_decode(q, ckv, d_v=16, scale=0.3),
            (_f(g, 2, 4, 24), _f(g, 2, 9, 24)))


def _select(g):
    idx = torch.tensor([[1, 0], [2, 1]], dtype=torch.int32)
    return (lambda q, ckv: sel_ops.sparse_select(
        q, ckv, idx, d_v=16, scale=0.3, block_tokens=4),
        (_f(g, 2, 4, 24), _f(g, 2, 12, 24)))


def _merge(g):
    return (merge_ops.softmax_merge,
            (_f(g, 3, 2, 4, 16), _f(g, 3, 2, 4), _f(g, 3, 2, 4).abs()))


def _merge_parts(g):
    return (lambda o, m, l: merge_ops.softmax_merge_parts(
        [Partial(o[i], m[i], l[i]) for i in range(3)]),
        (_f(g, 3, 2, 4, 16), _f(g, 3, 2, 4), _f(g, 3, 2, 4).abs()))


def _ssd(g):
    return (lambda x, dt, A, B, C: ssd_ops.ssd_intra_chunk(x, dt, A, B, C,
                                                          hb=2),
            (_f(g, 1, 2, 8, 4, 6), _f(g, 1, 2, 8, 4).abs(), -_f(g, 4).abs(),
             _f(g, 1, 2, 8, 5), _f(g, 1, 2, 8, 5)))


WRAPPERS = {"mla_decode": _mla, "sparse_select": _select,
            "softmax_merge": _merge, "softmax_merge_parts": _merge_parts,
            "ssd_intra_chunk": _ssd}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_take_narrow_operands_and_return_f32(name, dtype):
    fn, ins = WRAPPERS[name](torch.Generator().manual_seed(0))
    narrow = [t.to(dtype) for t in ins]
    got = fn(*narrow)
    want = fn(*(t.float() for t in narrow))
    got, want = (tuple(got), tuple(want))
    assert all(t.dtype == torch.float32 for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_index_and_integer_operands_keep_their_type_errors():
    g = torch.Generator().manual_seed(1)
    q, ckv = _f(g, 1, 4, 24), _f(g, 1, 8, 24)
    with pytest.raises(TypeError, match="block_idx"):
        sel_ops.sparse_select(q, ckv, torch.zeros((1, 1)), d_v=16,
                              block_tokens=4)
    with pytest.raises(TypeError, match="floating point"):
        mla_ops.mla_decode(q.long(), ckv, d_v=16)
    with pytest.raises(TypeError, match="floating point"):
        merge_ops.softmax_merge(torch.zeros((2, 3, 4), dtype=torch.int32),
                                torch.zeros((2, 3)), torch.zeros((2, 3)))


# ---------------------------------------------------------------------------
# the stub modality inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,key,n", [
    ("llava-next-mistral-7b", "patch_embeds", "vlm_patches"),
    ("whisper-large-v3", "frame_embeds", "enc_seq")])
def test_stub_inputs_shapes_dtypes_and_determinism(arch, key, n):
    cfg = TC.get_config(arch)
    pipe = SyntheticPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=8, global_batch=2, seed=5,
        family=cfg.family, d_model=cfg.d_model,
        vlm_patches=cfg.vlm_patches, enc_seq=cfg.enc_seq), device="cpu")
    a, again, other = pipe.batch_at(4), pipe.batch_at(4), pipe.batch_at(5)
    assert set(a) == {"tokens", "targets", key}
    emb = a[key]
    assert emb.shape == (2, getattr(cfg, n), cfg.d_model)
    assert emb.dtype == torch.bfloat16
    assert all(torch.equal(a[k], again[k]) for k in a)
    assert not torch.equal(emb, other[key])
    std = float(emb.float().std())
    assert math.isclose(std, 0.02, rel_tol=0.02)    # ~10^6 draws
    assert float(emb.float().mean()) == pytest.approx(0.0, abs=1e-3)


def test_text_only_families_have_no_stub_inputs():
    cfg = TC.get_smoke_config("qwen3-32b")
    b = SyntheticPipeline.for_model(cfg, 8, 2, device="cpu").batch_at(0)
    assert set(b) == {"tokens", "targets"}


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-large-v3"])
def test_launch_train_smoke_on_the_cpu(arch, tmp_path, capsys):
    """repro_torch.launch.train --smoke for 2 steps on the config with stub
    inputs: the pipeline's patch or frame embeddings reach loss_fn; finite
    losses and the checkpoint at step 2."""
    log = launch_train.main(["--arch", arch, "--smoke", "--steps", "2",
                             "--seq", "32", "--batch", "2", "--ckpt-every",
                             "2", "--ckpt-dir", str(tmp_path), "--device",
                             "cpu"])
    losses = [e["loss"] for e in log if "loss" in e]
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].endswith("checkpoints: [2]")
