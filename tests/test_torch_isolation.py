"""The port stands alone and never falls back:

* importing repro_torch and every submodule pulls in neither jax nor the
  JAX package (checked in a fresh interpreter; the distribution modules
  and the example drivers also by name), and no source under
  src/repro_torch/ (nor chip_smoke.py) imports either;
* the control-plane modules copied from repro stay verbatim copies, up to
  the import rewrite repro. -> repro_torch. and the removal of the
  reference's issue/PR history tags from comments;
* the exec backend refuses to start without a card unless asked for the
  CPU, and the kernel wrappers take their plain versions on CPU tensors
  without counting a launch.
"""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels.delta_rotate import ops as rot_ops
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.mla_decode import ops as mla_ops
from repro_torch.kernels.softmax_merge import ops as merge_ops
from repro_torch.kernels.sparse_select import ops as sel_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.serving.backends.torch_exec import TorchExecBackend

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# The verbatim copies of the JAX-free control plane. A later slice that
# must diverge from one removes it here, with the reason beside it.
# (serving/backends/__init__.py is adapted — it names TorchExecBackend —
# and so is not listed; nor are configs/__init__.py, which imports the
# port's config modules by name, and configs/deepseek_v2_lite.py, which
# also gives the serving path V2_LITE_MLA.)
COPIES = ("core/constants.py", "core/cost_model.py", "core/predicate.py",
          "core/chunk_store.py", "serving/timeline.py", "serving/plan.py",
          "serving/backends/base.py", "serving/backends/analytic.py",
          "obs/__init__.py", "obs/trace.py", "obs/metrics.py",
          "obs/drift.py", "serving/engine.py", "serving/workload.py",
          "serving/selection/types.py", "serving/selection/replay.py",
          "configs/deepseek_v2_236b.py", "configs/mamba2_370m.py",
          "configs/qwen1_5_32b.py", "configs/qwen2_5_32b.py",
          "configs/qwen3_32b.py", "configs/nemotron_4_340b.py",
          "configs/qwen3_moe_235b.py", "configs/llava_next_mistral_7b.py",
          "configs/zamba2_7b.py", "configs/whisper_large_v3.py")

_IMPORT_REPRO = re.compile(r"^(\s*(?:from|import)\s+)repro(?=[.\s])", re.M)
# The copies also drop the reference's development-history tags (which
# issue or PR introduced a feature) from comments and docstrings, in this
# order; nothing else differs.
_HISTORY_TAGS = (
    (r"\(ISSUE \d+ satellite ?[—:] ", "("),
    (r"satellite \(ISSUE \d+\): ", ""),
    (r"\n\(ISSUE \d+\)\.", "."),
    (r" ?\(ISSUE \d+(?: satellite)?\)", ""),
    (r"[,;] ISSUE \d+\)", ")"),
    (r"backend,\n(\s*)ISSUE \d+\); ", r"backend);\n\1"),
    (r"\(ISSUE \d+ ", "("),
    (r"# ISSUE \d+:? ", "# "),
    (r"Since ISSUE \d+ (\w)", lambda m: m.group(1).upper()),
    (r" since ISSUE \d+", ""),
    (r"the ISSUE \d+ ", "the "),
    (r"through PR 1 prices", "earlier prices"),
    (r"what PR 1", "what the engine"),
    (r"Through\n(\s*)PR 1 this", r"Once\n\1this"),
    (r"the PR-2 (?:overlap )?timeline", "the overlap timeline"),
)


def port_copy(original: str) -> str:
    """The port's copy of a JAX-free reference module."""
    out = _IMPORT_REPRO.sub(r"\1repro_torch", original)
    for pattern, repl in _HISTORY_TAGS:
        out = re.sub(pattern, repl, out)
    return out


_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|repro)(?:[.\s]|$)",
                        re.M)


def test_import_leaves_jax_and_repro_out():
    prog = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'jaxlib', "
        "'repro') or k.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 30, names\n"
        "print('ISOLATED', len(names))\n")
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert "ISOLATED" in res.stdout


# the distribution and launch modules (ROADMAP A.12), named: imported in a
# fresh interpreter, none pulls in jax or the JAX package
DISTRIBUTION = ("repro_torch.distributed.sharding",
                "repro_torch.distributed.policy",
                "repro_torch.distributed.collective_matmul",
                "repro_torch.distributed.step_costs",
                "repro_torch.launch.mesh", "repro_torch.launch.input_specs",
                "repro_torch.launch.dryrun", "repro_torch.optim.compress")


# the example drivers (repro_torch.examples), named likewise
EXAMPLES = ("repro_torch.examples", "repro_torch.examples.quickstart",
            "repro_torch.examples.serve_routed",
            "repro_torch.examples.agentic_fanout",
            "repro_torch.examples.plan_execute",
            "repro_torch.examples.train_mla_100m")


def _imports_leave_jax_and_repro_out(modules) -> None:
    prog = (
        "import importlib, sys\n"
        f"for n in {modules!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n")
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert "ISOLATED" in res.stdout


def test_distribution_modules_leave_jax_and_repro_out():
    _imports_leave_jax_and_repro_out(DISTRIBUTION)


def test_example_drivers_leave_jax_and_repro_out():
    _imports_leave_jax_and_repro_out(EXAMPLES)


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


@pytest.mark.parametrize("rel", COPIES)
def test_control_plane_copy_is_verbatim(rel):
    copy = (PORT / rel).read_text()
    assert copy == port_copy((ROOT / "src" / "repro" / rel).read_text())
    assert not re.search(r"ISSUE \d|PR[- ]\d", copy)


def test_exec_backend_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchExecBackend()
    with pytest.raises(ValueError):
        TorchExecBackend(device="meta")
    assert TorchExecBackend(device="cpu").device.type == "cpu"


def test_cpu_calls_take_the_plain_versions_and_count_nothing():
    counters = (mla_ops.mla_decode, merge_ops.softmax_merge,
                rot_ops.delta_rotate, sel_ops.sparse_select)
    before = [fn.launches for fn in counters]
    mla_ops.mla_decode(torch.randn(1, 4, 24), torch.randn(1, 9, 24), d_v=16)
    sel_ops.sparse_select(torch.randn(1, 4, 24), torch.randn(1, 70, 24),
                          torch.tensor([[1]], dtype=torch.int32), d_v=16)
    merge_ops.softmax_merge(torch.randn(2, 4, 16), torch.randn(2, 4),
                            torch.rand(2, 4))
    rot_ops.delta_rotate_band(torch.randn(5, 8), 3, head_dim=8)
    assert [fn.launches for fn in counters] == before
    with pytest.raises(ValueError, match="unsupported device"):
        mla_ops.mla_decode(torch.zeros(1, 4, 24, device="meta"),
                           torch.zeros(1, 9, 24, device="meta"), d_v=16)


def _prefill_call(device):
    return fp_ops.flash_prefill(torch.randn(1, 5, 2, 24, device=device),
                                torch.randn(1, 9, 24, device=device), d_v=16)


def _ssd_call(device):
    mk = lambda *s: torch.randn(*s, device=device)
    return ssd_ops.ssd_intra_chunk(mk(1, 2, 8, 4, 6), mk(1, 2, 8, 4).abs(),
                                   -mk(4).abs(), mk(1, 2, 8, 5),
                                   mk(1, 2, 8, 5), hb=3)


@pytest.mark.parametrize("call,counter", [
    (_prefill_call, fp_ops.flash_prefill),
    (_ssd_call, ssd_ops.ssd_intra_chunk)], ids=["flash_prefill", "ssd_chunk"])
def test_model_kernel_wrappers_take_plain_versions_on_cpu(call, counter):
    """The model path's wrappers run their plain versions on CPU tensors,
    count no launch, and refuse any other device instead of falling back."""
    before = counter.launches
    out = call("cpu")
    assert counter.launches == before
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in (out if isinstance(out, tuple) else (out,)))
    with pytest.raises(ValueError, match="unsupported device"):
        call("meta")


def test_model_path_takes_its_ops_as_an_argument():
    """The kernels or their plain versions are chosen by the caller (Ops),
    never by an environment variable or a fallback."""
    from repro_torch.models import model as M
    assert M.KERNELS.flash_prefill is fp_ops.flash_prefill
    assert M.KERNELS.ssd_intra_chunk is ssd_ops.ssd_intra_chunk
    assert M.KERNELS.mla_decode is mla_ops.mla_decode
    assert M.KERNELS.sparse_select is sel_ops.sparse_select
    assert all(getattr(M.PLAIN, f).__name__.endswith("_ref")
               for f in ("flash_prefill", "mla_decode", "sparse_select",
                         "ssd_intra_chunk"))
    src = (PORT / "models" / "model.py").read_text()
    assert "os.environ" not in src and "except" not in src
