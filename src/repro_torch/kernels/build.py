"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with one `nvcc` call into its own shared library with a
plain C interface, loaded with ctypes: no PyTorch headers, so a build takes
seconds. Libraries land in build/kernels/ at the repository root (listed in
.gitignore), named by a hash of the source, the shared headers and the
flags, so an edited source never loads a stale library. build_all() starts every nvcc at once
and waits for all of them, and returns what ptxas reports of each kernel
(registers, spills); library() builds on first use.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import re
import subprocess
import time
from typing import Dict, Iterable, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("mla_decode", "softmax_merge", "delta_rotate", "sparse_select",
           "flash_prefill", "flash_prefill_bf16", "ssd_chunk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_SM_COUNT: Dict[int, int] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # what the sources include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, list]]:
    """Compile every named source that has no library yet, all nvcc calls
    in parallel. Returns {name: (seconds, ptxas lines)} for the ones it
    built, the lines being ptxas -v's registers, spills and notes of each
    function; raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        took[name] = (time.perf_counter() - t0, [
            re.sub(r" in function '.*", "", line.strip())
            for line in log.splitlines()
            if re.search(r"Used \d+ registers|spill|Compiling entry|C75", line)])
        os.replace(tmp, out)              # atomic: a reader never sees half
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def refuse_dtensor(what: str, use: str, *ts) -> None:
    """Raise TypeError if any of ts is a DTensor: a kernel takes the local
    tensors of one rank, and a DTensor's layout is the caller's to resolve
    (`use` says how), never the wrapper's behind the caller's back."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError(f"{what} takes local tensors, got a DTensor: {use}")


def as_f32(what: str, *ts):
    """The operands in f32, as the reference's kernels take them: a floating
    tensor of another width (bf16, f16) is cast, an f32 one passes as it is
    (no copy, its strides kept); anything else raises TypeError."""
    import torch
    out = []
    for t in ts:
        if not t.dtype.is_floating_point:
            raise TypeError(f"{what}: operands must be floating point, got "
                            f"{t.dtype}")
        out.append(t if t.dtype == torch.float32 else t.to(torch.float32))
    return out


def sm_count(device) -> int:
    """The number of SMs of a CUDA device (cached per device index)."""
    import torch
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def stream_of(t) -> int:
    """The raw handle of the current stream on t's device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
