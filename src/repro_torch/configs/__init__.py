"""Architecture registry of the port: the architectures whose serving form
is ported resolve here by id or alias.

Each arch module exposes config() (the exact published geometry) and smoke()
(a reduced same-family config for CPU tests), the reference's
src/repro/configs/ subset for the families the port runs.
"""

from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "deepseek_v2_236b",
    "mamba2_370m",
]

# canonical task ids -> module names
ALIASES = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-370m": "mamba2_370m",
    "deepseek-v2-lite": "deepseek_v2_lite",   # the paper's measured instance
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def _mod(arch: str):
    name = ALIASES.get(arch, arch)
    if name not in ARCH_IDS and name not in ALIASES.values():
        raise NotImplementedError(f"{arch}: not ported yet (ROADMAP A.10)")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _mod(arch).config()


def get_smoke_config(arch: str):
    return _mod(arch).smoke()
