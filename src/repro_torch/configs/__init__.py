"""Assigned-architecture registry: --arch <id> resolves here.

Each arch module exposes config() (the exact published geometry) and smoke()
(a reduced same-family config for CPU smoke tests). Sources/verification
tiers are recorded per module docstring.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

ARCH_IDS = [
    "qwen1_5_32b",
    "qwen2_5_32b",
    "qwen3_32b",
    "nemotron_4_340b",
    "deepseek_v2_236b",
    "qwen3_moe_235b",
    "llava_next_mistral_7b",
    "zamba2_7b",
    "mamba2_370m",
    "whisper_large_v3",
]

# canonical task ids -> module names
ALIASES = {
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen3-32b": "qwen3_32b",
    "nemotron-4-340b": "nemotron_4_340b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "zamba2-7b": "zamba2_7b",
    "mamba2-370m": "mamba2_370m",
    "whisper-large-v3": "whisper_large_v3",
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

# long_500k needs sub-quadratic attention (task spec): run for SSM / hybrid /
# selection-capable MLA; skip for pure full-attention archs (DESIGN.md §4).
LONG_CTX_ARCHS = {"deepseek_v2_236b", "zamba2_7b", "mamba2_370m"}


def _mod(arch: str):
    name = ALIASES.get(arch, arch)
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _mod(arch).config()


def get_smoke_config(arch: str):
    return _mod(arch).smoke()


def supported_shapes(arch: str) -> List[str]:
    name = ALIASES.get(arch, arch)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if name in LONG_CTX_ARCHS:
        out.append("long_500k")
    return out


def all_cells():
    """Every runnable (arch, shape) dry-run cell."""
    return [(a, s) for a in ARCH_IDS for s in supported_shapes(a)]
