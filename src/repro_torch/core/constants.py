"""Measured constants from the paper, plus TPU-target hardware constants.

Every number here is traceable to a specific table/figure/section of
"Move the Query, Not the Cache" (Ma et al., 2026); paper section given inline.
The cost model (cost_model.py) and predicate (predicate.py) consume these; the
benchmark suite validates the model against the paper's headline claims.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, Mapping, Optional, Union

# ---------------------------------------------------------------------------
# MLA wire payload (§3.2), DeepSeek-V2(-Lite) geometry.
# ---------------------------------------------------------------------------

D_QK = 576          # absorbed query row width = kv_lora_rank(512) + rope(64)
D_V = 512           # latent value width (kv_lora_rank)
BF16 = 2            # bytes
FP32 = 4

Q_ROW_BYTES = D_QK * BF16                  # 1152 B per routed query row
P_ROW_BYTES = D_V * BF16 + 2 * FP32        # 1032 B per returned partial (o, m, l)
QP_BYTES = Q_ROW_BYTES + P_ROW_BYTES       # 2184 B round-trip per row

# Per-token, per-layer latent cache entry ("the same d_qk-wide object", §2.1).
B_KV_TOKEN_LAYER = D_QK * BF16             # 1152 B
V2_LITE_LAYERS = 27                        # DeepSeek-V2-Lite, §2.2
B_KV_TOKEN_ALL_LAYERS = B_KV_TOKEN_LAYER * V2_LITE_LAYERS   # ~31 KB/token


# ---------------------------------------------------------------------------
# Fabric table (Table 2 + §8 + TPU extension).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Fabric:
    """One row of the paper's fabric table: the affine model's two constants.

    t_probe_s  : payload-free signal round trip (sig_rt), seconds.
    bw_Bps     : effective single-dispatch bandwidth, bytes/second. The paper's
                 point (§8): this is a *dispatch* ceiling (~18-25 GB/s on every
                 GPU fabric), not the link peak.
    link_peak_Bps : the wire's true peak (multi-block benchmark / spec sheet);
                 what FETCH's coalesced bulk pull sees.
    t_launch_s : fixed kernel-turnaround beyond the probe (~9 us on IBGDA,
                 §4.3); explains the small-M_q residual.
    """
    name: str
    t_probe_s: float
    bw_Bps: float
    link_peak_Bps: float
    t_launch_s: float = 9e-6
    notes: str = ""

    # -- JSON fabric tables: engines and benchmarks can
    # run on MEASURED constants (benchmarks/calibrate_fabric.py writes
    # them) instead of the paper's Table 2 rows. -------------------------

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: Mapping, name: Optional[str] = None) -> "Fabric":
        """One fabric row from a JSON mapping; unknown keys are ignored so
        tables may carry fit diagnostics (mape, sweep size) alongside."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in obj.items() if k in fields}
        if name is not None:
            kw["name"] = name
        if "name" not in kw:
            raise ValueError("fabric row needs a name (key or argument)")
        return cls(**kw)

    @staticmethod
    def load_table(path: Union[str, pathlib.Path]) -> "Dict[str, Fabric]":
        """Read a {name: row} JSON fabric table (calibrate_fabric's output
        format) into Fabric objects keyed by name."""
        raw = json.loads(pathlib.Path(path).read_text())
        return {name: Fabric.from_json(row, name=name)
                for name, row in raw.items()}


# Paper-measured fabrics (Table 2; link peaks from §8).
FABRICS = {
    "h100_ibgda": Fabric("h100_ibgda", 16e-6, 25e9, 25e9,
                         notes="cross-node NDR-200, legacy driver (conservative)"),
    "h100_nvlink4": Fabric("h100_nvlink4", 1.2e-6, 21e9, 125e9,
                           notes="intra-node NV6 direct; per-GPU-pair peak ~125 GB/s"),
    "a100_nvlink3": Fabric("a100_nvlink3", 1.6e-6, 18e9, 235e9,
                           notes="NVSwitch"),
    "rtx6000_pcie5": Fabric("rtx6000_pcie5", 4.8e-6, 22e9, 41e9),
    "a40_pcie4": Fabric("a40_pcie4", 8.7e-6, 19e9, 19e9,
                        notes="same-socket; wire-bound (single-block rate = peak)"),
    # --- TPU extension rows (engineering estimates; DESIGN.md §2). The
    # predicate is invariant to the absolutes (paper §3.1 caveat). ---
    "tpu_ici": Fabric("tpu_ici", 1e-6, 45e9, 50e9, t_launch_s=0.0,
                      notes="v5e ICI one hop; compiler-scheduled, no launch gap"),
    "tpu_dcn": Fabric("tpu_dcn", 25e-6, 6e9, 25e9, t_launch_s=0.0,
                      notes="cross-pod data-center network, per host"),
}


# ---------------------------------------------------------------------------
# FETCH-side constants (§2.2, §7).
# ---------------------------------------------------------------------------

# Splice (position re-adaptation): flat ~3 ms, launch-bound. Affine fit of the
# paper's 2.77/2.78/2.91/3.06 ms at c_t = 55/1024/2048/4096:
SPLICE_BASE_S = 2.76e-3
SPLICE_PER_TOKEN_S = 7.1e-8      # ~10% growth over a 74x token range (§7)

# LOCAL re-prefill cost band (§5.1): c in [0.5, 1.5] us per token-layer.
PREFILL_PER_TOKEN_LAYER_S = (0.5e-6, 1.5e-6)
PREFILL_PER_TOKEN_LAYER_MID_S = 1.0e-6


# ---------------------------------------------------------------------------
# Host-overhead prototype constants (§5.3): TTFT ~= 3.5 ms + 12.5 us * M_q.
# Our in-graph TPU transport has no host path; keep as an optional term.
# ---------------------------------------------------------------------------

HOST_OVERHEAD_BASE_S = 3.5e-3
HOST_OVERHEAD_PER_ROW_S = 12.5e-6


# ---------------------------------------------------------------------------
# Holder-side constants (§6).
# ---------------------------------------------------------------------------

HOLDER_COMPUTE_ELBOW_N = 8        # batched partial ~free up to N~8 requesters
HOLDER_COMPUTE_DECODE_S = (15e-6, 37e-6)   # N <= 16, c_t = 2048
HOLDER_COMPUTE_SATURATED_S = 0.4e-3        # N = 256 upper bound
STAGING_STREAMS_ELBOW_K = 8       # K-stream staging pool elbow (§6.2)
MERGE_COST_S = 25e-6              # online-softmax merge upper bound (§4.2)

# Sparse-kernel premium over dense decode at matched k (§6.3).
SPARSE_PREMIUM = {512: 1.1, 1024: 1.75, 2048: 2.5}   # 1.1x .. 2-3x


# ---------------------------------------------------------------------------
# Congestion (§8): flat through K<=2 flows, rises at full subscription K=3.
# Multipliers on (probe, transfer) at K concurrent flows sharing one link.
# ---------------------------------------------------------------------------

CONGESTION_PROBE_MULT = {0: 1.0, 1: 1.0, 2: 1.0, 3: 39.5 / 14.5}
CONGESTION_RT_MULT_MQ1024 = {0: 1.0, 1: 1.0, 2: 1.0, 3: 250.0 / 114.0}


# ---------------------------------------------------------------------------
# Selection budgets (§5.4) — released-config index_topk values.
# ---------------------------------------------------------------------------

SELECTION_BUDGETS = {
    "deepseek_v32_dsa": 2048,
    "glm51_dsa": 2048,
    "deepseek_v4_pro": 1024,
    "deepseek_v4_flash": 512,
    "nsa": 1024,                 # ~16 blocks x 64 (+512 window)
}
NSA_BLOCK_TOKENS = 64


# ---------------------------------------------------------------------------
# TPU v5e roofline constants (task-given).
# ---------------------------------------------------------------------------

TPU_PEAK_FLOPS_BF16 = 197e12      # per chip
TPU_HBM_BW = 819e9                # bytes/s per chip
TPU_ICI_BW = 50e9                 # bytes/s per link
TPU_HBM_BYTES = 16 * 2**30        # v5e HBM capacity


def fabric(name: str) -> Fabric:
    try:
        return FABRICS[name]
    except KeyError:
        raise KeyError(f"unknown fabric {name!r}; known: {sorted(FABRICS)}")


def register_fabrics(table: "Dict[str, Fabric]",
                     overwrite: bool = True) -> None:
    """Install fabric rows (e.g. a measured Fabric.load_table) into the
    process-wide FABRICS registry so fabric() — and therefore EngineConfig
    fabric names — resolves them. With overwrite=False an existing paper
    row wins and the measured row is skipped."""
    for name, fab in table.items():
        if overwrite or name not in FABRICS:
            FABRICS[name] = fab
