"""zamba2-7b [hybrid] — 81L d_model=3584, Mamba2 backbone (ssm_state=64,
head_dim=64) + SHARED attention block (32H kv=32, d_ff=14336) applied after
every 6-layer group (simplified: no per-invocation LoRA — DESIGN.md §4).
vocab=32000. [arXiv:2411.15242; unverified tier]"""

from repro_torch.models.model import ModelConfig
from repro_torch.models.ssm import Mamba2Config


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
        vocab=32000, attn_type="gqa", n_heads=32, n_kv_heads=32,
        d_ff=14336, mlp_kind="swiglu",
        ssm=Mamba2Config(d_model=3584, d_state=64, head_dim=64, expand=2,
                         chunk=128),
        hybrid_group=6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid", n_layers=7, d_model=64,
        vocab=256, attn_type="gqa", n_heads=4, n_kv_heads=4, d_ff=128,
        mlp_kind="swiglu",
        ssm=Mamba2Config(d_model=64, d_state=16, head_dim=8, expand=2,
                         chunk=8),
        hybrid_group=3,
    )
