"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4, head_dim=128)
MoE: 128 experts top-8, d_expert=1536, vocab=151936, qk_norm.
[hf:Qwen/Qwen3-30B-A3B family; hf-verified tier]"""

from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
        vocab=151936, attn_type="gqa", n_heads=64, n_kv_heads=4,
        head_dim=128, qk_norm=True,
        moe=MoEConfig(d_model=4096, d_expert=1536, n_experts=128, top_k=8),
        rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe", n_layers=2, d_model=64,
        vocab=256, attn_type="gqa", n_heads=4, n_kv_heads=2, head_dim=32,
        qk_norm=True,
        moe=MoEConfig(d_model=64, d_expert=32, n_experts=8, top_k=2),
    )
