"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8, head_dim=128 explicit)
d_ff=25600 vocab=151936, qk_norm, no bias. [hf:Qwen/Qwen3-8B family; hf]"""

from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
        vocab=151936, attn_type="gqa", n_heads=64, n_kv_heads=8,
        head_dim=128, qk_norm=True, d_ff=25600, mlp_kind="swiglu",
        rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="dense", n_layers=2, d_model=64,
        vocab=256, attn_type="gqa", n_heads=4, n_kv_heads=2, head_dim=32,
        qk_norm=True, d_ff=128, mlp_kind="swiglu",
    )
