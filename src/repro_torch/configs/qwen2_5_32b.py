"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, QKV bias. [hf:Qwen/Qwen2.5-0.5B family; hf-verified tier]"""

from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
        vocab=152064, attn_type="gqa", n_heads=40, n_kv_heads=8,
        qkv_bias=True, d_ff=27648, mlp_kind="swiglu", rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke", family="dense", n_layers=2, d_model=64,
        vocab=256, attn_type="gqa", n_heads=4, n_kv_heads=2,
        qkv_bias=True, d_ff=128, mlp_kind="swiglu",
    )
