"""qwen1.5-32b [dense] — 64L d_model=5120 40H (kv=40, MHA) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B family; hf-verified tier]

The paper's "standard model" contrast case: no compression, kv cache
20 KB/token-layer, so the predicate picks FETCH/LOCAL far more often
(DESIGN.md §4)."""

from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
        vocab=152064, attn_type="gqa", n_heads=40, n_kv_heads=40,
        qkv_bias=True, d_ff=27392, mlp_kind="swiglu", rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family="dense", n_layers=2, d_model=64,
        vocab=256, attn_type="gqa", n_heads=4, n_kv_heads=4,
        qkv_bias=True, d_ff=128, mlp_kind="swiglu",
    )
