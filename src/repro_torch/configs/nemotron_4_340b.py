"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU MLP, LayerNorm. [arXiv:2402.16819; unverified]"""

from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense", n_layers=96, d_model=18432,
        vocab=256000, attn_type="gqa", n_heads=96, n_kv_heads=8,
        d_ff=73728, mlp_kind="squared_relu", norm_kind="layernorm",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", family="dense", n_layers=2, d_model=96,
        vocab=256, attn_type="gqa", n_heads=6, n_kv_heads=2,
        d_ff=384, mlp_kind="squared_relu", norm_kind="layernorm",
    )
