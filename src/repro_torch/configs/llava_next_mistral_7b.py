"""llava-next-mistral-7b [vlm] — Mistral-7B backbone: 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000; anyres tiling frontend is a STUB —
input_specs() provides precomputed patch embeddings (task spec).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified tier]"""

from repro_torch.models.model import ModelConfig

N_PATCHES = 576            # one anyres base tile (24x24 @ patch 14, 336px)


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm", n_layers=32,
        d_model=4096, vocab=32000, attn_type="gqa", n_heads=32,
        n_kv_heads=8, d_ff=14336, mlp_kind="swiglu", rope_theta=1e6,
        vlm_patches=N_PATCHES,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-smoke", family="vlm", n_layers=2, d_model=64,
        vocab=256, attn_type="gqa", n_heads=4, n_kv_heads=2, d_ff=128,
        mlp_kind="swiglu", vlm_patches=8,
    )
