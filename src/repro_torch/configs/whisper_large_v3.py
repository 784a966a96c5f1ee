"""whisper-large-v3 [audio] — enc-dec, 32L each, d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866, GELU + LayerNorm; conv frontend is a STUB —
input_specs() provides precomputed frame embeddings (task spec; enc_seq=1500
= 30 s of 20 ms frames). [arXiv:2212.04356; unverified tier]

Note: the assigned decode shapes (32k-token decoder cache) exceed Whisper's
released max_target_positions (448); the decoder's learned-position table is
sized to the assigned shape — a structural-lowering choice, DESIGN.md §4."""

from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio", n_layers=32,
        n_enc_layers=32, d_model=1280, vocab=51866, attn_type="gqa",
        n_heads=20, n_kv_heads=20, d_ff=5120, mlp_kind="gelu",
        norm_kind="layernorm", encdec=True, enc_seq=1500,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio", n_layers=2, n_enc_layers=2,
        d_model=64, vocab=256, attn_type="gqa", n_heads=4, n_kv_heads=4,
        d_ff=128, mlp_kind="gelu", norm_kind="layernorm", encdec=True,
        enc_seq=16,
    )
