"""deepseek-v2-lite — the paper's measured instance (§3): 27L, d_model=2048,
16H MLA (kv_lora=512, rope=64 => d_qk=576, the 1152-B wire row, d_v=512,
scale 1/sqrt(192)), MoE 64 routed top-6 + 2 shared, d_expert=1408, first
dense layer d_ff=10944, vocab=102400. [arXiv:2405.04434]

V2_LITE_MLA is the MLA geometry alone, which the serving path uses."""

from repro_torch.models.mla import MLAConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig

V2_LITE_MLA = MLAConfig(d_model=2048, n_heads=16, kv_lora_rank=512,
                        q_lora_rank=None, qk_nope_head_dim=128,
                        qk_rope_head_dim=64, v_head_dim=128)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite", family="moe", n_layers=27, d_model=2048,
        vocab=102400, attn_type="mla", n_heads=16, n_kv_heads=16,
        mla=V2_LITE_MLA, d_ff=10944, first_k_dense=1,
        moe=MoEConfig(d_model=2048, d_expert=1408, n_experts=64, top_k=6,
                      n_shared=2),
    )


def smoke() -> ModelConfig:
    from repro_torch.configs.deepseek_v2_236b import smoke as _smoke
    return _smoke()
