"""deepseek-v2-236b [moe] — 60L d_model=5120 128H, MLA kv_lora=512
(q_lora=1536, nope=128, rope=64, v=128), MoE: 160 routed top-6 + 2 shared,
d_expert=1536, first layer dense (d_ff=12288), vocab=102400.
[arXiv:2405.04434; hf-verified tier]

The paper's home regime: the latent c^KV entry is the routed wire object.
long_500k uses the DSA-style top-k selection path (selection_k=2048 — the
V3.2/GLM-5.1 budget, §5.4)."""

from repro_torch.models.mla import MLAConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
        vocab=102400, attn_type="mla",
        n_heads=128, n_kv_heads=128,
        mla=MLAConfig(d_model=5120, n_heads=128, kv_lora_rank=512,
                      q_lora_rank=1536, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        d_ff=12288, first_k_dense=1,
        moe=MoEConfig(d_model=5120, d_expert=1536, n_experts=160, top_k=6,
                      n_shared=2),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="moe", n_layers=3, d_model=64,
        vocab=256, attn_type="mla", n_heads=4, n_kv_heads=4,
        mla=MLAConfig(d_model=64, n_heads=4, kv_lora_rank=32,
                      q_lora_rank=48, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        d_ff=128, first_k_dense=1,
        moe=MoEConfig(d_model=64, d_expert=32, n_experts=8, top_k=2,
                      n_shared=1),
    )
