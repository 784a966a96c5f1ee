"""deepseek-v2-lite — the paper's measured instance (§3): 16-head MLA with
kv_lora_rank 512 and a 64-wide rope band, so d_qk = 576 (the 1152-B bf16
wire row), d_v = 512 and scale = 1/sqrt(192). Only the MLA geometry is
needed by the serving path. [arXiv:2405.04434]"""

from repro_torch.models.mla import MLAConfig

V2_LITE_MLA = MLAConfig(d_model=2048, n_heads=16, kv_lora_rank=512,
                        q_lora_rank=None, qk_nope_head_dim=128,
                        qk_rope_head_dim=64, v_head_dim=128)
