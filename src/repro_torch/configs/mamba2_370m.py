"""mamba2-370m [ssm] — 48L d_model=1024 (attn-free), ssm_state=128,
head_dim=64, expand=2 (d_inner=2048, 32 SSD heads), vocab=50280.
SSD (state-space duality). [arXiv:2405.21060; unverified tier]

Technique inapplicability (DESIGN.md §4): no KV cache exists; the paper's
per-chunk ROUTE/FETCH/LOCAL question degenerates — cross-instance handoff is
a one-shot fixed-size state FETCH."""

from repro_torch.models.model import ModelConfig
from repro_torch.models.ssm import Mamba2Config


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm", n_layers=48, d_model=1024,
        vocab=50280, attn_type="none", d_ff=0,
        ssm=Mamba2Config(d_model=1024, d_state=128, head_dim=64, expand=2,
                         chunk=128),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm", n_layers=2, d_model=64,
        vocab=256, attn_type="none", d_ff=0,
        ssm=Mamba2Config(d_model=64, d_state=16, head_dim=8, expand=2,
                         chunk=8),
    )
