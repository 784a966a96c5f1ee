"""Deterministic, stateless data pipeline, the counterpart of
repro.data.pipeline.

batch_at(step) is a pure function of (seed, step), drawn from a CPU
torch.Generator seeded by both, with no iterator state, then moved to the
pipeline's device: a restart from checkpoint step K replays exactly the
batches K, K+1, ..., and a run on the card replays the batches of a run on
the CPU (the CUDA generator's stream differs from the CPU one's for the same
seed). The corpus is the reference's: a Zipf-like marginal (a squared
uniform) in which each token copies its predecessor with probability 1/2
(a learnable bigram signal), targets the tokens shifted by one. The VLM's
and the audio model's stub modality inputs (precomputed patch and frame
embeddings, 0.02 x N(0, 1) in bf16) come from the same generator, after the
tokens. The numbers themselves differ from jax.random's; the parity tests
hand both packages the reference's batch instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    family: str = "dense"         # vlm/audio add stub modality inputs
    d_model: int = 0
    vlm_patches: int = 0
    enc_seq: int = 0


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens", "targets": (global_batch, seq_len) int64} on the
        pipeline's device, with "patch_embeds" (global_batch, vlm_patches,
        d_model) for the vlm family and "frame_embeds" (global_batch,
        enc_seq, d_model) for the audio family, in bf16. Drawn on the CPU
        (a few MB at most) whatever the device."""
        c = self.cfg
        g = torch.Generator()
        # both words mixed into every bit: the CPU generator keeps only the
        # low 32 bits of its seed
        g.manual_seed(int(np.random.SeedSequence([c.seed, step])
                          .generate_state(1, np.uint64)[0]))
        shape = (c.global_batch, c.seq_len + 1)
        u = torch.rand(shape, generator=g)
        fresh = (torch.square(u) * (c.vocab - 1)).long()
        copy = torch.rand(shape, generator=g) < 0.5
        tokens = copy_chain(fresh, copy)
        batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
        stub = {"vlm": ("patch_embeds", c.vlm_patches),
                "audio": ("frame_embeds", c.enc_seq)}.get(c.family)
        if stub is not None:
            name, n = stub
            batch[name] = (0.02 * torch.randn(
                (c.global_batch, n, c.d_model), generator=g)).to(
                    torch.bfloat16)
        return {k: v.to(self.device) for k, v in batch.items()}

    @staticmethod
    def for_model(mcfg, seq_len: int, global_batch: int, seed: int = 0,
                  device="cuda"):
        return SyntheticPipeline(DataConfig(
            vocab=mcfg.vocab,
            seq_len=seq_len if mcfg.family != "vlm"
            else seq_len - mcfg.vlm_patches,
            global_batch=global_batch, seed=seed, family=mcfg.family,
            d_model=mcfg.d_model, vlm_patches=mcfg.vlm_patches,
            enc_seq=mcfg.enc_seq), device=device)


def copy_chain(fresh: torch.Tensor, copy: torch.Tensor) -> torch.Tensor:
    """tokens[:, t] = tokens[:, t - 1] where copy[:, t], else fresh[:, t]
    (position 0 is fresh: it has no predecessor). Each token is fresh at
    the last position up to it that does not copy, so the chain is a cummax
    over positions, not a loop."""
    pos = torch.arange(fresh.shape[1], device=fresh.device)
    src = torch.cummax(torch.where(copy, 0, pos), dim=1).values
    return torch.gather(fresh, 1, src)


def canonical_corpus(n_chunks: int, chunk_tokens: int, vocab: int,
                     seed: int = 1) -> np.ndarray:
    """Provider-curated canonical chunks (§1): (n_chunks, chunk_tokens)
    immutable token blocks, shared across tenants."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, (n_chunks, chunk_tokens)).astype(np.int32)
