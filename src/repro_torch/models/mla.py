"""Multi-head Latent Attention (DeepSeek-V2 family), in absorbed form.

Fold W_uk into the query ("absorbed" q, width d_qk = kv_lora_rank +
rope_dim = 576), attend directly against the latent cache, fold W_uv into
the output. The absorbed query row IS the routed wire object of the paper
(§2.1: "a routed query row and a cached token are the same d_qk-wide
object").

The latent cache entry per token is [c_kv (512) | k_rope (64)]: the k_rope
band is the only position-dependent part — the delta-rotation splice
(core/splice.py, kernels/delta_rotate) re-homes exactly that band.

absorbed_partial is the decode-path entry: unmasked, it goes through the
mla_decode kernel wrapper, masked through sparse_select at token
granularity; selected_partial attends a block selection through
sparse_select (each wrapper runs its CUDA kernel on the card and its plain
version on the CPU). absorbed_partial_ref is the plain version the exactness
oracle uses everywhere.

mla_attention is the prefill form: it also runs absorbed, through the
flash_prefill kernel (causal attention of the absorbed queries over the
latent entries it writes), where the reference decompresses c^KV into
per-head keys and values. The two are equal up to rounding
(tests/test_mla.py holds them at 2e-5 / 1e-4 in f32).

mla_attention_train is the reference's own train form, decompressed and
causal, in plain PyTorch ops that autograd differentiates: the training
path runs it (no kernel of the repo has a backward pass), serving never
does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.merge import Partial, partial_from_logits
from repro_torch.distributed.sharding import local_heads
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.mla_decode import mla_decode
from repro_torch.kernels.sparse_select import sparse_select
from repro_torch.models import layers as L
from repro_torch.models.module import ones, param


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int = 2048
    n_heads: int = 16
    kv_lora_rank: int = 512          # d_c — latent value/nope-key width
    q_lora_rank: Optional[int] = None  # None => direct q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def d_qk(self) -> int:           # absorbed query row width (576 for V2)
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def scale(self) -> float:
        return 1.0 / np.sqrt(self.qk_head_dim)

    @property
    def cache_width(self) -> int:    # latent cache entry bytes/2 (bf16)
        return self.kv_lora_rank + self.qk_rope_head_dim


def param_specs(cfg: MLAConfig):
    """{name: (shape, logical axes)} of the MLA parameters cfg implies, in
    init order (a norm's axes are its scale's in the reference)."""
    h, dm = cfg.n_heads, cfg.d_model
    specs = {}
    if cfg.q_lora_rank:
        specs["q_down"] = ((dm, cfg.q_lora_rank), ("embed", None))
        specs["q_norm"] = ((cfg.q_lora_rank,), ("embed",))
        specs["q_up"] = ((cfg.q_lora_rank, h, cfg.qk_head_dim),
                         (None, "heads", None))
    else:
        specs["q_proj"] = ((dm, h, cfg.qk_head_dim), ("embed", "heads", None))
    specs["kv_down"] = ((dm, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                        ("embed", None))
    specs["kv_norm"] = ((cfg.kv_lora_rank,), ("embed",))
    specs["k_up"] = ((cfg.kv_lora_rank, h, cfg.qk_nope_head_dim),
                     (None, "heads", None))
    specs["v_up"] = ((cfg.kv_lora_rank, h, cfg.v_head_dim),
                     (None, "heads", None))
    specs["o_proj"] = ((h, cfg.v_head_dim, dm), ("heads", None, "embed"))
    return specs


class MLA(nn.Module):
    """The MLA parameters (init_mla). Norm scales (q_norm, kv_norm) init to
    ones, the projections to a truncated normal of std 1/sqrt(fan_in) drawn
    from `generator` on `device` (module.param), in the order
    repro.models.mla.init_mla draws them from its keys."""

    def __init__(self, cfg: MLAConfig, dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self._axes = {}
        for name, (shape, axes) in param_specs(cfg).items():
            self._axes[name] = axes
            if name.endswith("_norm"):
                t = ones(shape, dtype=dtype, device=device, axes=axes)
            else:
                t = param(shape, generator, dtype=dtype, device=device,
                          axes=axes)
            self.register_parameter(name, nn.Parameter(t,
                                                       requires_grad=False))

    def decode(self, x, ckv_cache, positions):
        return absorbed_decode(self, self.cfg, x, ckv_cache, positions)


# ---------------------------------------------------------------------------
# Shared projections
# ---------------------------------------------------------------------------

def project_q(p: MLA, cfg: MLAConfig, x, positions):
    """x (B, S, D) -> q_nope (B, S, H, dn), q_rope (B, S, H, dr) (rotated)."""
    if cfg.q_lora_rank:
        qc = L.rmsnorm(p.q_norm, x @ p.q_down)
        q = L.project_heads(qc, p.q_up)
    else:
        q = L.project_heads(x, p.q_proj)
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = q[..., cfg.qk_nope_head_dim:]
    cos, sin = L.rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta,
                              dtype=L.compute_dtype(x.dtype))
    q_rope = L.apply_rope(q_rope, cos[:, :, None, :], sin[:, :, None, :])
    return q_nope, q_rope


def latent_cache_entries(p: MLA, cfg: MLAConfig, x, positions):
    """x (B, S, D) -> c^KV entries (B, S, d_qk): [c_kv | rotated k_rope]."""
    kv = x @ p.kv_down
    c_kv = L.rmsnorm(p.kv_norm, kv[..., :cfg.kv_lora_rank])
    k_rope = kv[..., cfg.kv_lora_rank:]
    cos, sin = L.rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta,
                              dtype=L.compute_dtype(x.dtype))
    k_rope = L.apply_rope(k_rope, cos, sin)
    return torch.cat([c_kv, k_rope], dim=-1)


def absorb_query(p: MLA, cfg: MLAConfig, q_nope, q_rope):
    """Fold W_uk into q: (B, S, H, dn) -> absorbed q (B, S, H, d_qk)."""
    q_abs = torch.einsum("bshd,chd->bshc", q_nope, p.k_up)
    return torch.cat([q_abs, q_rope], dim=-1)


def unabsorb_output(p: MLA, cfg: MLAConfig, o_latent):
    """Latent partial output (B, S, H, d_c) -> model output (B, S, D):
    fold W_uv then o_proj."""
    o = torch.einsum("bshc,chd->bshd", o_latent, p.v_up)
    return L.merge_heads(o, p.o_proj)


# ---------------------------------------------------------------------------
# Absorbed partial attention — the holder-side compute of ROUTE (§6.3).
# ---------------------------------------------------------------------------

def absorbed_partial_ref(cfg: MLAConfig, q_abs, ckv, mask=None) -> Partial:
    """Plain version: q_abs (..., H, d_qk) x ckv (S, d_qk) -> Partial over
    the resident set, through an optional (S,)-style token mask."""
    logits = torch.matmul(q_abs.to(torch.float32),
                          ckv.to(torch.float32).transpose(-1, -2)) * cfg.scale
    values = ckv[:, :cfg.kv_lora_rank]
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device)
        if mask.ndim < logits.ndim:   # (S,)-style residency masks
            mask = mask.reshape((1,) * (logits.ndim - mask.ndim)
                                + tuple(mask.shape))
    return partial_from_logits(logits, values, mask)


def absorbed_partial(cfg: MLAConfig, q_abs, ckv, mask=None) -> Partial:
    """q_abs (..., H, d_qk) x ckv (S, d_qk) -> Partial over the resident set.

    Unmasked, the leading query axes fold into the kernel's row axis and the
    chunk is the kernel's single batch row: one mla_decode call, no copy of
    the cache. Masked, it is sparse_select at block_tokens = 1 over the
    mask's indices: an (S,) mask keeps one batch row, a mask that differs
    per query row gives each row its own index list over the same chunk
    (batch stride 0). Finding the indices waits for the mask's values; the
    serving path passes block ids instead (selected_partial)."""
    lead = tuple(q_abs.shape[:-1])
    if mask is not None:
        mask = torch.as_tensor(mask, device=ckv.device)
        if mask.ndim == 1:
            q = q_abs.reshape(1, -1, q_abs.shape[-1])
            masks = mask[None]
        else:                              # one index list per query row
            masks = mask.expand(lead + mask.shape[-1:]).reshape(
                -1, mask.shape[-1])
            q = q_abs.reshape(-1, 1, q_abs.shape[-1])
        kb = masks.sum(-1)
        width = int(kb.max()) if kb.numel() else 0
        # stable sort puts each row's True positions first, in order
        order = torch.argsort((~masks).to(torch.uint8), dim=-1,
                              stable=True)[:, :width]
        part = sparse_select(
            q.contiguous(), ckv.unsqueeze(0).expand(q.shape[0], -1, -1),
            order.to(torch.int32), kb.to(torch.int32), d_v=cfg.kv_lora_rank,
            scale=cfg.scale, block_tokens=1)
    else:
        q = q_abs.reshape(1, -1, q_abs.shape[-1]).contiguous()
        part = mla_decode(q, ckv.unsqueeze(0), d_v=cfg.kv_lora_rank,
                          scale=cfg.scale)
    return Partial(o=part.o.reshape(lead + (cfg.kv_lora_rank,)),
                   m=part.m.reshape(lead), l=part.l.reshape(lead))


def selected_partial(cfg: MLAConfig, q_abs, ckv, blocks,
                     block_tokens: int) -> Partial:
    """q_abs (..., H, d_qk) over the rows of ckv (S, d_qk) that the selected
    blocks cover (block ids, ascending; a partial tail block attends only
    its rows below S): one sparse_select call with the query rows folded
    into its row axis, the chunk read in place. No block selected gives the
    merge identity."""
    lead = tuple(q_abs.shape[:-1])
    q = q_abs.reshape(1, -1, q_abs.shape[-1]).contiguous()
    idx = torch.tensor([list(blocks)], dtype=torch.int32)
    if ckv.device.type == "cuda":
        # from pinned memory the copy is queued on the current stream; from
        # pageable memory the host would first wait for that stream
        idx = idx.pin_memory().to(ckv.device, non_blocking=True)
    part = sparse_select(q, ckv.unsqueeze(0), idx,
                         d_v=cfg.kv_lora_rank, scale=cfg.scale,
                         block_tokens=block_tokens)
    return Partial(o=part.o.reshape(lead + (cfg.kv_lora_rank,)),
                   m=part.m.reshape(lead), l=part.l.reshape(lead))


def absorbed_decode(p: MLA, cfg: MLAConfig, x, ckv_cache, positions, *,
                    partial_fn=None):
    """Single decode step in absorbed form.

    x (B, 1, D); ckv_cache (B, S, d_qk); positions (B, 1) absolute position
    of the new token. Returns (out (B, 1, D), new_entry (B, 1, d_qk)).
    partial_fn overrides the attention inner op; by default the batch goes
    through one mla_decode call, (B, H, d_qk) against (B, S + 1, d_qk)."""
    q_nope, q_rope = project_q(p, cfg, x, positions)
    q_abs = absorb_query(p, cfg, q_nope, q_rope)            # (B, 1, H, d_qk)
    new_entry = latent_cache_entries(p, cfg, x, positions)  # (B, 1, d_qk)
    full = torch.cat([ckv_cache, new_entry], dim=1)         # (B, S+1, d_qk)
    if partial_fn is not None:
        part = partial_fn(q_abs, full)
    else:
        B = q_abs.shape[0]
        flat = mla_decode(q_abs.reshape(B, -1, cfg.d_qk).contiguous(),
                          full.contiguous(), d_v=cfg.kv_lora_rank,
                          scale=cfg.scale)
        part = Partial(o=flat.o.reshape(q_abs.shape[:-1]
                                        + (cfg.kv_lora_rank,)),
                       m=flat.m.reshape(q_abs.shape[:-1]),
                       l=flat.l.reshape(q_abs.shape[:-1]))
    out = unabsorb_output(p, cfg, part.o[..., :cfg.kv_lora_rank].to(x.dtype))
    return out, new_entry


# ---------------------------------------------------------------------------
# Prefill form (absorbed, causal) — fills the latent cache while computing.
# ---------------------------------------------------------------------------

def mla_attention(p: MLA, cfg: MLAConfig, x, positions, *,
                  prefill_fn=flash_prefill):
    """Causal self-attention of x (B, S, D) -> (out (B, S, D), latent cache
    entries (B, S, d_qk)).

    prefill_fn is the attention inner op, (q (B, S, H, d_qk), ckv (B, S,
    d_qk), *, d_v, scale) -> (B, S, H, d_v) f32: the flash_prefill wrapper
    by default, or its plain version. Both take the queries and entries in
    the model's own dtype, uncast: a bf16 model's go to the bf16
    tensor-core kernel on the card, an f32 model's to the f32 one, and the
    plain version computes in f32 from either. The reference's `mask`
    argument has no caller and is left out."""
    q_nope, q_rope = project_q(p, cfg, x, positions)
    q_abs = absorb_query(p, cfg, q_nope, q_rope)            # (B, S, H, d_qk)
    entries = latent_cache_entries(p, cfg, x, positions)    # (B, S, d_qk)
    o_lat = local_heads(
        lambda q, c: prefill_fn(q.contiguous(), c.contiguous(),
                                d_v=cfg.kv_lora_rank, scale=cfg.scale),
        [q_abs, entries], (2, None))
    return unabsorb_output(p, cfg, o_lat.to(x.dtype)), entries


# ---------------------------------------------------------------------------
# Train form (decompressed, causal) — the reference's mla_attention.
# ---------------------------------------------------------------------------

def mla_attention_train(p: MLA, cfg: MLAConfig, x, positions):
    """Causal self-attention of x (B, S, D) in train form -> (out (B, S, D),
    latent cache entries (B, S, d_qk)).

    c^KV is decompressed into per-head k_nope and v; the rope band of the
    key is shared across heads. The logits q_nope.k_nope + q_rope.k_rope and
    the probabilities times v are computed in f32 from operands cast to f32
    (the reference's f32-accumulating einsums; torch.einsum on bf16 operands
    would return bf16; f64 for an f64 model), the causal band masked to
    -inf before the softmax."""
    S = x.shape[1]
    ct = L.compute_dtype(x.dtype)
    q_nope, q_rope = project_q(p, cfg, x, positions)
    entries = latent_cache_entries(p, cfg, x, positions)    # (B, S, d_qk)
    c_kv = entries[..., :cfg.kv_lora_rank]
    k_rope = entries[..., cfg.kv_lora_rank:]
    k_nope = L.project_heads(c_kv, p.k_up)
    v = L.project_heads(c_kv, p.v_up)

    def attend(q_nope, k_nope, q_rope, k_rope, v):
        logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
                  + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)) \
            * cfg.scale
        causal = torch.ones((S, S), dtype=torch.bool,
                            device=logits.device).tril()
        probs = torch.softmax(logits.masked_fill(~causal, float("-inf")),
                              dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    # on a mesh: each (batch row, head) on its own shard (local_heads)
    o = local_heads(attend, [q_nope.to(ct), k_nope.to(ct), q_rope.to(ct),
                             k_rope.to(ct), v.to(ct)],
                    (2, 2, 2, None, 2)).to(x.dtype)
    return L.merge_heads(o, p.o_proj), entries
