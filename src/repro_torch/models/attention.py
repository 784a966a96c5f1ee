"""Standard attention (MHA/GQA/MQA) with optional QKV bias (Qwen1.5/2.5),
qk-norm (Qwen3), RoPE, and a KV cache for decode: the counterpart of
repro.models.attention.

The KV cache entry here is the FETCH-heavy contrast case of the paper
(§2.1): per token per layer it is 2 * n_kv * head_dim * 2 B — for a kv=8,
d=128 GQA that is 4 KB vs MLA's 1.152 KB, and for MHA (kv=40) 20 KB.

The reference computes this attention with einsums, outside any Pallas
kernel, and so does the port: plain torch ops in the reference's form (two
products, a boolean mask, a softmax), no kernel of the repo and no SDPA.
Its two products take bf16 operands and return f32 logits and outputs
(preferred_element_type=f32); torch.einsum on bf16 operands would round
them to bf16, so _sdpa casts the operands to f32 (f64 for an f64 model)
and multiplies in that dtype. A bf16 product is exact in f32, so only the
order of the f32 sums differs from the reference's, as long as TF32 stays
off (torch.backends.cuda.matmul.allow_tf32, False by default). The softmax
runs in f32 and o returns to the query's dtype at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.merge import Partial
from repro_torch.distributed.sharding import local_heads
from repro_torch.models import layers as L
from repro_torch.models.module import param, zeros


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: Optional[int] = None     # explicit (Qwen3) or d_model/n_heads
    qkv_bias: bool = False             # Qwen1.5/2.5
    qk_norm: bool = False              # Qwen3
    rope_theta: float = 10000.0
    causal: bool = True                # False for encoder self-attn
    use_rope: bool = True              # False for Whisper (learned pos emb)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def scale(self) -> float:
        return 1.0 / np.sqrt(self.hd)

    @property
    def kv_bytes_token_layer(self) -> int:
        return 2 * self.n_kv_heads * self.hd * 2    # K+V, bf16


def init_attn(gen, cfg: AttnConfig, *, dtype, device,
              d_kv_src: Optional[int] = None):
    """q (d_model, H, hd), k/v (d_kv_src or d_model, Hkv, hd), o (H, hd,
    d_model), drawn in that order; zero biases (H, hd) / (Hkv, hd) with
    qkv_bias; rmsnorm scales over hd with qk_norm. d_kv_src: the source
    width of K/V (cross-attention reads encoder states)."""
    dm, hd = cfg.d_model, cfg.hd
    dkv = d_kv_src or dm
    kw = {"dtype": dtype, "device": device}
    p = {"q": param((dm, cfg.n_heads, hd), gen, axes=("embed", "heads", None),
                    **kw),
         "k": param((dkv, cfg.n_kv_heads, hd), gen, axes=("embed", "kv", None),
                    **kw),
         "v": param((dkv, cfg.n_kv_heads, hd), gen, axes=("embed", "kv", None),
                    **kw),
         "o": param((cfg.n_heads, hd, dm), gen, axes=("heads", None, "embed"),
                    **kw)}
    if cfg.qkv_bias:
        p["q_b"] = zeros((cfg.n_heads, hd), axes=("heads", None), **kw)
        p["k_b"] = zeros((cfg.n_kv_heads, hd), axes=("kv", None), **kw)
        p["v_b"] = zeros((cfg.n_kv_heads, hd), axes=("kv", None), **kw)
    if cfg.qk_norm:
        p["q_norm"] = L.init_rmsnorm(hd, **kw)
        p["k_norm"] = L.init_rmsnorm(hd, **kw)
    return p


def _project(p, cfg: AttnConfig, x, x_kv, positions, kv_positions):
    """q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd): the projections, then the
    biases, then qk-norm, then RoPE at rope_theta."""
    q = L.project_heads(x, p["q"])
    k = L.project_heads(x_kv, p["k"])
    v = L.project_heads(x_kv, p["v"])
    if "q_b" in p:
        q, k, v = q + p["q_b"], k + p["k_b"], v + p["v_b"]
    if "q_norm" in p:
        q = L.rmsnorm(p["q_norm"]["scale"], q)
        k = L.rmsnorm(p["k_norm"]["scale"], k)
    if cfg.use_rope:
        ct = L.compute_dtype(x.dtype)
        qc, qs = L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta, dtype=ct)
        q = L.apply_rope(q, qc[:, :, None], qs[:, :, None])
        kc, ks = L.rope_cos_sin(kv_positions, cfg.hd, cfg.rope_theta,
                                dtype=ct)
        k = L.apply_rope(k, kc[:, :, None], ks[:, :, None])
    return q, k, v


def _sdpa(cfg: AttnConfig, q, k, v, mask):
    """q (B, Sq, H, d), k/v (B, Sk, Hkv, d); mask (B or 1, Sq, Sk) of the
    pairs that attend, or None. GQA: the query heads fold into Hkv groups of
    H / Hkv. The products in f32 from operands cast to f32 (see the module
    docstring); returns (B, Sq, H, d) in q's dtype."""
    ct = L.compute_dtype(q.dtype)

    def attend(q, k, v):
        B, Sq, H, d = q.shape
        hkv = k.shape[2]                 # a shard's kv heads and its groups
        qg = q.reshape(B, Sq, hkv, H // hkv, d)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * cfg.scale
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
        return o.reshape(B, Sq, H, d)

    # on a mesh: each (batch row, kv head group) on its own shard
    return local_heads(attend, [q.to(ct), k.to(ct), v.to(ct)],
                       (2, 2, 2)).to(q.dtype)


def decode_partial(cfg: AttnConfig, q, k, v) -> Partial:
    """q (B, Sq, H, d) over every row of k/v (B, Sk, Hkv, d), no mask, as
    an online-softmax partial: o (B, Sq, H, d) normalised, m and l (B, Sq,
    H), in the compute dtype (f32; f64 for an f64 model). The products are
    _sdpa's attend's (operands cast, query heads folded into Hkv groups);
    the max and the sum are kept, so partials over a split of the rows
    merge (softmax_merge) to _sdpa over all of them. Plain tensors: a
    sequence shard's local rows (sharding.local_seq_partials)."""
    ct = L.compute_dtype(q.dtype)
    B, Sq, H, d = q.shape
    hkv = k.shape[2]
    qg = q.to(ct).reshape(B, Sq, hkv, H // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(ct)) * cfg.scale
    m = torch.amax(logits, dim=-1)
    w = torch.exp(logits - m[..., None])
    l = torch.sum(w, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w / l[..., None], v.to(ct))
    lead = lambda t: t.permute(0, 3, 1, 2).reshape(B, Sq, H)
    return Partial(o.reshape(B, Sq, H, d), lead(m), lead(l))


def attention(p, cfg: AttnConfig, x, positions, x_kv=None, kv_positions=None,
              mask=None):
    """Full-sequence form (train / prefill / encoder / cross-attn).

    Returns (out (B, Sq, D), (k, v)) — the cache entries, so prefill fills
    the KV store in the same pass. A causal config masks the tail-aligned
    lower triangle (query i sees keys up to i + Sk - Sq)."""
    x_kv = x if x_kv is None else x_kv
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _project(p, cfg, x, x_kv, positions, kv_positions)
    Sq, Sk = q.shape[1], k.shape[1]
    if cfg.causal:
        causal = torch.ones((Sq, Sk), dtype=torch.bool,
                            device=x.device).tril(Sk - Sq)[None]
        mask = causal if mask is None else (mask & causal)
    out = _sdpa(cfg, q, k, v, mask)
    out = L.merge_heads(out, p["o"])
    return out, (k, v)


def decode_step(p, cfg: AttnConfig, x, kv_cache, positions, cache_len=None):
    """One-token decode against a (B, S, Hkv, d) K/V cache.

    kv_cache: (k, v); cache_len (B,): valid prefix length of the static
    cache (None: all of it). The new entry is attended after the cache.
    Returns (out (B, 1, D), new (k, v) entry (B, 1, Hkv, d))."""
    k_cache, v_cache = kv_cache
    q, k_new, v_new = _project(p, cfg, x, x, positions, positions)
    k = torch.cat([k_cache, k_new], dim=1)
    v = torch.cat([v_cache, v_new], dim=1)
    S = k.shape[1]
    mask = None
    if cache_len is not None:
        pos = torch.arange(S, device=x.device)[None]
        valid = (pos < cache_len.to(x.device)[:, None]) | (pos == S - 1)
        mask = valid[:, None, :]                    # (B, Sq=1, Sk=S)
    out = _sdpa(cfg, q, k, v, mask)
    out = L.merge_heads(out, p["o"])
    return out, (k_new, v_new)
