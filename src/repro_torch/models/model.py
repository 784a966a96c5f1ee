"""The model: one ModelConfig drives the families the port runs — dense and
MoE transformers with MLA attention (DeepSeek-V2) and the attention-free SSM
(Mamba2).

Step functions, the counterparts of the reference's train step,
prefill_step and serve_step:
  * init_model         — parameters drawn on their device from a generator
  * train_forward /    — the train form (the reference's forward / loss_fn):
    loss_fn              decompressed MLA and the inline SSD intra-chunk
                         term, plain PyTorch ops under autograd, each block
                         recomputed in backward when cfg.remat is set; the
                         chunked cross-entropy plus 0.01 x the MoE aux term
  * forward / prefill  — the serving form's full-sequence pass; prefill
                         returns the last-token logits and the caches
  * init_decode_state  — the cache in the reference's layout
  * decode_step        — one token against a seq_len cache

Layers run as a Python loop over per-layer parameter trees (the reference
scans stacked parameters); the caches come out stacked on a leading layer
axis, as the reference's do: MLA {"dense_blocks": (k, B, S, d_qk), "blocks":
(L - k, B, S, d_qk)}, Mamba2 {"blocks": (h (L, B, H, P, N), conv (L, B,
d_conv - 1, C))}.

The serving form's attention, prefill and intra-chunk inner ops are an
explicit argument (`ops`), as the reference's
absorbed_decode(partial_fn=...) and ssd_chunked(use_kernel=...) are:
KERNELS (the hand-written kernels' wrappers, the default) or PLAIN (their
plain versions, the oracle a card run holds the kernels against). Nothing switches between them behind the caller's back;
the train form takes no ops (no kernel of the repo has a backward pass, and
the reference trains without its kernels).

GQA attention (models/attention.py) and the hybrid, audio and vlm families
are not ported yet (ROADMAP A.10) and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_prefill import flash_prefill, flash_prefill_ref
from repro_torch.kernels.mla_decode import mla_decode, mla_decode_ref
from repro_torch.kernels.sparse_select import sparse_select, sparse_select_ref
from repro_torch.kernels.ssd_chunk import ssd_intra_chunk, ssd_intra_chunk_ref
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.module import Tree, init_stacked


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    vocab: int
    # attention (gqa family)
    attn_type: str = "gqa"           # gqa | mla | none
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # mlp
    d_ff: int = 0
    mlp_kind: str = "swiglu"
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    # MLA
    mla: Optional[MLA.MLAConfig] = None
    # MoE
    moe: Optional[MOE.MoEConfig] = None
    first_k_dense: int = 0
    # SSM / hybrid
    ssm: Optional[SSM.Mamba2Config] = None
    hybrid_group: int = 0            # zamba2: shared attn after every group
    # enc-dec (whisper)
    encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500
    # vlm (llava)
    vlm_patches: int = 0
    # selection (paper technique: DSA-style top-k decode for long context)
    selection_k: int = 0
    # loss
    loss_chunk: int = 512
    remat: bool = True

    @property
    def attn_cfg(self):
        raise NotImplementedError(
            "GQA attention (models/attention.py) is not ported yet: "
            "ROADMAP A.10")

    @property
    def kv_bytes_token_layer(self) -> int:
        """FETCH-side payload coefficient for the predicate (§5.4)."""
        if self.attn_type == "mla":
            return self.mla.d_qk * 2
        if self.attn_type == "none":
            return 0
        return self.attn_cfg.kv_bytes_token_layer

    def norm_init(self):
        return (L.init_rmsnorm if self.norm_kind == "rmsnorm"
                else L.init_layernorm)

    def norm_apply(self):
        if self.norm_kind == "rmsnorm":
            return lambda p, x: L.rmsnorm(p["scale"], x)
        return L.layernorm


@dataclasses.dataclass(frozen=True)
class Ops:
    """The model path's inner ops, each with its kernel wrapper's signature:
    flash_prefill (q, ckv, *, d_v, scale); mla_decode (q, ckv, lengths, *,
    d_v, scale); sparse_select (q, ckv, block_idx, kb, lengths, *, d_v,
    scale, block_tokens); ssd_intra_chunk (x, dt, A, B, C)."""
    flash_prefill: Callable
    mla_decode: Callable
    sparse_select: Callable
    ssd_intra_chunk: Callable


KERNELS = Ops(flash_prefill, mla_decode, sparse_select, ssd_intra_chunk)
PLAIN = Ops(flash_prefill_ref, mla_decode_ref, sparse_select_ref,
            ssd_intra_chunk_ref)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family in ("dense", "moe") and cfg.attn_type == "mla":
        return
    if cfg.family == "ssm":
        return
    if cfg.family in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.attn_type} attention (models/attention.py) "
            "is not ported yet: ROADMAP A.10")
    raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not "
                              "ported yet: ROADMAP A.10")


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               *, device="cuda", dtype=torch.bfloat16) -> Tree:
    """The parameter tree, every tensor drawn from `generator` on `device`
    (None: the device's default generator) in the reference's order. On the
    meta device it holds shapes and dtypes only."""
    _check_supported(cfg)
    g, kw = generator, {"dtype": dtype, "device": device}
    ni = cfg.norm_init()
    p: Dict[str, Any] = {"embed": L.init_embed(g, cfg.vocab, cfg.d_model,
                                               **kw),
                         "final_norm": ni(cfg.d_model, **kw)}

    def block(moe_block: bool) -> Tree:
        b = {"ln1": ni(cfg.d_model, **kw), "ln2": ni(cfg.d_model, **kw),
             "attn": MLA.MLA(cfg.mla, generator=g, **kw)}
        if moe_block:
            b["moe"] = MOE.init_moe(g, cfg.moe, **kw)
        else:
            b["mlp"] = L.init_mlp(g, cfg.d_model, cfg.d_ff, cfg.mlp_kind, **kw)
        return Tree(b)

    if cfg.family == "dense":
        p["blocks"] = init_stacked(cfg.n_layers, lambda: block(False))
    elif cfg.family == "moe":
        if cfg.first_k_dense:
            p["dense_blocks"] = init_stacked(cfg.first_k_dense,
                                             lambda: block(False))
        p["blocks"] = init_stacked(cfg.n_layers - cfg.first_k_dense,
                                   lambda: block(True))
    else:                                               # ssm
        p["blocks"] = init_stacked(cfg.n_layers, lambda: Tree(
            {"ln": ni(cfg.d_model, **kw),
             "mamba": SSM.init_mamba2(g, cfg.ssm, **kw)}))
    return Tree(p)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _embed_inputs(params, batch):
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return x, positions


def _trunk(params, cfg: ModelConfig, x, positions, ops: Ops, routes,
           with_caches: bool):
    """The layer stack over x (B, S, D) -> (x, caches, aux)."""
    na = cfg.norm_apply()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {}
    if cfg.family == "ssm":
        hs, convs = [], []
        for lp in params["blocks"]:
            y, (hf, cs) = SSM.mamba2_forward(lp["mamba"], cfg.ssm,
                                             na(lp["ln"], x),
                                             intra=ops.ssd_intra_chunk)
            x = x + y
            if with_caches:
                hs.append(hf)
                convs.append(cs)
        if with_caches:
            caches["blocks"] = (torch.stack(hs), torch.stack(convs))
        return x, caches, aux

    def run(stack, moe_block: bool):
        nonlocal x, aux
        entries = []
        for lp in stack:
            h = na(lp["ln1"], x)
            attn_out, e = MLA.mla_attention(lp["attn"], cfg.mla, h, positions,
                                            prefill_fn=ops.flash_prefill)
            x = x + attn_out
            h = na(lp["ln2"], x)
            if moe_block:
                mo, a = MOE.moe_apply(lp["moe"], cfg.moe, h, routes)
                x = x + mo
                aux = aux + a
            else:
                x = x + L.mlp(lp["mlp"], h, cfg.mlp_kind)
            if with_caches:
                entries.append(e)
        return torch.stack(entries) if with_caches else None

    if cfg.family == "moe" and cfg.first_k_dense:
        caches["dense_blocks"] = run(params["dense_blocks"], False)
    caches["blocks"] = run(params["blocks"], cfg.family == "moe")
    return x, caches, aux


def forward(params, cfg: ModelConfig, batch, *, return_caches: bool = False,
            ops: Ops = KERNELS, routes: Optional[list] = None):
    """batch {"tokens": (B, S)} -> (logits (B, S, V), caches or None,
    aux_loss). When `routes` is a list, every MoE layer appends its top-k
    expert indices (T, k) to it, in layer order."""
    _check_supported(cfg)
    x, positions = _embed_inputs(params, batch)
    x, caches, aux = _trunk(params, cfg, x, positions, ops, routes,
                            return_caches)
    logits = L.unembed(params["embed"],
                       cfg.norm_apply()(params["final_norm"], x))
    return logits, (caches if return_caches else None), aux


def prefill(params, cfg: ModelConfig, batch, *, ops: Ops = KERNELS,
            routes: Optional[list] = None):
    """(last-token logits (B, 1, V), caches): forward with the caches, the
    head applied to the last position only (the reference slices the full
    logits)."""
    _check_supported(cfg)
    x, positions = _embed_inputs(params, batch)
    x, caches, _ = _trunk(params, cfg, x, positions, ops, routes, True)
    logits = L.unembed(params["embed"],
                       cfg.norm_apply()(params["final_norm"], x[:, -1:]))
    return logits, caches


# ---------------------------------------------------------------------------
# Train form and loss
# ---------------------------------------------------------------------------

def _train_block(lp, cfg: ModelConfig, moe_block: bool, positions, pinned,
                 x):
    """One layer in train form: x (B, S, D) -> (x', MoE aux or None, the
    MoE layer's top-k indices (T, k) or None). The indices are returned,
    not appended to a caller's list, so a block recomputed in backward does
    not record its routes twice."""
    na = cfg.norm_apply()
    if cfg.family == "ssm":
        y, _ = SSM.mamba2_forward(lp["mamba"], cfg.ssm, na(lp["ln"], x),
                                  intra=SSM.ssd_intra_chunk_train)
        return x + y, None, None
    attn_out, _ = MLA.mla_attention_train(lp["attn"], cfg.mla,
                                          na(lp["ln1"], x), positions)
    x = x + attn_out
    h = na(lp["ln2"], x)
    if moe_block:
        idx = []
        mo, aux = MOE.moe_apply(lp["moe"], cfg.moe, h, idx, pinned=pinned)
        return x + mo, aux, idx[0]
    return x + L.mlp(lp["mlp"], h, cfg.mlp_kind), None, None


def train_forward(params, cfg: ModelConfig, batch, *,
                  routes: Optional[list] = None,
                  pinned_routes: Optional[list] = None):
    """batch {"tokens": (B, S)} -> (logits (B, S, V), aux): the train form
    of every layer; with cfg.remat each block runs under
    torch.utils.checkpoint (non-reentrant), the counterpart of the
    reference's jax.checkpoint, keeping only its input for backward. When
    `routes` is a list, every MoE layer appends its top-k indices (T, k)
    once, in layer order; `pinned_routes`, such a list (another run's),
    makes each MoE layer take its entry in place of its own top-k
    (moe_apply(pinned=...))."""
    _check_supported(cfg)
    x, positions = _embed_inputs(params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stacks = [("blocks", cfg.family == "moe")]
    if cfg.family == "moe" and cfg.first_k_dense:
        stacks.insert(0, ("dense_blocks", False))
    pinned = iter(pinned_routes or ())
    for key, moe_block in stacks:
        for lp in params[key]:
            fn = functools.partial(
                _train_block, lp, cfg, moe_block, positions,
                next(pinned) if moe_block and pinned_routes else None)
            x, a, idx = (checkpoint(fn, x, use_reentrant=False) if cfg.remat
                         else fn(x))
            if a is not None:
                aux = aux + a
            if idx is not None and routes is not None:
                routes.append(idx)
    logits = L.unembed(params["embed"],
                       cfg.norm_apply()(params["final_norm"], x))
    return logits, aux


def loss_fn(params, cfg: ModelConfig, batch, *,
            routes: Optional[list] = None):
    """Mean next-token cross-entropy of batch {"tokens", "targets": (B, S)}
    plus 0.01 x the MoE aux term. The cross-entropy runs in chunks of the
    sequence, the largest chunk of at most cfg.loss_chunk that divides S,
    each chunk's logits in f32 (f64 for an f64 model)."""
    logits, aux = train_forward(params, cfg, batch, routes=routes)
    targets = batch["targets"].long()
    B, S, _ = logits.shape
    n_chunks = max(1, S // min(cfg.loss_chunk, S))
    while S % n_chunks:
        n_chunks += 1
    chunk = S // n_chunks
    ct = L.compute_dtype(logits.dtype)
    total = torch.zeros((), dtype=ct, device=logits.device)
    for i in range(n_chunks):
        lg = logits[:, i * chunk:(i + 1) * chunk].to(ct)
        tg = targets[:, i * chunk:(i + 1) * chunk]
        gold = torch.gather(lg, -1, tg[..., None])[..., 0]
        total = total + torch.sum(torch.logsumexp(lg, dim=-1) - gold)
    return total / (B * chunk * n_chunks) + 0.01 * aux


# ---------------------------------------------------------------------------
# Decode (serve_step): one token against a seq_len cache.
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int, *,
                      dtype=torch.bfloat16, device="cuda"):
    """The zero cache in the reference's layout (SSM states in f32)."""
    _check_supported(cfg)
    mk = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    if cfg.family == "ssm":
        s = cfg.ssm
        return {"blocks": (
            mk((cfg.n_layers, batch, s.n_heads, s.head_dim, s.d_state),
               torch.float32),
            mk((cfg.n_layers, batch, s.d_conv - 1,
                s.d_inner + 2 * s.d_state)))}
    mla_cache = lambda n: mk((n, batch, seq_len, cfg.mla.d_qk))
    if cfg.family == "moe" and cfg.first_k_dense:
        return {"dense_blocks": mla_cache(cfg.first_k_dense),
                "blocks": mla_cache(cfg.n_layers - cfg.first_k_dense)}
    return {"blocks": mla_cache(cfg.n_layers)}


def top_k_lowest_first(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, ties broken
    toward the lower index (as lax.top_k breaks them)."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def _mla_decode_cached(p, cfg: ModelConfig, x, cache, positions, widx: int,
                       ops: Ops):
    """Absorbed MLA decode of x (B, 1, D) over the whole static cache
    (B, S, d_qk), after writing the new entry at widx in place. Like the
    reference, it attends every slot, written or not (ROADMAP C). With
    selection_k > 0 it attends only the top-k entries of a mean-head latent
    score, in place through sparse_select at token granularity."""
    mcfg = cfg.mla
    q_nope, q_rope = MLA.project_q(p, mcfg, x, positions)
    q_abs = MLA.absorb_query(p, mcfg, q_nope, q_rope)       # (B, 1, H, d_qk)
    cache[:, widx] = MLA.latent_cache_entries(p, mcfg, x, positions)[:, 0]
    B, H = q_abs.shape[0], mcfg.n_heads
    q = q_abs.reshape(B, H, mcfg.d_qk).to(torch.float32).contiguous()
    ckv = cache.to(torch.float32)
    if cfg.selection_k:
        qi = torch.mean(q_abs[..., :mcfg.kv_lora_rank], dim=2)   # (B, 1, dc)
        scores = torch.einsum("bqc,bsc->bqs", qi,
                              cache[..., :mcfg.kv_lora_rank])
        sel = top_k_lowest_first(scores[:, 0], cfg.selection_k)
        part = ops.sparse_select(q, ckv, sel.to(torch.int32).contiguous(),
                                 None, None, d_v=mcfg.kv_lora_rank,
                                 scale=mcfg.scale, block_tokens=1)
    else:
        part = ops.mla_decode(q, ckv, None, d_v=mcfg.kv_lora_rank,
                              scale=mcfg.scale)
    o = part.o.reshape(B, 1, H, mcfg.kv_lora_rank).to(x.dtype)
    return MLA.unabsorb_output(p, mcfg, o)


def decode_step(params, cfg: ModelConfig, state, token, pos, widx: int, *,
                ops: Ops = KERNELS, routes: Optional[list] = None):
    """token (B, 1) -> (logits (B, 1, V), state). pos (B, 1) absolute
    positions; widx the cache slot to write. The state is updated in place
    (the cache is written at widx, the SSM states overwritten) and returned:
    a copy per step of the whole cache would cost more than the step."""
    _check_supported(cfg)
    x = L.embed(params["embed"], token)
    na = cfg.norm_apply()
    if cfg.family == "ssm":
        hs, convs = state["blocks"]
        for i, lp in enumerate(params["blocks"]):
            y, (h_new, conv_new) = SSM.mamba2_decode(
                lp["mamba"], cfg.ssm, na(lp["ln"], x), (hs[i], convs[i]))
            x = x + y
            hs[i].copy_(h_new)
            convs[i].copy_(conv_new)
    else:
        stacks = [("blocks", cfg.family == "moe")]
        if cfg.family == "moe" and cfg.first_k_dense:
            stacks.insert(0, ("dense_blocks", False))
        for key, moe_block in stacks:
            for lp, cache in zip(params[key], state[key]):
                h = na(lp["ln1"], x)
                x = x + _mla_decode_cached(lp["attn"], cfg, h, cache, pos,
                                           widx, ops)
                h = na(lp["ln2"], x)
                if moe_block:
                    x = x + MOE.moe_apply(lp["moe"], cfg.moe, h, routes)[0]
                else:
                    x = x + L.mlp(lp["mlp"], h, cfg.mlp_kind)
    logits = L.unembed(params["embed"], na(params["final_norm"], x))
    return logits, state
