"""The model: one ModelConfig drives every family of the reference — dense
GQA/MHA transformers (Qwen, Nemotron), MLA (DeepSeek-V2), MoE (with MLA or
GQA attention), the attention-free SSM (Mamba2), the hybrid (Zamba2: groups
of Mamba2 layers, each followed by one shared attention block), the VLM
(LLaVA: patch embeddings ahead of the text) and the encoder-decoder
(Whisper: a non-causal encoder, a decoder with cross-attention).

Step functions, the counterparts of the reference's train step,
prefill_step and serve_step:
  * init_model         — parameters drawn on their device from a generator
  * train_forward /    — the train form (the reference's forward / loss_fn):
    loss_fn              decompressed MLA and the inline SSD intra-chunk
                         term, plain PyTorch ops under autograd, each block
                         (each Mamba2 layer and each attention block)
                         recomputed in backward when cfg.remat is set, as
                         the reference's scans are (not the hybrid's shared
                         block, which its group scan runs whole); the
                         chunked cross-entropy plus 0.01 x the MoE aux term
  * forward / prefill  — the serving form's full-sequence pass; prefill
                         returns the last-token logits and the caches
  * init_decode_state  — the cache in the reference's layout;
    fill_decode_state    prefill's caches copied into it
  * decode_step        — one token against a seq_len cache

Layers run as a Python loop over per-layer parameter trees (the reference
scans stacked parameters; the hybrid's groups are a list of lists, as its
(n_groups, group, ...) stacks are); the caches come out stacked on the
leading layer axes, as the reference's do:
  * MLA: {"dense_blocks": (k, B, S, d_qk), "blocks": (L - k, B, S, d_qk)};
  * GQA: {"blocks": (k (L, B, S, Hkv, hd), v)} (and "dense_blocks");
  * Mamba2: {"blocks": (h (L, B, H, P, N), conv (L, B, d_conv - 1, C))};
  * hybrid: {"groups": ((h (ng, g, ...), conv (ng, g, ...)), (k (ng, B, S,
    Hkv, hd), v)), "rem": the remaining layers' (h, conv) or None};
  * audio: {"blocks": ((k, v) of self-attention (L, B, S, Hkv, hd), (k, v)
    of cross-attention (L, B, S_enc, Hkv, hd))}.

On a mesh (distributed.sharding, distributed.policy) the parameters and
the batch are DTensors and the step runs under a sharding policy: the
residual stream is constrained between blocks (sequence-parallel), a
block's normalised input has its sequence gathered ("block_in"), a
branch's output joins the residual in the residual's layout (_add); the
MoE runs its expert-parallel form on local tensors (_moe_call), the
attention cores per (batch row, head) shard (sharding.local_heads), the
cross-entropy vocab-parallel. Without a policy every constraint is a no-op
and the code is the single-device model's.

The serving form's attention, prefill and intra-chunk inner ops are an
explicit argument (`ops`), as the reference's
absorbed_decode(partial_fn=...) and ssd_chunked(use_kernel=...) are:
KERNELS (the hand-written kernels' wrappers, the default) or PLAIN (their
plain versions, the oracle a card run holds the kernels against). Nothing
switches between them behind the caller's back; the train form takes no ops
(no kernel of the repo has a backward pass, and the reference trains
without its kernels). GQA attention (models/attention.py) is einsums in
both forms, as in the reference: no kernel of the repo runs in it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import policy as POL
from repro_torch.distributed.sharding import (axis_sizes, copy_seq_prefix,
                                              dp_entry, is_dtensor,
                                              local_inputs,
                                              local_seq_partials,
                                              local_seq_selected, placements,
                                              splits, top_k_lowest_first,
                                              write_seq_row)
from repro_torch.kernels.flash_prefill import flash_prefill, flash_prefill_ref
from repro_torch.kernels.mla_decode import mla_decode, mla_decode_ref
from repro_torch.kernels.softmax_merge import softmax_merge, softmax_merge_ref
from repro_torch.kernels.sparse_select import sparse_select, sparse_select_ref
from repro_torch.kernels.ssd_chunk import ssd_intra_chunk, ssd_intra_chunk_ref
from repro_torch.models import attention as A
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
    def attn_cfg(self) -> A.AttnConfig:
        return A.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.head_dim, self.qkv_bias, self.qk_norm,
                            self.rope_theta,
                            use_rope=not self.encdec)

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
        """The norm; its output is a block's input, constrained as the
        policy's "block_in" (the sequence gathered before the projections,
        Megatron-SP; a no-op without a policy)."""
        if self.norm_kind == "rmsnorm":
            norm = lambda p, x: L.rmsnorm(p["scale"], x)
        else:
            norm = L.layernorm
        return lambda p, x: POL.constrain(norm(p, x), "block_in")


@dataclasses.dataclass(frozen=True)
class Ops:
    """The model path's inner ops, each with its kernel wrapper's signature:
    flash_prefill (q, ckv, *, d_v, scale); mla_decode (q, ckv, lengths, *,
    d_v, scale); sparse_select (q, ckv, block_idx, kb, lengths, *, d_v,
    scale, block_tokens); ssd_intra_chunk (x, dt, A, B, C); softmax_merge
    (o, m, l), which joins decode's partials across the ranks of a
    sequence-sharded cache."""
    flash_prefill: Callable
    mla_decode: Callable
    sparse_select: Callable
    ssd_intra_chunk: Callable
    softmax_merge: Callable


KERNELS = Ops(flash_prefill, mla_decode, sparse_select, ssd_intra_chunk,
              softmax_merge)
PLAIN = Ops(flash_prefill_ref, mla_decode_ref, sparse_select_ref,
            ssd_intra_chunk_ref, softmax_merge_ref)


# ---------------------------------------------------------------------------
# MoE execution: under a sharding policy whose mesh has a `model` dim, the
# expert layer runs on local tensors (the reference runs it under
# shard_map): activations replicated over `model` within a data shard, each
# shard computes its resident experts, one all-reduce over `model`
# combines. DTensor has no sharding rule for the dispatch's argsort or
# searchsorted.
# ---------------------------------------------------------------------------

# each MoE parameter's spec inside the block: the expert stacks over
# `model`, the shared FFN's width over `model`, the router replicated
_MOE_SPECS = {"router": (), "gate": ("model",), "up": ("model",),
              "down": ("model",), "sh_gate": (None, "model"),
              "sh_up": (None, "model"), "sh_down": ("model",)}


def _moe_spec(name: str, ep: str):
    """_MOE_SPECS[name] with the expert dim named ep."""
    return tuple(ep if a == "model" else a for a in _MOE_SPECS[name])


def _moe_call(p_moe, cfg: ModelConfig, x, routes=None, pinned=None,
              ep_axis: Optional[str] = None):
    """moe_apply, or under a policy whose mesh has the dim ep_axis (None:
    "model") its expert-parallel form over that dim: x (B, S, D)
    and the parameters brought to the block's placements and taken as
    local tensors, each local gradient declared for what it is (a sum over
    the data shards and the expert dim's ranks, or a shard), the aux term
    averaged over the data shards. Returns (y as a DTensor, aux); `routes`
    gets this shard's top-k indices as a DTensor over the batch. `pinned`
    (T, k), a plain tensor or a DTensor, gives each data shard its rows,
    those of its tokens (_token_rows)."""
    pol = POL.current()
    sizes = {} if pol is None else axis_sizes(pol.mesh)
    ep = ep_axis or "model"
    if ep not in sizes:
        return MOE.moe_apply(p_moe, cfg.moe, x, routes, pinned=pinned)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, names = pol.mesh, list(sizes)
    dp = [a for a in ("pod", "data") if a in sizes]
    n_dp = math.prod(sizes[a] for a in dp)
    split = splits(x.shape[0], mesh, tuple(dp))   # tokens split over dp
    x_spec = (dp_entry(mesh) if split else None, None, None)
    # the block is split over the expert dim (the stacks, the shared
    # FFN's width) and the data dims that split the tokens: the router's
    # and x's local gradients are partial sums over those (local_inputs)
    keys = [k for k, _ in p_moe.named_parameters()]
    *local, xl = local_inputs(mesh, [(p_moe[k], _moe_spec(k, ep))
                                     for k in keys] + [(x, x_spec)])
    own = []
    out_pl = placements(x_spec, mesh)
    if pinned is not None:
        pinned = _token_rows(pinned, mesh, out_pl)
    y, aux = MOE.moe_apply(dict(zip(keys, local)), cfg.moe, xl, own,
                           pinned=pinned, ep_axis=MOE.ExpertAxis(mesh, ep))
    if routes is not None:
        routes.append(DTensor.from_local(own[0], mesh, out_pl,
                                         run_check=False))
    # the mean over the data shards as a sum of aux / (n_dp * n_model),
    # partial over those dims: each rank's gradient is then its share
    n_sum = (n_dp if split else 1) * sizes[ep]
    aux = DTensor.from_local(
        aux / n_sum, mesh,
        [Partial() if a == ep or (split and a in dp) else Replicate()
         for a in names], run_check=False)
    return (DTensor.from_local(y, mesh, out_pl, run_check=False),
            aux.redistribute(mesh, [Replicate()] * len(names)))


def _token_rows(pinned, mesh, pl):
    """Pinned routes (T, k) brought to the tokens' placements pl (the batch
    over the data dims where it splits) and taken as this shard's local
    rows: the rows of the tokens the shard holds, as x (B, S, D) flattens
    to (T, D). A plain tensor (on the mesh's device) is every shard's
    whole list (the unsharded run's), a DTensor is redistributed (a run's
    own recorded routes)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(pinned, DTensor):
        pinned = DTensor.from_local(pinned, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    return pinned.redistribute(mesh, pl).to_local()


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               *, device="cuda", dtype=torch.bfloat16) -> Tree:
    """The parameter tree, every tensor drawn from `generator` on `device`
    (None: the device's default generator) in the reference's order. On the
    meta device it holds shapes and dtypes only."""
    g, kw = generator, {"dtype": dtype, "device": device}
    norm = lambda: cfg.norm_init()(cfg.d_model, **kw)
    p: Dict[str, Any] = {"embed": L.init_embed(g, cfg.vocab, cfg.d_model,
                                               **kw),
                         "final_norm": norm()}

    def attn(acfg: Optional[A.AttnConfig] = None):
        if cfg.attn_type == "mla":
            return MLA.MLA(cfg.mla, generator=g, **kw)
        return A.init_attn(g, acfg or cfg.attn_cfg, **kw)

    def mlp():
        return L.init_mlp(g, cfg.d_model, cfg.d_ff, cfg.mlp_kind, **kw)

    def block(moe_block: bool) -> Tree:
        b = {"ln1": norm(), "ln2": norm(), "attn": attn()}
        if moe_block:
            b["moe"] = MOE.init_moe(g, cfg.moe, **kw)
        else:
            b["mlp"] = mlp()
        return Tree(b)

    def mamba() -> Tree:
        return Tree({"ln": norm(), "mamba": SSM.init_mamba2(g, cfg.ssm, **kw)})

    if cfg.family in ("dense", "vlm"):
        p["blocks"] = init_stacked(cfg.n_layers, lambda: block(False))
    elif cfg.family == "moe":
        if cfg.first_k_dense:
            p["dense_blocks"] = init_stacked(cfg.first_k_dense,
                                             lambda: block(False))
        p["blocks"] = init_stacked(cfg.n_layers - cfg.first_k_dense,
                                   lambda: block(True))
    elif cfg.family == "ssm":
        p["blocks"] = init_stacked(cfg.n_layers, mamba)
    elif cfg.family == "hybrid":
        n_groups, rem = divmod(cfg.n_layers, cfg.hybrid_group)
        p["groups"] = init_stacked(
            n_groups, lambda: init_stacked(cfg.hybrid_group, mamba))
        if rem:
            p["rem"] = init_stacked(rem, mamba)
        # the SHARED attention block: one set of weights, reused after every
        # group (Zamba2's shared transformer block without its
        # per-invocation LoRA, as the reference simplifies it)
        p["shared_attn"] = {"ln": norm(), "attn": attn(), "ln2": norm(),
                            "mlp": mlp()}
    elif cfg.family == "audio":
        enc_cfg = dataclasses.replace(cfg.attn_cfg, causal=False)
        p["enc_blocks"] = init_stacked(cfg.n_enc_layers, lambda: Tree(
            {"ln1": norm(), "attn": attn(enc_cfg), "ln2": norm(),
             "mlp": mlp()}))
        p["enc_norm"] = norm()
        p["blocks"] = init_stacked(cfg.n_layers, lambda: Tree(
            {"ln1": norm(), "attn": attn(), "lnx": norm(), "xattn": attn(),
             "ln2": norm(), "mlp": mlp()}))
    else:
        raise ValueError(cfg.family)
    return Tree(p)


# ---------------------------------------------------------------------------
# The full-sequence pass, in serving form (forward, prefill) and in train
# form (train_forward, loss_fn)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Form:
    """How the layers run: the MLA attention, (p, mcfg, h, positions) ->
    (out, entries); the SSD intra-chunk op; whether each block runs under
    torch.utils.checkpoint."""
    mla: Callable
    intra: Callable
    remat: bool


def _serving(ops: Ops) -> _Form:
    return _Form(functools.partial(MLA.mla_attention,
                                   prefill_fn=ops.flash_prefill),
                 SSM.serving_intra(ops.ssd_intra_chunk), False)


def _training(cfg: ModelConfig) -> _Form:
    """The reference's forward: decompressed MLA, the inline SSD term, each
    block under checkpoint (non-reentrant, the counterpart of
    jax.checkpoint: only its input is kept for backward) with cfg.remat."""
    return _Form(MLA.mla_attention_train, SSM.ssd_intra_chunk_train,
                 cfg.remat)


def _run(fn, x, remat: bool):
    """fn(x), under checkpoint with remat. The recompute in backward runs
    under the sharding policy of the forward: on the card the autograd
    engine runs backward in a thread of its own, which the policy's
    context variable does not reach."""
    if not remat:
        return fn(x)
    pol = POL.current()

    def body(h):
        with POL.use_policy(pol):
            return fn(h)
    return checkpoint(body, x, use_reentrant=False)


def _stacked(entries):
    """Per-layer cache entries (tensors or tuples of them) -> the same
    structure with each leaf stacked on a new leading layer axis, as the
    reference's scans stack them."""
    if isinstance(entries[0], tuple):
        return tuple(_stacked(list(e)) for e in zip(*entries))
    return torch.stack(entries)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _add(x, y):
    """x + y for a block's branch output y joining the residual x: under a
    policy y first takes the residual's layout (a reduce-scatter of its
    partial sums over `model`), so that its gradient comes back to the
    branch in the branch's own layout, the sequence whole: a gradient
    sharded over the sequence would reach the branch's product, whose view
    of (batch, sequence) as one dim torch 2.11's DTensor refuses."""
    return x + POL.constrain(y, "residual")


def _block(lp, cfg: ModelConfig, form: _Form, moe_block: bool, positions,
           pinned, ep_axis, x):
    """One transformer layer: x (B, S, D) -> (x', its cache entry, MoE aux
    or None, the MoE layer's top-k indices (T, k) or None). The indices are
    returned, not appended to a caller's list, so a block recomputed in
    backward does not record its routes twice."""
    na = cfg.norm_apply()
    h = na(lp["ln1"], x)
    if cfg.attn_type == "mla":
        attn_out, entry = form.mla(lp["attn"], cfg.mla, h, positions)
    else:
        attn_out, entry = A.attention(lp["attn"], cfg.attn_cfg, h, positions)
    x = _add(x, attn_out)
    h = na(lp["ln2"], x)
    if moe_block:
        idx = []
        mo, aux = _moe_call(lp["moe"], cfg, h, idx, pinned, ep_axis)
        return _add(x, mo), entry, aux, idx[0]
    return _add(x, L.mlp(lp["mlp"], h, cfg.mlp_kind)), entry, None, None


def _mamba_layer(lp, cfg: ModelConfig, form: _Form, x):
    """One Mamba2 layer: x -> (x', (h_final, conv_state))."""
    y, state = SSM.mamba2_forward(lp["mamba"], cfg.ssm,
                                  cfg.norm_apply()(lp["ln"], x),
                                  intra=form.intra)
    return _add(x, y), state


def _mamba_stack(stack, cfg: ModelConfig, form: _Form, x,
                 with_caches: bool):
    states = []
    for lp in stack:
        x = POL.constrain(x, "residual")
        x, st = _run(functools.partial(_mamba_layer, lp, cfg, form), x,
                     form.remat)
        if with_caches:
            states.append(st)
    return x, (_stacked(states) if with_caches else None)


def _hybrid(params, cfg: ModelConfig, form: _Form, x, positions,
            with_caches: bool):
    """Each group's Mamba2 layers, then the shared attention block (not
    under checkpoint: the reference scans the groups with remat=False),
    then the remaining layers."""
    na = cfg.norm_apply()
    sa = params["shared_attn"]
    groups = []
    for gp in params["groups"]:
        x = POL.constrain(x, "residual")
        x, states = _mamba_stack(gp, cfg, form, x, with_caches)
        attn_out, kv = A.attention(sa["attn"], cfg.attn_cfg,
                                   na(sa["ln"], x), positions)
        x = _add(x, attn_out)
        x = _add(x, L.mlp(sa["mlp"], na(sa["ln2"], x), cfg.mlp_kind))
        if with_caches:
            groups.append((states, kv))
    rem = None
    if "rem" in params:
        x, rem = _mamba_stack(params["rem"], cfg, form, x, with_caches)
    if not with_caches:
        return x, {}
    return x, {"groups": _stacked(groups) if groups
               else _no_groups(cfg, x), "rem": rem}


def _no_groups(cfg: ModelConfig, x):
    """The group caches of a hybrid shallower than one group, as the
    reference's scan over zero groups returns them: ((h (0, group, B, H, P,
    N) in f32, conv (0, group, B, d_conv - 1, C)), (k, v) (0, B, S, Hkv,
    hd)), the conv tail and K/V in x's dtype."""
    s, a = cfg.ssm, cfg.attn_cfg
    lead = (0, cfg.hybrid_group, x.shape[0])
    mk = lambda shape, dt=x.dtype: torch.zeros(shape, dtype=dt,
                                               device=x.device)
    kv = (0,) + tuple(x.shape[:2]) + (a.n_kv_heads, a.hd)
    return ((mk(lead + (s.n_heads, s.head_dim, s.d_state), torch.float32),
             mk(lead + (s.d_conv - 1, s.d_inner + 2 * s.d_state))),
            (mk(kv), mk(kv)))


def _audio(params, cfg: ModelConfig, form: _Form, batch, with_caches: bool):
    """Whisper-style encoder-decoder: the frame embeddings (B, S_enc, D)
    (the conv frontend is a stub) through the non-causal encoder, then the
    tokens (B, S) through the decoder's self- and cross-attention. No
    position enters (no RoPE, use_rope False). The frames are taken in the
    model's dtype (torch multiplies like dtypes only; the reference promotes
    a bf16 frame to an f32 model's dtype in its first product)."""
    na = cfg.norm_apply()
    enc_cfg = dataclasses.replace(cfg.attn_cfg, causal=False)
    xe = batch["frame_embeds"].to(params["embed"]["table"].dtype)
    B, Se = xe.shape[:2]
    pos_e = _positions(B, Se, xe.device)

    def enc_block(lp, h):
        ao, _ = A.attention(lp["attn"], enc_cfg, na(lp["ln1"], h), pos_e)
        h = _add(h, ao)
        return _add(h, L.mlp(lp["mlp"], na(lp["ln2"], h), cfg.mlp_kind))

    for lp in params["enc_blocks"]:
        xe = POL.constrain(xe, "residual")
        xe = _run(functools.partial(enc_block, lp), xe, form.remat)
    xe = na(params["enc_norm"], xe)

    x = L.embed(params["embed"], batch["tokens"])
    pos_d = _positions(B, x.shape[1], x.device)

    def dec_block(lp, h):
        ao, self_kv = A.attention(lp["attn"], cfg.attn_cfg, na(lp["ln1"], h),
                                  pos_d)
        h = _add(h, ao)
        xo, cross_kv = A.attention(lp["xattn"], enc_cfg, na(lp["lnx"], h),
                                   pos_d, x_kv=xe, kv_positions=pos_e)
        h = _add(h, xo)
        return (_add(h, L.mlp(lp["mlp"], na(lp["ln2"], h), cfg.mlp_kind)),
                (self_kv, cross_kv))

    entries = []
    for lp in params["blocks"]:
        x = POL.constrain(x, "residual")
        x, e = _run(functools.partial(dec_block, lp), x, form.remat)
        if with_caches:
            entries.append(e)
    return x, ({"blocks": _stacked(entries)} if with_caches else {})


def _hidden(params, cfg: ModelConfig, batch, form: _Form, *, routes=None,
            pinned=None, with_caches: bool = False,
            ep_axis: Optional[str] = None):
    """batch -> (the last layer's output at the text positions (B, S, D),
    caches ({} without with_caches), MoE aux). batch holds "tokens" (B, S),
    and "patch_embeds" (B, vlm_patches, D) for the VLM (placed ahead of the
    text) or "frame_embeds" (B, S_enc, D) for the audio model. When
    `routes` is a list, every MoE layer appends its top-k indices (T, k) to
    it once, in layer order; `pinned`, such a list (another run's), makes
    each MoE layer take its entry in place of its own top-k. ep_axis: the
    mesh dim the MoE experts split over under a sharding policy (None:
    "model")."""
    aux = torch.zeros((), dtype=torch.float32,
                      device=batch["tokens"].device)
    if cfg.family == "audio":
        x, caches = _audio(params, cfg, form, batch, with_caches)
        return x, caches, aux
    x = L.embed(params["embed"], batch["tokens"])
    if cfg.family == "vlm":
        # the anyres frontend stub: precomputed patch embeddings prepended
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    positions = _positions(*x.shape[:2], x.device)
    caches = {}
    if cfg.family == "ssm":
        x, caches["blocks"] = _mamba_stack(params["blocks"], cfg, form, x,
                                           with_caches)
    elif cfg.family == "hybrid":
        x, caches = _hybrid(params, cfg, form, x, positions, with_caches)
    else:
        stacks = [("blocks", cfg.family == "moe")]
        if cfg.family == "moe" and cfg.first_k_dense:
            stacks.insert(0, ("dense_blocks", False))
        pinned = iter(pinned or ())
        for key, moe_block in stacks:
            entries = []
            for lp in params[key]:
                fn = functools.partial(_block, lp, cfg, form, moe_block,
                                       positions,
                                       next(pinned, None) if moe_block
                                       else None, ep_axis)
                # the sequence-parallel residual (a no-op without a policy)
                x = POL.constrain(x, "residual")
                x, e, a, idx = _run(fn, x, form.remat)
                if a is not None:
                    aux = aux + a
                if idx is not None and routes is not None:
                    routes.append(idx)
                if with_caches:
                    entries.append(e)
            if with_caches:
                caches[key] = _stacked(entries)
    if cfg.family == "vlm":
        x = x[:, cfg.vlm_patches:]               # logits over the text
    return x, (caches if with_caches else {}), aux


def _logits(params, cfg: ModelConfig, x):
    return L.unembed(params["embed"],
                     cfg.norm_apply()(params["final_norm"], x))


def forward(params, cfg: ModelConfig, batch, *, return_caches: bool = False,
            ops: Ops = KERNELS, routes: Optional[list] = None):
    """batch (see _hidden) -> (logits (B, S, V) over the text positions,
    caches or None, aux_loss). When `routes` is a list, every MoE layer
    appends its top-k expert indices (T, k) to it, in layer order."""
    x, caches, aux = _hidden(params, cfg, batch, _serving(ops), routes=routes,
                             with_caches=return_caches)
    return _logits(params, cfg, x), (caches if return_caches else None), aux


def prefill(params, cfg: ModelConfig, batch, *, ops: Ops = KERNELS,
            routes: Optional[list] = None, pinned: Optional[list] = None):
    """(last-token logits (B, 1, V), caches): forward with the caches, the
    head applied to the last position only (the reference slices the full
    logits). `pinned`, a list of one (T, k) tensor a MoE layer in layer
    order (as `routes` records them, another run's), makes each MoE layer
    take its entry in place of its own top-k: a checking hook."""
    x, caches, _ = _hidden(params, cfg, batch, _serving(ops), routes=routes,
                           pinned=pinned, with_caches=True)
    return _logits(params, cfg, x[:, -1:]), caches


def train_forward(params, cfg: ModelConfig, batch, *,
                  routes: Optional[list] = None,
                  pinned_routes: Optional[list] = None,
                  ep_axis: Optional[str] = None):
    """batch (see _hidden) -> (logits (B, S, V) over the text positions,
    aux): the train form of every layer; with cfg.remat each block runs
    under torch.utils.checkpoint (non-reentrant), the counterpart of the
    reference's jax.checkpoint, keeping only its input for backward. When
    `routes` is a list, every MoE layer appends its top-k indices (T, k)
    once, in layer order; `pinned_routes`, such a list (another run's),
    makes each MoE layer take its entry in place of its own top-k
    (moe_apply(pinned=...)). ep_axis: see _hidden."""
    x, _, aux = _hidden(params, cfg, batch, _training(cfg), routes=routes,
                        pinned=pinned_routes, ep_axis=ep_axis)
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch, *,
            routes: Optional[list] = None,
            pinned_routes: Optional[list] = None,
            ep_axis: Optional[str] = None):
    """Mean next-token cross-entropy of batch {"tokens", "targets": (B, S),
    and the family's stub inputs} plus 0.01 x the MoE aux term. The
    cross-entropy runs in chunks of the sequence, the largest chunk of at
    most cfg.loss_chunk that divides S, each chunk's logits in f32 (f64 for
    an f64 model). routes, pinned_routes, ep_axis: train_forward's."""
    logits, aux = train_forward(params, cfg, batch, routes=routes,
                                pinned_routes=pinned_routes, ep_axis=ep_axis)
    logits = POL.constrain(logits, "logits")
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
        total = total + _ce_sum(lg, tg)
    loss = total / (B * chunk * n_chunks) + 0.01 * aux
    return _replicated(loss)


def _replicated(t):
    """A DTensor as a replicated one (a scalar loss partial over the data
    shards is all-reduced); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _ce_sum(lg, tg):
    """The sum over (B, c) of logsumexp(lg) - lg at the target: lg (B, c, V)
    in the compute dtype, tg (B, c) int64."""
    from torch.distributed.tensor import DTensor
    if isinstance(lg, DTensor):
        return _ce_sum_vocab_parallel(lg, tg)
    gold = torch.gather(lg, -1, tg[..., None])[..., 0]
    return torch.sum(torch.logsumexp(lg, dim=-1) - gold)


def _ce_sum_vocab_parallel(lg, tg):
    """_ce_sum of DTensor logits, vocab-parallel (Megatron-style) on local
    tensors: the logits brought to tokens over the data dims and the vocab
    over `model` (each where it divides), then the max (as a stabiliser,
    no gradient), the sum of exponentials and the target's logit each
    all-reduced over `model`. DTensor's gather over the sharded vocab dim
    has no reduction that works here. Returns a DTensor scalar, a partial
    sum over the data dims that split the tokens."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = lg.device_mesh
    sizes = axis_sizes(mesh)
    names = list(sizes)
    dp = [a for a in ("pod", "data") if a in sizes]
    B, _, V = lg.shape
    b_entry = dp_entry(mesh) if dp and \
        B % math.prod(sizes[a] for a in dp) == 0 else None
    v_split = "model" in sizes and V % sizes["model"] == 0
    if not isinstance(tg, DTensor):
        tg = DTensor.from_local(tg, mesh, [Replicate()] * len(names),
                                run_check=False)
    local, tg_l = local_inputs(mesh, [
        (lg, (b_entry, None, "model" if v_split else None)),
        (tg, (b_entry, None))])
    tok = placements((b_entry, None), mesh)

    def over_vocab(t, op="sum"):
        if not v_split:
            return t
        part = [Partial(op) if a == "model" else p
                for a, p in zip(names, tok)]
        return DTensor.from_local(t, mesh, part, run_check=False) \
            .redistribute(mesh, tok).to_local()

    v_loc = local.shape[-1]
    off = mesh.get_local_rank("model") * v_loc if v_split else 0
    m = over_vocab(local.detach().amax(dim=-1), "max")
    lse = m + torch.log(over_vocab(
        torch.sum(torch.exp(local - m[..., None]), dim=-1)))
    mine = (tg_l >= off) & (tg_l < off + v_loc)
    idx = torch.where(mine, tg_l - off, 0)
    gold = over_vocab(torch.where(
        mine, torch.gather(local, -1, idx[..., None])[..., 0], 0.0))
    return DTensor.from_local(torch.sum(lse - gold), mesh,
                              [Partial() if b_entry and a in dp
                               else Replicate() for a in names],
                              run_check=False)


# ---------------------------------------------------------------------------
# Decode (serve_step): one token against a seq_len cache.
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int, *,
                      dtype=torch.bfloat16, device="cuda"):
    """The zero cache in the reference's layout (SSM states in f32): MLA
    (L, B, S, d_qk); GQA (k, v) (L, B, S, Hkv, hd); Mamba2 (h (L, B, H, P,
    N), conv (L, B, d_conv - 1, C)); the hybrid {"groups": (h, conv) with
    leading (n_groups, group), "shared_kv": (k, v) (n_groups, B, S, Hkv,
    hd), "rem": (h, conv)}; the audio model {"self": (k, v) (L, B, S, Hkv,
    hd), "cross": (k, v) (L, B, enc_seq, Hkv, hd)}."""
    mk = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)

    def gqa_cache(n, s=seq_len):
        a = cfg.attn_cfg
        return (mk((n, batch, s, a.n_kv_heads, a.hd)),
                mk((n, batch, s, a.n_kv_heads, a.hd)))

    def attn_cache(n):
        if cfg.attn_type == "mla":
            return mk((n, batch, seq_len, cfg.mla.d_qk))
        return gqa_cache(n)

    def ssm_state(*lead):
        s = cfg.ssm
        return (mk(lead + (batch, s.n_heads, s.head_dim, s.d_state),
                   torch.float32),
                mk(lead + (batch, s.d_conv - 1, s.d_inner + 2 * s.d_state)))

    if cfg.family in ("dense", "vlm"):
        return {"blocks": attn_cache(cfg.n_layers)}
    if cfg.family == "moe":
        st = {}
        if cfg.first_k_dense:
            st["dense_blocks"] = attn_cache(cfg.first_k_dense)
        st["blocks"] = attn_cache(cfg.n_layers - cfg.first_k_dense)
        return st
    if cfg.family == "ssm":
        return {"blocks": ssm_state(cfg.n_layers)}
    if cfg.family == "hybrid":
        n_groups, rem = divmod(cfg.n_layers, cfg.hybrid_group)
        st = {"groups": ssm_state(n_groups, cfg.hybrid_group),
              "shared_kv": gqa_cache(n_groups)}
        if rem:
            st["rem"] = ssm_state(rem)
        return st
    if cfg.family == "audio":
        return {"self": gqa_cache(cfg.n_layers),
                "cross": gqa_cache(cfg.n_layers, s=cfg.enc_seq)}
    raise ValueError(cfg.family)


def _copy_in(dst, src, seq_axis: Optional[int]) -> None:
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_in(d, s, seq_axis)
    elif seq_axis is None:
        dst.copy_(src)
    else:
        copy_seq_prefix(dst, src, seq_axis)


def fill_decode_state(cfg: ModelConfig, state, caches):
    """Copy prefill's caches into a decode state (init_decode_state's), in
    place, and return it: the attention caches' S positions into its first
    S slots, the SSM states and the audio model's cross-attention K/V
    whole. On a mesh (a state laid out by decode_state_shardings) each
    rank writes the slots of its own sequence shard (copy_seq_prefix)."""
    if cfg.family == "ssm":
        _copy_in(state["blocks"], caches["blocks"], None)
    elif cfg.family == "hybrid":
        states, kv = caches["groups"]
        _copy_in(state["groups"], states, None)
        _copy_in(state["shared_kv"], kv, 2)
        if "rem" in state:
            _copy_in(state["rem"], caches["rem"], None)
    elif cfg.family == "audio":
        self_kv, cross_kv = caches["blocks"]
        _copy_in(state["self"], self_kv, 2)
        _copy_in(state["cross"], cross_kv, None)
    else:
        for key, c in caches.items():
            _copy_in(state[key], c, 2)
    return state


def _mla_decode_cached(p, cfg: ModelConfig, x, cache, positions, widx: int,
                       ops: Ops):
    """Absorbed MLA decode of x (B, 1, D) over the whole static cache
    (B, S, d_qk), after writing the new entry at widx in place. Like the
    reference, it attends every slot, written or not (ROADMAP C.1). With
    selection_k > 0 it attends only the top-k entries of a mean-head latent
    score, in place through sparse_select at token granularity. The kernels
    take the model's dtype and compute in f32.

    On a mesh (the cache a DTensor over the sequence, decode_state_shardings)
    the entry is written by the rank that holds slot widx and the attention
    runs per sequence shard, the partials merged across the shards: dense
    through sharding.local_seq_partials, selection through
    sharding.local_seq_selected (each shard scores its rows, one gather of
    the shards' candidates picks the global top-k, each shard attends the
    chosen rows it holds). The kernel wrappers take each rank's local
    tensors."""
    mcfg = cfg.mla
    q_nope, q_rope = MLA.project_q(p, mcfg, x, positions)
    q_abs = MLA.absorb_query(p, mcfg, q_nope, q_rope)       # (B, 1, H, d_qk)
    write_seq_row(cache, widx,
                  MLA.latent_cache_entries(p, mcfg, x, positions)[:, 0])
    B, H = q_abs.shape[0], mcfg.n_heads
    q = q_abs.reshape(B, H, mcfg.d_qk).contiguous()
    if cfg.selection_k:
        qi = torch.mean(q_abs[..., :mcfg.kv_lora_rank], dim=2)   # (B, 1, dc)
        part = local_seq_selected(
            lambda ql, cl, ids, kb: ops.sparse_select(
                ql, cl, ids, kb, None, d_v=mcfg.kv_lora_rank,
                scale=mcfg.scale, block_tokens=1),
            ops.softmax_merge, q, qi, cache, cfg.selection_k)
    else:
        part = local_seq_partials(
            lambda ql, cl: ops.mla_decode(ql, cl, None, d_v=mcfg.kv_lora_rank,
                                          scale=mcfg.scale),
            ops.softmax_merge, q, cache)
    o = part.o.reshape(B, 1, H, mcfg.kv_lora_rank).to(x.dtype)
    return MLA.unabsorb_output(p, mcfg, o)


def _gqa_decode_cached(p, acfg: A.AttnConfig, x, cache, positions,
                       widx: int, ops: Ops):
    """GQA decode of x (B, 1, D) over the whole static cache (k, v) (B, S,
    Hkv, hd), after writing the new entry at widx in place. Like the
    reference, it attends every slot, written or not (ROADMAP C.1): an
    unwritten slot's zero key scores 0 and its zero value takes softmax
    weight. The products are einsums (models/attention.py), no kernel.

    On a mesh (k and v DTensors over the sequence, decode_state_shardings)
    the entry is written by the rank that holds slot widx
    (sharding.write_seq_row), each rank attends its own rows with every
    head (attention.decode_partial) and the partials merge across the
    shards with ops.softmax_merge (sharding.local_seq_partials): the query
    moves, the K/V cache stays."""
    k_cache, v_cache = cache
    q, k_new, v_new = A._project(p, acfg, x, x, positions, positions)
    write_seq_row(k_cache, widx, k_new[:, 0])
    write_seq_row(v_cache, widx, v_new[:, 0])
    if not is_dtensor(k_cache):
        out = A._sdpa(acfg, q, k_cache, v_cache, None)
    else:
        out = local_seq_partials(
            lambda ql, kv: A.decode_partial(acfg, ql, *kv), ops.softmax_merge,
            q, cache).o.to(x.dtype)
    return L.merge_heads(out, p["o"])


def _layer(cache, i: int):
    """Layer i's cache: a tensor's, or each of a tuple's."""
    if isinstance(cache, tuple):
        return tuple(c[i] for c in cache)
    return cache[i]


def _decode_mamba(stack, cfg: ModelConfig, state, x):
    """The stack's recurrent step over its (h, conv) state, overwritten in
    place layer by layer."""
    na = cfg.norm_apply()
    hs, convs = state
    for i, lp in enumerate(stack):
        y, (h_new, conv_new) = SSM.mamba2_decode(
            lp["mamba"], cfg.ssm, na(lp["ln"], x), (hs[i], convs[i]))
        x = x + y
        hs[i].copy_(h_new)
        convs[i].copy_(conv_new)
    return x


def _decode_hybrid(params, cfg: ModelConfig, state, x, pos, widx: int,
                   ops: Ops):
    na = cfg.norm_apply()
    sa = params["shared_attn"]
    hs, convs = state["groups"]
    for gi, gp in enumerate(params["groups"]):
        x = _decode_mamba(gp, cfg, (hs[gi], convs[gi]), x)
        x = x + _gqa_decode_cached(sa["attn"], cfg.attn_cfg, na(sa["ln"], x),
                                   _layer(state["shared_kv"], gi), pos, widx,
                                   ops)
        x = x + L.mlp(sa["mlp"], na(sa["ln2"], x), cfg.mlp_kind)
    if "rem" in params:
        x = _decode_mamba(params["rem"], cfg, state["rem"], x)
    return x


def _decode_audio(params, cfg: ModelConfig, state, x, pos, widx: int,
                  ops: Ops):
    """The decoder's step: self-attention over state["self"] (written at
    widx), cross-attention over state["cross"] (the prefill's encoder K/V,
    read, never written)."""
    na = cfg.norm_apply()
    enc_cfg = dataclasses.replace(cfg.attn_cfg, causal=False)
    for i, lp in enumerate(params["blocks"]):
        x = x + _gqa_decode_cached(lp["attn"], cfg.attn_cfg,
                                   na(lp["ln1"], x),
                                   _layer(state["self"], i), pos, widx, ops)
        ck, cv = _layer(state["cross"], i)
        q = L.project_heads(na(lp["lnx"], x), lp["xattn"]["q"])
        xo = A._sdpa(enc_cfg, q, ck, cv, None)
        x = x + L.merge_heads(xo, lp["xattn"]["o"])
        x = x + L.mlp(lp["mlp"], na(lp["ln2"], x), cfg.mlp_kind)
    return x


def decode_step(params, cfg: ModelConfig, state, token, pos, widx: int, *,
                ops: Ops = KERNELS, routes: Optional[list] = None,
                pinned: Optional[list] = None):
    """token (B, 1) -> (logits (B, 1, V), state). pos (B, 1) absolute
    positions; widx the cache slot to write. The state is updated in place
    (the caches are written at widx, the SSM states overwritten) and
    returned: a copy per step of the whole cache would cost more than the
    step. `pinned`: as prefill's, one (B, k) tensor a MoE layer."""
    x = L.embed(params["embed"], token)
    na = cfg.norm_apply()
    if cfg.family == "ssm":
        x = _decode_mamba(params["blocks"], cfg, state["blocks"], x)
    elif cfg.family == "hybrid":
        x = _decode_hybrid(params, cfg, state, x, pos, widx, ops)
    elif cfg.family == "audio":
        x = _decode_audio(params, cfg, state, x, pos, widx, ops)
    else:
        stacks = [("blocks", cfg.family == "moe")]
        if cfg.family == "moe" and cfg.first_k_dense:
            stacks.insert(0, ("dense_blocks", False))
        pinned = iter(pinned or ())
        for key, moe_block in stacks:
            for i, lp in enumerate(params[key]):
                h = na(lp["ln1"], x)
                cache = _layer(state[key], i)
                if cfg.attn_type == "mla":
                    x = x + _mla_decode_cached(lp["attn"], cfg, h, cache,
                                               pos, widx, ops)
                else:
                    x = x + _gqa_decode_cached(lp["attn"], cfg.attn_cfg, h,
                                               cache, pos, widx, ops)
                h = na(lp["ln2"], x)
                if moe_block:
                    x = x + _moe_call(lp["moe"], cfg, h, routes,
                                      next(pinned, None))[0]
                else:
                    x = x + L.mlp(lp["mlp"], h, cfg.mlp_kind)
    logits = L.unembed(params["embed"], na(params["final_norm"], x))
    return logits, state
