"""Meta-device stand-ins for every model input per (arch, shape) cell (no
allocation; the counterpart of the reference's ShapeDtypeStructs) and the
matching sharding trees, the counterpart of repro.launch.input_specs."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.distributed.sharding import (NamedSharding, _axis_size,
                                              _fsdp_axes, axis_sizes,
                                              dp_entry)
from repro_torch.models import model as MD


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def tree_map(fn, tree):
    """fn over the tensor leaves of a tree of dicts, tuples and lists
    (None kept), in the tree's own structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def train_batch_specs(cfg: MD.ModelConfig, shape: ShapeSpec):
    """Token batch stand-ins for a train/prefill shape (the VLM's patch and
    the audio model's frame embeddings in bf16)."""
    B, S = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    if cfg.family == "vlm":
        text = S - cfg.vlm_patches
        batch["tokens"] = _meta((B, text), torch.int32)
        batch["targets"] = _meta((B, text), torch.int32)
        batch["patch_embeds"] = _meta((B, cfg.vlm_patches, cfg.d_model),
                                      torch.bfloat16)
    elif cfg.family == "audio":
        batch["tokens"] = _meta((B, S), torch.int32)
        batch["targets"] = _meta((B, S), torch.int32)
        batch["frame_embeds"] = _meta((B, cfg.enc_seq, cfg.d_model),
                                      torch.bfloat16)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
        batch["targets"] = _meta((B, S), torch.int32)
    return batch


def train_batch_shardings(batch_specs, mesh):
    dp = dp_entry(mesh)
    return tree_map(lambda s: NamedSharding(mesh, (dp,) + (None,) *
                                            (s.ndim - 1)), batch_specs)


# ---------------------------------------------------------------------------
# Decode state: abstract caches + shardings per family.
# ---------------------------------------------------------------------------

def decode_state_specs(cfg: MD.ModelConfig, shape: ShapeSpec):
    return MD.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                device="meta")


def _seq_axes(mesh, batch: int, seq: int):
    """Sequence-dim sharding for caches: 'model', plus any dp axes the batch
    cannot use (long_500k batch=1 => the whole mesh shards the sequence —
    the paper's partitioned canonical store)."""
    dp = _fsdp_axes(mesh)
    batch_ok = dp and batch % _axis_size(mesh, dp) == 0
    axes = tuple() if batch_ok else dp
    if "model" in axis_sizes(mesh):
        axes = axes + ("model",)
    if axes and seq % _axis_size(mesh, axes) == 0:
        batch_entry = dp_entry(mesh) if batch_ok else None
        return batch_entry, (axes if len(axes) > 1 else axes[0])
    return (dp_entry(mesh) if batch_ok else None), None


def decode_state_shardings(cfg: MD.ModelConfig, shape: ShapeSpec, mesh):
    B, S = shape.global_batch, shape.seq_len
    b_entry, s_entry = _seq_axes(mesh, B, S)
    sizes = axis_sizes(mesh)

    def _entry_size(entry):
        if not entry:
            return 1
        axes = entry if isinstance(entry, tuple) else (entry,)
        return _axis_size(mesh, axes)

    def kv_shard(spec):   # (L, B, S', Hkv, hd) — S' may be enc_seq (1500)
        se = s_entry if (s_entry and
                         spec.shape[2] % _entry_size(s_entry) == 0) else None
        return NamedSharding(mesh, (None, b_entry, se))

    def mla_shard(spec):  # (L, B, S, d_qk)
        return NamedSharding(mesh, (None, b_entry, s_entry))

    def ssm_h_shard(spec):   # (..., B, H, Phd, N)
        lead = (None,) * (spec.ndim - 4)
        h_entry = ("model" if "model" in sizes
                   and spec.shape[-3] % sizes["model"] == 0 else None)
        return NamedSharding(mesh, lead + (b_entry, h_entry, None, None))

    def conv_shard(spec):    # (..., B, K-1, C)
        lead = (None,) * (spec.ndim - 3)
        c_entry = ("model" if "model" in sizes
                   and spec.shape[-1] % sizes["model"] == 0 else None)
        return NamedSharding(mesh, lead + (b_entry, None, c_entry))

    def classify(spec):
        shp = spec.shape
        if cfg.attn_type == "mla" and len(shp) == 4 and shp[-1] == cfg.mla.d_qk:
            return mla_shard(spec)
        if cfg.ssm is not None and \
                shp[-1] == cfg.ssm.d_inner + 2 * cfg.ssm.d_state:
            return conv_shard(spec)               # mamba conv left-context
        if len(shp) >= 4 and cfg.ssm is not None \
                and shp[-1] == cfg.ssm.d_state \
                and shp[-2] == cfg.ssm.head_dim:
            return ssm_h_shard(spec)              # mamba recurrent state
        acfg = cfg.attn_cfg
        if len(shp) == 5 and shp[-1] == acfg.hd \
                and shp[-2] == acfg.n_kv_heads:   # gqa kv cache
            return kv_shard(spec)
        return NamedSharding(mesh, ())

    return tree_map(classify, decode_state_specs(cfg, shape))


def decode_input_specs(cfg: MD.ModelConfig, shape: ShapeSpec):
    B = shape.global_batch
    return (_meta((B, 1), torch.int32),           # token
            _meta((B, 1), torch.int32),           # pos
            _meta((), torch.int32))               # widx


def decode_input_shardings(mesh, batch: int = 0):
    dp = dp_entry(mesh)
    dp_axes = _fsdp_axes(mesh)
    if dp_axes and batch % _axis_size(mesh, dp_axes) != 0:
        dp = None                              # long_500k: batch=1 replicated
    return (NamedSharding(mesh, (dp, None)),
            NamedSharding(mesh, (dp, None)),
            NamedSharding(mesh, ()))
