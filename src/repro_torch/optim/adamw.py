"""AdamW for the training path, the counterpart of repro.optim.adamw.

Parameters are updated in place: `params` is a module (its parameters()
in order) or a sequence of tensors, and `grads` the matching sequence. Every
update is computed in f32 and rounded back to each parameter's dtype; the
moments are kept in cfg.state_dtype (bf16 is the memory-relief option). The
gradient is clipped by its global norm (reported before the clip), the
moments are bias-corrected, and weight decay is decoupled and applied to
the tensors the reference decays: those of two or more axes in its tree.
The reference stacks a model's layers over leading layer axes where the
port keeps a list of layers (nn.ModuleList), so a model's mask counts
those levels (decay_mask); a flat list of tensors is decayed by its own
axes. torch.optim.AdamW computes in the parameter's dtype and decays every
tensor, so it is not used.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32


def _leaves(params) -> list:
    return list(params.parameters() if isinstance(params, nn.Module)
                else params)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """{"m": [zeros], "v": [zeros], "step": 0-d int32}, the moments in
    cfg.state_dtype on each parameter's device (a DTensor parameter's on its
    placements)."""
    leaves = _leaves(params)
    zeros = lambda p: torch.zeros_like(p, dtype=cfg.state_dtype,
                                       memory_format=torch.contiguous_format)
    return {"m": [zeros(p) for p in leaves],
            "v": [zeros(p) for p in leaves],
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def decay_mask(params: nn.Module) -> list:
    """[whether AdamW decays it, for each of params.parameters()]: its
    counterpart in the reference's tree has two or more axes, its own
    ndim plus one for each nn.ModuleList above it (the stacked layer axes:
    one for "blocks", "dense_blocks", "rem" and "enc_blocks", two for the
    hybrid's "groups"; the mapping convert.pairs walks). Read from the
    module tree, so a DTensor's local shard never decides."""
    out = []
    for path, p in params.named_parameters():
        owners = path.split(".")[:-1]
        stacked = sum(isinstance(params.get_submodule(".".join(owners[:i])),
                                 nn.ModuleList)
                      for i in range(1, len(owners) + 1))
        out.append(p.ndim + stacked >= 2)
    return out


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tensors))


@torch.no_grad()
def adamw_update(params, grads: Sequence[torch.Tensor], state: dict,
                 cfg: AdamWConfig, lr=None,
                 decay: Optional[Sequence[bool]] = None):
    """One step, in place: the parameters and the moments are overwritten
    and state["step"] advanced. Returns (params, state, {"grad_norm", "lr"});
    lr (a float or a 0-d tensor) overrides cfg.lr; decay (decay_mask's list
    for a model) says which parameters take weight decay, by default those
    of two or more axes."""
    f32 = torch.float32
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    lr_t = cfg.lr if lr is None else lr
    t = step.to(f32)
    bc1, bc2 = 1 - cfg.b1 ** t, 1 - cfg.b2 ** t
    leaves = _leaves(params)
    if decay is None:
        decay = [p.ndim >= 2 for p in leaves]
    for p, g, m, v, wd in zip(leaves, grads, state["m"], state["v"], decay,
                              strict=True):
        g = g.to(f32) * scale
        m_new = cfg.b1 * m.to(f32) + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.to(f32) + (1 - cfg.b2) * torch.square(g)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if wd:                                # decoupled weight decay
            delta = delta + cfg.weight_decay * p.to(f32)
        p.copy_(p.to(f32) - lr_t * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr_t}


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """step (int or 0-d tensor) -> lr (0-d f32): linear warmup from 0 over
    `warmup` steps (step 0 gives 0), then a cosine to 0 at `total`."""
    def lr_at(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr_at
