"""Parameter initialisation and the parameter tree of the port's models.

The JAX package keeps parameters as pytrees of Param(value, logical_axes)
drawn from split PRNG keys. Here a parameter is a tensor drawn from an
explicit torch.Generator that lives on the parameter's own device (a CUDA
generator draws a CUDA parameter in place: no host copy of the weights), and
a tree of parameters is a Tree: an nn.Module whose children are indexed by
name, as the reference's nested dicts are (p["gate"]["w"]). Stacked layers
are lists of per-layer trees (nn.ModuleList); the reference's leading
"layer" axis becomes the list index.

On the meta device nothing is drawn: init functions then give the shapes
and dtypes alone, which is how convert.py checks carried-over weights.

Every parameter is created frozen (requires_grad False): serving never
differentiates. trainable(tree) is the one way to make a tree's parameters
take gradients, which the training path does before its first step.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn


def param(shape, generator: Optional[torch.Generator], *, dtype, device,
          scale: Optional[float] = None) -> torch.Tensor:
    """Truncated normal on [-2, 2] times scale (default 1/sqrt(fan_in),
    fan_in = shape[0] for a matrix, the only axis for a vector), drawn in
    f32 from `generator` on `device`, then cast to dtype."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        scale = 1.0 / np.sqrt(max(1, fan_in))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(dtype)


def zeros(shape, *, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, *, dtype, device) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


class Tree(nn.Module):
    """A named tree of parameters: tensor leaves become frozen parameters,
    nested mappings become Trees, modules (an MLA, a list of layers) are kept
    as they are. Indexed like the reference's dicts: tree["w"], "b" in
    tree."""

    def __init__(self, items: Mapping):
        super().__init__()
        self._names = frozenset(items)
        for name, value in items.items():
            if isinstance(value, Mapping):
                value = Tree(value)
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name):
        if name not in self._names:
            raise KeyError(name)
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._names


def init_stacked(n: int, init_fn: Callable[[], nn.Module]) -> nn.ModuleList:
    """n independently initialised copies of init_fn(), one per layer, drawn
    in layer order from the generator init_fn uses."""
    return nn.ModuleList(init_fn() for _ in range(n))


def trainable(tree: nn.Module) -> nn.Module:
    """Make every parameter of tree take gradients (in place); returns tree.
    The reference differentiates every leaf, the f32 router and SSM
    parameters included."""
    for p in tree.parameters():
        p.requires_grad_(True)
    return tree


def count_params(tree: nn.Module) -> int:
    return int(sum(p.numel() for p in tree.parameters()))
