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

Logical axes. Each init call names its tensor's logical axes (embed, mlp,
heads, kv, vocab, expert, or None per dim), as the reference's Param does,
less the reference's leading "layer" entries (a stack is a list here). A
tensor never carries them: param/zeros/ones(axes=...) (or tag) note them in
a side table keyed by the tensor's identity, and the Tree (or the MLA
module) that takes the tensor moves them into its own `_axes` map of
parameter name -> axes. param_axes(tree) reads them back by parameter path,
and they survive .to(), a parameter swapped for a DTensor and convert.py's
loads, which replace parameters but keep the module.

Every parameter is created frozen (requires_grad False): serving never
differentiates. trainable(tree) is the one way to make a tree's parameters
take gradients, which the training path does before its first step.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


Axes = Tuple[Optional[str], ...]

# id(tensor) -> (weak reference to it, its logical axes): filled by tag(),
# read by the Tree that takes the tensor; an entry goes with its tensor
_TAGS: Dict[int, tuple] = {}
# while placing(fn) is active: fn, which tag() hands every new leaf to
_PLACE: list = [None]


@contextlib.contextmanager
def placing(fn: Callable):
    """While active, tag() replaces each leaf it notes axes for by fn(leaf,
    axes) (a DTensor laid out on a mesh, say) before it notes them: a tree
    drawn meanwhile is placed leaf by leaf as it is drawn, each leaf before
    the next is drawn (distributed.sharding.init_sharded)."""
    _PLACE[0] = fn
    try:
        yield
    finally:
        _PLACE[0] = None


def tag(t: torch.Tensor, axes: Optional[Sequence[Optional[str]]]):
    """Note t's logical axes (one entry per dim) for the Tree that takes it;
    returns t (under placing(fn), fn(t, axes), noted instead). axes None
    notes nothing."""
    if axes is None:
        return t
    axes = tuple(axes)
    if len(axes) != t.ndim:
        raise ValueError(f"axes {axes} for a tensor of shape "
                         f"{tuple(t.shape)}")
    if _PLACE[0] is not None:
        t = _PLACE[0](t, axes)
    key = id(t)
    _TAGS[key] = (weakref.ref(t, lambda _, k=key: _TAGS.pop(k, None)), axes)
    return t


def tagged_axes(t: torch.Tensor) -> Optional[Axes]:
    """The axes tag() noted for t, or None."""
    entry = _TAGS.get(id(t))
    return entry[1] if entry is not None and entry[0]() is t else None


def param(shape, generator: Optional[torch.Generator], *, dtype, device,
          scale: Optional[float] = None, axes=None) -> torch.Tensor:
    """Truncated normal on [-2, 2] times scale (default 1/sqrt(fan_in),
    fan_in = shape[0] for a matrix, the only axis for a vector), drawn in
    f32 from `generator` on `device`, then cast to dtype; its logical axes
    noted (tag)."""
    device = torch.device(device)
    if device.type == "meta":
        return tag(torch.empty(shape, dtype=dtype, device=device), axes)
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        scale = 1.0 / np.sqrt(max(1, fan_in))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return tag(t.mul_(scale).to(dtype), axes)


def zeros(shape, *, dtype, device, axes=None) -> torch.Tensor:
    return tag(torch.zeros(shape, dtype=dtype, device=device), axes)


def ones(shape, *, dtype, device, axes=None) -> torch.Tensor:
    return tag(torch.ones(shape, dtype=dtype, device=device), axes)


class Tree(nn.Module):
    """A named tree of parameters: tensor leaves become frozen parameters,
    nested mappings become Trees, modules (an MLA, a list of layers) are kept
    as they are. Indexed like the reference's dicts: tree["w"], "b" in
    tree."""

    def __init__(self, items: Mapping):
        super().__init__()
        self._names = frozenset(items)
        self._axes: Dict[str, Axes] = {}
        for name, value in items.items():
            if isinstance(value, Mapping):
                value = Tree(value)
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                axes = tagged_axes(value)
                if axes is not None:
                    self._axes[name] = axes
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


def param_axes(tree: nn.Module) -> Dict[str, Axes]:
    """{parameter path (as named_parameters gives it): logical axes} of
    every parameter of tree; a parameter whose init noted none raises."""
    out = {}
    for prefix, mod in tree.named_modules():
        axes = getattr(mod, "_axes", {})
        for name, _ in mod.named_parameters(recurse=False):
            path = f"{prefix}.{name}" if prefix else name
            if name not in axes:
                raise KeyError(f"{path}: no logical axes noted at init")
            out[path] = axes[name]
    return out


def count_params(tree: nn.Module) -> int:
    return int(sum(p.numel() for p in tree.parameters()))
