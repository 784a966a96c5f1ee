"""Carry state into the port from numpy arrays.

The serving path has no trained weights: its state is the c^KV chunk arrays
and the absorbed queries. Whatever produced them (a saved run, another
implementation), they arrive here as numpy arrays:

* chunks_from_numpy attaches chunk arrays to a chunk store before step 1
  (TorchExecBackend only materializes a chunk whose data is None);
* TorchExecBackend(query_source=...) takes the queries;
* mla_params_from_numpy turns an MLA parameter tree (the nested dict of
  repro.models.mla.init_mla's values, as numpy) into the port's MLA module;
* model_params_from_numpy does the same for a whole model of any family:
  the value tree of repro.models.model.init_model (after module.split),
  stacked leaves carrying their leading layer axes (one for "blocks",
  "dense_blocks", "rem" and "enc_blocks", two for the hybrid's (n_groups,
  group) "groups"; none for "shared_attn", "enc_norm" and the rest),
  becomes the port's parameter tree, whose stacks are lists (of lists).

Every parameter is checked against the shape its config implies and takes
the dtype the port's init gives it (the MoE router and the SSM's a_log,
dt_bias and d_skip stay f32, as in the reference).

Arrays are copied (torch.tensor(np.array(x))): a read-only numpy view would
otherwise be shared with torch.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.chunk_store import ChunkStore
from repro_torch.models.mla import MLA, MLAConfig
from repro_torch.models.model import ModelConfig, init_model


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.array(x), dtype=dtype, device=device)


def chunks_from_numpy(store: ChunkStore, arrays: Mapping[str, np.ndarray],
                      dtype=torch.float32, device="cuda") -> None:
    """Attach {chunk_id: (length, d_qk) array} as the canonical chunk data."""
    for chunk_id, arr in arrays.items():
        store.attach_data(chunk_id, _tensor(arr, dtype, device))


def _layer(tree, i: int):
    """Layer i of a stacked numpy tree (its leaves indexed on their first
    axis: a nested stack is indexed again one level down)."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _load(node: nn.Module, tree, device, path: str) -> None:
    """Replace the (meta) parameters of node by the arrays of tree, in place:
    same names, shapes checked, each parameter keeping its own dtype."""
    if isinstance(node, nn.ModuleList):
        for i, child in enumerate(node):
            _load(child, _layer(tree, i), device, f"{path}[{i}]")
        return
    own = dict(node.named_parameters(recurse=False))
    children = dict(node.named_children())
    if set(tree) != set(own) | set(children):
        raise ValueError(f"{path or 'params'}: got keys {sorted(tree)}, the "
                         f"config implies {sorted(set(own) | set(children))}")
    for name, old in own.items():
        value = tree[name]
        if isinstance(value, Mapping):          # an MLA norm {"scale": ...}
            value = value["scale"]
        t = _tensor(value, old.dtype, device)
        if t.shape != old.shape:
            raise ValueError(f"{path}.{name}: got shape {tuple(t.shape)}, "
                             f"cfg implies {tuple(old.shape)}")
        setattr(node, name, nn.Parameter(t, requires_grad=False))
    for name, child in children.items():
        _load(child, tree[name], device, f"{path}.{name}")


def mla_params_from_numpy(params: Mapping, cfg: MLAConfig,
                          dtype=torch.float32, device="cuda") -> MLA:
    """{name: array} with norms as {"scale": array} -> the MLA module, each
    parameter checked against the shape cfg implies."""
    mod = MLA(cfg, dtype=dtype, device="meta")
    _load(mod, params, device, "mla")
    return mod


def model_params_from_numpy(tree: Mapping, cfg: ModelConfig,
                            dtype=torch.float32, device="cuda") -> nn.Module:
    """The reference's init_model value tree, as numpy (stacked leaves with
    the leading layer axis) -> the port's model parameters (init_model's
    tree), every shape checked against what cfg implies."""
    model = init_model(cfg, device="meta", dtype=dtype)
    _load(model, tree, device, "params")
    return model
