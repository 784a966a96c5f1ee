"""Carry state into the port from numpy arrays.

The serving path has no trained weights: its state is the c^KV chunk arrays
and the absorbed queries. Whatever produced them (a saved run, another
implementation), they arrive here as numpy arrays:

* chunks_from_numpy attaches chunk arrays to a chunk store before step 1
  (TorchExecBackend only materializes a chunk whose data is None);
* TorchExecBackend(query_source=...) takes the queries;
* mla_params_from_numpy turns an MLA parameter tree (the nested dict of
  repro.models.mla.init_mla's values, as numpy) into the port's MLA module.

Arrays are copied (torch.tensor(np.array(x))): a read-only numpy view would
otherwise be shared with torch.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.chunk_store import ChunkStore
from repro_torch.models.mla import MLA, MLAConfig, param_shapes


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.array(x), dtype=dtype, device=device)


def chunks_from_numpy(store: ChunkStore, arrays: Mapping[str, np.ndarray],
                      dtype=torch.float32, device="cuda") -> None:
    """Attach {chunk_id: (length, d_qk) array} as the canonical chunk data."""
    for chunk_id, arr in arrays.items():
        store.attach_data(chunk_id, _tensor(arr, dtype, device))


def mla_params_from_numpy(params: Mapping, cfg: MLAConfig,
                          dtype=torch.float32, device="cuda") -> MLA:
    """{name: array} with norms as {"scale": array} -> the MLA module, each
    parameter checked against the shape cfg implies."""
    mod = MLA(cfg, dtype=dtype, device="meta")
    for name, shape in param_shapes(cfg).items():
        value = params[name]
        if isinstance(value, Mapping):
            value = value["scale"]
        t = _tensor(value, dtype, device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: got shape {tuple(t.shape)}, cfg "
                             f"implies {shape}")
        setattr(mod, name, torch.nn.Parameter(t, requires_grad=False))
    return mod
