"""Pluggable EXECUTE layer for the serving engine (plan / execute / account).

The planner (repro_torch.serving.engine) emits a StepPlan; a backend runs it:

* AnalyticBackend — schedules the plan on the overlap-aware transport
  timeline. Pure simulation.
* TorchExecBackend — ALSO executes the planned attention on real c^KV
  tensors (on the card by default) through the mla_decode, softmax_merge,
  delta_rotate and sparse_select kernels, returning decode outputs next to
  the analytic stage costs.
* ShardMapExecBackend — the same over an instance mesh (one CUDA stream
  per serving instance on the card): real transports between instances,
  measured stage walls beside the analytic ones.
"""

from repro_torch.serving.backends.base import ExecutionBackend, StepExecution
from repro_torch.serving.backends.analytic import AnalyticBackend

__all__ = ["ExecutionBackend", "StepExecution", "AnalyticBackend",
           "TorchExecBackend", "TINY_MLA", "ShardMapExecBackend"]

_LAZY = ("TorchExecBackend", "TINY_MLA")


def __getattr__(name: str):
    # torch_exec pulls in torch; the planner + analytic backend are
    # numpy-only and stay importable without it, so the exec backend loads
    # on first use.
    if name in _LAZY:
        from repro_torch.serving.backends import torch_exec
        return getattr(torch_exec, name)
    if name == "ShardMapExecBackend":
        from repro_torch.serving.backends import shard_map
        return shard_map.ShardMapExecBackend
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
