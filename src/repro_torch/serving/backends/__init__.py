"""Pluggable EXECUTE layer for the serving engine (plan / execute / account).

The planner (repro_torch.serving.engine) emits a StepPlan; a backend runs it:

* AnalyticBackend — schedules the plan on the overlap-aware transport
  timeline. Pure simulation.
* TorchExecBackend — ALSO executes the planned attention on real c^KV
  tensors (on the card by default) through the mla_decode, softmax_merge,
  delta_rotate and sparse_select kernels, returning decode outputs next to
  the analytic stage costs.
"""

from repro_torch.serving.backends.base import ExecutionBackend, StepExecution
from repro_torch.serving.backends.analytic import AnalyticBackend

__all__ = ["ExecutionBackend", "StepExecution", "AnalyticBackend",
           "TorchExecBackend", "TINY_MLA"]

_LAZY = ("TorchExecBackend", "TINY_MLA")


def __getattr__(name: str):
    # torch_exec pulls in torch; the planner + analytic backend are
    # numpy-only and stay importable without it, so the exec backend loads
    # on first use.
    if name in _LAZY:
        from repro_torch.serving.backends import torch_exec
        return getattr(torch_exec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
