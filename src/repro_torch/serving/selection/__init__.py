"""The distributed indexer subsystem (§5.4): score -> select ->
scatter-attend through the scheduler.

Numpy-only pieces (types, trace replay) import eagerly — the planner and
the ReplaySelector work without torch; the live IndexerService loads
lazily (it materializes chunk arrays through the exec backend's helpers).
"""

from repro_torch.serving.selection.replay import (ReplaySelector,
                                                  load_selection_trace,
                                                  save_selection_trace,
                                                  selection_trace_payload)
from repro_torch.serving.selection.types import RequestSelection, token_mask


def __getattr__(name: str):
    if name in ("IndexerService", "SelectionConfig"):
        from repro_torch.serving.selection import service
        return getattr(service, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
