"""Selection-trace record/replay (numpy-only).

One selection trace, many consumers — the same seam the request traces
(repro.serving.workload save_trace/load_trace) provide: the live
IndexerService records its per-step verdicts; save_selection_trace writes
them as JSON; a ReplaySelector feeds the identical masks back into the
planner. A plan built from a replayed trace is byte-for-byte the plan the
live indexer produced (same masks -> same pricing), which is what makes
the AnalyticBackend's StepStats bit-identical between the two — the
acceptance criterion tests/test_selection_service.py locks down. Replay
needs no jax at all, so an analytic engine can price the selection regime
from a trace on a machine that cannot score it.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Tuple, Union

from repro_torch.serving.plan import Request
from repro_torch.serving.selection.types import RequestSelection, token_mask

# steps as recorded by a selector: engine step -> req_id -> RequestSelection
SelectionLog = Dict[int, Dict[int, "RequestSelection"]]


def selection_trace_payload(log: SelectionLog, block_tokens: int,
                            d_index: int, meta: dict = None) -> dict:
    """The JSON form of a selector's log. meta carries world geometry the
    way request-trace meta does; block_tokens/d_index ride in meta because
    replayed PRICING (indexer wire bytes, block counts) depends on them."""
    return {
        "meta": dict(meta or {}, block_tokens=block_tokens, d_index=d_index),
        "steps": {str(step): {str(rid): {cid: list(map(int, blocks))
                                         for cid, blocks in
                                         sel.blocks.items()}
                              for rid, sel in sels.items()}
                  for step, sels in log.items()},
    }


def save_selection_trace(path: Union[str, pathlib.Path], log: SelectionLog,
                         block_tokens: int, d_index: int,
                         meta: dict = None) -> dict:
    payload = selection_trace_payload(log, block_tokens, d_index, meta)
    pathlib.Path(path).write_text(json.dumps(payload, indent=1) + "\n")
    return payload


def load_selection_trace(trace: Union[str, pathlib.Path, dict]
                         ) -> Tuple[dict, Dict[int, Dict[int, dict]]]:
    """(meta, steps) of a saved trace; steps maps engine step -> req_id ->
    {chunk_id: [block ids]}. Accepts a path or an already-parsed payload."""
    payload = (trace if isinstance(trace, dict)
               else json.loads(pathlib.Path(trace).read_text()))
    steps = {int(step): {int(rid): {cid: tuple(blocks)
                                    for cid, blocks in by_chunk.items()}
                         for rid, by_chunk in sels.items()}
             for step, sels in payload["steps"].items()}
    return payload.get("meta", {}), steps


class ReplaySelector:
    """Feed a recorded selection trace back through the planner. The trace
    only means anything against the world (corpus, request stream, step
    numbering) it was recorded on — a missing (step, request) is a world
    mismatch and raises rather than silently de-selecting."""

    name = "replay"

    def __init__(self, trace: Union[str, pathlib.Path, dict]):
        meta, self._steps = load_selection_trace(trace)
        self.meta = meta
        self.block_tokens = int(meta["block_tokens"])
        self.d_index = int(meta["d_index"])

    def select_step(self, engine, requests: List[Request],
                    step: int) -> Dict[int, RequestSelection]:
        if step not in self._steps:
            raise KeyError(f"selection trace has no step {step} "
                           f"(recorded: {sorted(self._steps)})")
        raw = self._steps[step]
        out: Dict[int, RequestSelection] = {}
        for rq in requests:
            if rq.req_id not in raw:
                raise KeyError(f"selection trace step {step} has no request "
                               f"{rq.req_id}")
            by_chunk = raw[rq.req_id]
            # a live recording writes an entry for EVERY chunk of a
            # selected request (an empty tuple when the indexer chose
            # nothing there) — a missing chunk id is a trace/world
            # mismatch, never a de-selection
            missing = [cid for cid in rq.chunk_ids if cid not in by_chunk]
            if missing:
                raise KeyError(f"selection trace step {step} request "
                               f"{rq.req_id} has no entry for chunks "
                               f"{missing}")
            blocks = {cid: tuple(sorted(by_chunk[cid]))
                      for cid in rq.chunk_ids}
            masks = {cid: token_mask(blocks[cid], self.block_tokens,
                                     engine.store.lookup(cid).length)
                     for cid in rq.chunk_ids}
            out[rq.req_id] = RequestSelection(rq.req_id, self.block_tokens,
                                              blocks, masks)
        return out
