"""AnalyticBackend: the overlap timeline as an ExecutionBackend.

Executing a plan analytically = scheduling its DispatchRecords on the
overlap-aware transport timeline (wire stages serialize per (link, fabric),
holder compute per-instance). No arrays move; StepStats derived from this
backend are bit-identical to the pre-split engine — the golden JSON
fixtures of tests/test_engine_golden.py enforce that.

A plan carrying its columnar form (StepPlan.arrays, the
array planner's output) is scheduled by timeline.simulate_arrays — the
lazy-heap event scheduler — instead of the per-stage O(stages x flows)
rescan loop. The two produce the same schedule stage-for-stage, so the
golden fixtures hold bit-identically on either path.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.serving import timeline as TL
from repro_torch.serving.backends.base import StepExecution, StepTicket
from repro_torch.serving.plan import StepPlan, build_timeline

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.serving.engine import ServingEngine


class AnalyticBackend:
    name = "analytic"

    def execute(self, engine: "ServingEngine",
                plan: StepPlan) -> StepExecution:
        if plan.arrays is not None:
            timeline = TL.simulate_arrays(plan.arrays.flow_arrays())
        else:
            timeline = build_timeline(plan.records)
        return StepExecution(timeline=timeline, backend=self.name)

    # simulation has no device work to defer: submit IS execute

    def submit(self, engine: "ServingEngine", plan: StepPlan) -> StepTicket:
        return StepTicket(plan=plan, execution=self.execute(engine, plan))

    def await_result(self, engine: "ServingEngine",
                     ticket: StepTicket) -> StepExecution:
        return ticket.execution
