"""The ExecutionBackend protocol: what the engine's EXECUTE layer plugs in.

A backend receives the engine (for topology + chunk store) and the step's
StepPlan, and returns a StepExecution. It must NOT re-plan: primitives,
batching, persistence and replica placement are already decided — the
backend's job is to realize (or simulate) the planned transports.

Execution is split into two halves so the engine can
pipeline plan(N+1) under execute(N):

* ``submit(engine, plan) -> StepTicket`` — issue the step's device work
  without blocking on it. A backend with nothing async to offer (the
  analytic timeline, the in-process jax path) executes eagerly and
  returns the finished StepExecution inside the ticket.
* ``await_result(engine, ticket) -> StepExecution`` — block until the
  submitted step completes and account its measured walls. Must be called
  exactly once per ticket, in submit order (the engine drains FIFO).

``execute`` remains the one-shot form (submit + await back to back) and
the only method a minimal backend must provide — the ``submit_step`` /
``await_step`` helpers below degrade to it, so third-party backends keep
working unchanged at any pipeline depth (they just overlap nothing).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Protocol, TYPE_CHECKING, \
    runtime_checkable

from repro_torch.serving import timeline as TL
from repro_torch.serving.plan import StepPlan

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.serving.engine import ServingEngine


@dataclasses.dataclass
class StepExecution:
    """What executing one StepPlan produced.

    timeline — the overlap-aware schedule of the plan's records (both
        backends produce it; the account layer derives StepStats from it).
    outputs  — req_id -> merged attention Partial over every chunk the
        request attended this step. Empty for the analytic backend; the
        exec backend's outputs must reproduce single-instance attention to
        float round-off (§3.3), which tests/test_backends.py asserts.
    measured — a timeline.MeasuredReport when the backend recorded real
        per-stage wall timings for the step (the shard_map backend);
        None for analytic / in-process execution.
    """
    timeline: TL.Timeline
    outputs: Dict[int, Any] = dataclasses.field(default_factory=dict)
    backend: str = ""
    measured: Optional[TL.MeasuredReport] = None


@dataclasses.dataclass
class StepTicket:
    """An in-flight step: what submit() issued and await_result() will
    finish. ``execution`` is pre-filled by eager backends (submit already
    ran everything); ``state`` is backend-private launch context for the
    genuinely async ones (the shard_map backend parks its dispatched
    device tasks here until the barrier)."""
    plan: StepPlan
    state: Any = None
    execution: Optional[StepExecution] = None


@runtime_checkable
class ExecutionBackend(Protocol):
    name: str

    def execute(self, engine: "ServingEngine",
                plan: StepPlan) -> StepExecution:
        """Run (or simulate) one planned step."""
        ...                                          # pragma: no cover


def submit_step(backend: ExecutionBackend, engine: "ServingEngine",
                plan: StepPlan) -> StepTicket:
    """Issue one planned step without blocking. Backends that predate the
    split (no submit attr) run eagerly — correct at any depth, they just
    leave nothing for the planner to hide under."""
    sub = getattr(backend, "submit", None)
    if sub is None:
        return StepTicket(plan=plan, execution=backend.execute(engine, plan))
    return sub(engine, plan)


def await_step(backend: ExecutionBackend, engine: "ServingEngine",
               ticket: StepTicket) -> StepExecution:
    """Block until a submitted step's StepExecution is complete."""
    if ticket.execution is not None:
        return ticket.execution
    return backend.await_result(engine, ticket)
