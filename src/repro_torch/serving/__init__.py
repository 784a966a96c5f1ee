from repro_torch.serving.engine import (DispatchRecord, EngineConfig,
                                        Instance, Request, ResidentPair,
                                        ServingEngine, StepPlan, StepStats,
                                        build_timeline, transport_latencies)
from repro_torch.serving.backends import (AnalyticBackend, ExecutionBackend,
                                          StepExecution)
from repro_torch.serving.timeline import (Flow, ScheduledStage, Stage,
                                          Timeline, simulate, transport_flow)
from repro_torch.serving.workload import (WorkloadConfig, agentic_trace,
                                          load_trace, materialize_trace,
                                          register_corpus, save_trace,
                                          trace_meta)


def __getattr__(name: str):
    # lazy: TorchExecBackend needs torch; everything above is numpy-only
    if name in ("TorchExecBackend", "TINY_MLA"):
        from repro_torch.serving import backends
        return getattr(backends, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
