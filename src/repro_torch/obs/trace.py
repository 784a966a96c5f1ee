"""Structured tracer: Chrome trace-event / Perfetto JSON export.

Three process groups (``pid``) per export:

* pid 0 — **engine**: wall-clock spans for plan / execute / account per
  step (real ``perf_counter`` time, so two runs differ here — the
  determinism tests compare pids 1-2 only).
* pid 1 — **planned timeline**: the analytic schedule, one track
  (``tid``) per timeline resource — ``link i<inst> f<fabric>`` for each
  (link, fabric) pair and ``sm i<inst>`` for each holder SM — plus a
  ``steps`` marker track. Event times are the SIMULATED seconds the
  scheduler assigned, so this group is deterministic by construction.
* pid 2 — **measured timeline**: the same flow structure with the
  shard_map backend's measured stage walls (only present when the
  backend produced MeasuredReports).

Steps share one origin across the planned and measured groups (a step's
planned schedule and its measured execution sit vertically aligned in
the viewer); consecutive steps are laid head-to-tail with a small gap.
Measured walls on forced host devices are orders of magnitude longer
than the analytic model — that scale difference is the point of the
side-by-side rendering, zoom handles it.

Load the exported file at https://ui.perfetto.dev (or
``chrome://tracing``): it is a plain ``{"traceEvents": [...]}`` JSON.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

PID_ENGINE = 0
PID_PLANNED = 1
PID_MEASURED = 2

_PROCESS_NAMES = {
    PID_ENGINE: "engine (wall clock)",
    PID_PLANNED: "planned timeline (analytic)",
    PID_MEASURED: "measured timeline (shard_map walls)",
}

# tid 0 of every timeline pid is the per-step marker track
_STEP_TID = 0


def _track_label(resource) -> str:
    """Timeline Resource tuple -> human track name."""
    if resource is None:
        return "unbound"
    kind = resource[0]
    if kind == "link":
        return f"link i{resource[1]} f{resource[2]}"
    if kind == "sm":
        return f"sm i{resource[1]}"
    return "/".join(str(p) for p in resource)


class Tracer:
    """Collects trace events in memory; ``export()`` emits the JSON.

    The engine never calls into a Tracer from the planner hot path —
    all rendering happens at account time behind ``Obs.enabled`` — so a
    run without a tracer pays literally nothing for this module.
    """

    def __init__(self) -> None:
        self.events: List[dict] = []
        # per-pid {track label: tid}; tids allocated first-seen, stable
        # across identical runs (the determinism contract)
        self._tids: Dict[int, Dict[str, int]] = {}
        self._procs_emitted: set = set()
        self._cursor_us = 0.0
        self._wall0: Optional[float] = None
        self.n_steps = 0

    # -- bookkeeping ---------------------------------------------------------

    def _ensure_process(self, pid: int) -> None:
        if pid in self._procs_emitted:
            return
        self._procs_emitted.add(pid)
        self.events.append({
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": _PROCESS_NAMES.get(pid, f"pid {pid}")},
        })
        # render planned above measured regardless of first-touch order
        self.events.append({
            "ph": "M", "pid": pid, "tid": 0, "name": "process_sort_index",
            "args": {"sort_index": pid},
        })

    def _tid(self, pid: int, label: str) -> int:
        self._ensure_process(pid)
        tids = self._tids.setdefault(pid, {})
        tid = tids.get(label)
        if tid is None:
            tid = tids[label] = len(tids) + 1   # 0 is the step track
            self.events.append({
                "ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                "args": {"name": label},
            })
        return tid

    # -- engine wall spans ---------------------------------------------------

    def wall_span(self, name: str, t0: float, t1: float,
                  track: str = "engine", **args: object) -> None:
        """A real perf_counter span (plan/execute/account), on pid 0.
        ``track`` names the pid-0 thread lane — the pipelined engine
        rotates in-flight steps across lanes so overlapping
        walls render side by side instead of on one impossible track."""
        if self._wall0 is None:
            self._wall0 = t0
        self.events.append({
            "ph": "X", "pid": PID_ENGINE,
            "tid": self._tid(PID_ENGINE, track),
            "ts": (t0 - self._wall0) * 1e6,
            "dur": max(t1 - t0, 0.0) * 1e6,
            "name": name, "cat": "engine",
            "args": dict(args),
        })

    # -- timeline rendering --------------------------------------------------

    def add_step(self, step: int, planned, measured=None) -> None:
        """Render one step: the planned timeline, and (when the backend
        measured real walls) the measured timeline, at a shared origin."""
        origin = self._cursor_us
        span_p = self._emit_timeline(PID_PLANNED, step, planned, origin)
        span_m = 0.0
        if measured is not None:
            span_m = self._emit_timeline(PID_MEASURED, step, measured,
                                         origin)
        width = max(span_p, span_m, 1.0)
        self._cursor_us = origin + width * 1.05 + 1.0
        self.n_steps += 1

    def _emit_timeline(self, pid: int, step: int, timeline,
                       origin_us: float) -> float:
        """One 'X' event per scheduled stage, tracks = resources. Returns
        the group's width in us."""
        self._ensure_process(pid)
        makespan_us = timeline.makespan_s * 1e6
        self.events.append({
            "ph": "X", "pid": pid, "tid": _STEP_TID,
            "ts": origin_us, "dur": makespan_us,
            "name": f"step {step}", "cat": "step",
            "args": {"step": step, "makespan_us": makespan_us},
        })
        for s in timeline.scheduled:
            prim = s.flow_key.split(":", 1)[0]
            self.events.append({
                "ph": "X", "pid": pid,
                "tid": self._tid(pid, _track_label(s.resource)),
                "ts": origin_us + s.start_s * 1e6,
                "dur": (s.end_s - s.start_s) * 1e6,
                "name": s.stage, "cat": prim or "flow",
                "args": {"flow": s.flow_key, "step": step},
            })
        return makespan_us

    # -- export --------------------------------------------------------------

    def export(self, path: Optional[str] = None) -> dict:
        doc = {
            "traceEvents": self.events,
            "displayTimeUnit": "ns",
            "otherData": {"steps": self.n_steps,
                          "format": "repro.obs flight recorder"},
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, indent=None, separators=(",", ":"))
                f.write("\n")
        return doc


def validate_trace(doc: dict) -> List[str]:
    """Schema check for an exported trace document. Returns a list of
    problems (empty = valid). Used by tests and the CI trace smoke."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    named_threads = set()
    named_procs = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            problems.append(f"event {i}: unexpected ph {ph!r}")
            continue
        if "pid" not in ev or "tid" not in ev or "name" not in ev:
            problems.append(f"event {i}: missing pid/tid/name")
            continue
        if ph == "M":
            if ev["name"] == "thread_name":
                named_threads.add((ev["pid"], ev["tid"]))
            elif ev["name"] == "process_name":
                named_procs.add(ev["pid"])
            continue
        ts, dur = ev.get("ts"), ev.get("dur")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
        if not isinstance(dur, (int, float)) or dur < 0:
            problems.append(f"event {i}: bad dur {dur!r}")
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if ev["pid"] not in named_procs:
            problems.append(f"pid {ev['pid']} has no process_name")
            break
    for ev in events:
        if ev.get("ph") != "X" or ev.get("tid") == _STEP_TID:
            continue
        if (ev["pid"], ev["tid"]) not in named_threads:
            problems.append(
                f"track ({ev['pid']},{ev['tid']}) has no thread_name")
            break
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as e:  # pragma: no cover - defensive
        problems.append(f"not JSON-serializable: {e}")
    return problems
