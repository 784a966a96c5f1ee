"""Drift monitor: the §7 "tracks to within ~7%" claim as a continuously
checked invariant.

Every MeasuredReport pairs the analytic timeline (what the fabric-table
cost model priced) with the measured one (the same flow structure carrying
wall-clock stage durations from the shard_map backend). This module folds
each matched stage's **relative residual**

    r = (measured_duration - planned_duration) / planned_duration

into an EWMA keyed ``(primitive, fabric_idx, stage)``, and trips when the
EWMA magnitude exceeds a configurable threshold after a minimum sample
count. On calibrated hardware with a fitted fabric table the paper's
claim puts |r| around 0.07; when the calibration constants rot (wrong
bandwidth, stale probe latency) the affected (fabric, stage) cells drift
away while the rest stay put — the per-cell keying is what makes the trip
attributable.

On FORCED HOST devices (CI) measured walls are dominated by collective
launch overhead and run 10^1–10^4× over the model; drift monitoring there
is a machinery smoke with a deliberately loose threshold (see the CI
multi-host job), not a calibration check.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

DriftKey = Tuple[str, int, str]   # (primitive, fabric_idx, stage name)


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    threshold: float = 0.07   # |EWMA| above this trips (the §7 envelope)
    alpha: float = 0.25       # EWMA weight of the newest residual
    min_samples: int = 3      # no verdict before this many residuals


@dataclasses.dataclass
class DriftStat:
    ewma: float = 0.0
    n: int = 0
    last: float = 0.0
    worst: float = 0.0        # max |residual| ever folded into this cell

    def fold(self, r: float, alpha: float) -> None:
        self.ewma = r if self.n == 0 else \
            (1.0 - alpha) * self.ewma + alpha * r
        self.n += 1
        self.last = r
        if abs(r) > abs(self.worst):
            self.worst = r


def _flow_fabric_idx(flow) -> int:
    """The fabric index of a flow's wire link, -1 for linkless flows."""
    for s in flow.stages:
        if s.resource is not None and s.resource[0] == "link":
            return int(s.resource[2])
    return -1


class DriftMonitor:
    """Accumulates measured-vs-planned residuals; ``tripped()`` reports
    cells whose EWMA left the envelope."""

    def __init__(self, config: Optional[DriftConfig] = None) -> None:
        self.config = config or DriftConfig()
        self.cells: Dict[DriftKey, DriftStat] = {}
        self.n_reports = 0
        self.n_residuals = 0
        self.n_unmatched = 0      # measured flows with no analytic partner

    # -- folding -------------------------------------------------------------

    def observe_residual(self, key: DriftKey, r: float) -> None:
        """Unit-test / synthetic entry point: fold one residual."""
        stat = self.cells.get(key)
        if stat is None:
            stat = self.cells[key] = DriftStat()
        stat.fold(float(r), self.config.alpha)
        self.n_residuals += 1

    def observe_report(self, report) -> int:
        """Fold one MeasuredReport. Flows are matched by key — the planner
        and the measured rebuild share the exact
        ``{prim}:{chunk}@{holder}#{i}`` format, so matching is total on a
        healthy step. Returns the number of residuals folded."""
        planned = {f.key: f for f in report.analytic.flows}
        folded = 0
        for mf in report.measured.flows:
            pf = planned.get(mf.key)
            if pf is None or len(pf.stages) != len(mf.stages):
                self.n_unmatched += 1
                continue
            prim = pf.primitive or mf.primitive or \
                mf.key.split(":", 1)[0]
            fab = _flow_fabric_idx(pf)
            for ps, ms in zip(pf.stages, mf.stages):
                if ps.duration_s <= 0.0:
                    continue   # no model prediction to drift from
                r = (ms.duration_s - ps.duration_s) / ps.duration_s
                self.observe_residual((prim, fab, ps.name), r)
                folded += 1
        self.n_reports += 1
        return folded

    # -- verdicts ------------------------------------------------------------

    def tripped(self) -> List[Tuple[DriftKey, DriftStat]]:
        cfg = self.config
        out = [(k, s) for k, s in sorted(self.cells.items())
               if s.n >= cfg.min_samples and abs(s.ewma) > cfg.threshold]
        out.sort(key=lambda ks: -abs(ks[1].ewma))
        return out

    def summary_lines(self, top: int = 12) -> List[str]:
        """Human-readable per-cell state, worst EWMA first."""
        rows = sorted(self.cells.items(), key=lambda ks: -abs(ks[1].ewma))
        lines = [
            f"drift: {self.n_residuals} residuals over {self.n_reports} "
            f"reports, {len(self.cells)} cells, threshold "
            f"{self.config.threshold:g} (min {self.config.min_samples} "
            f"samples)" + (f", {self.n_unmatched} unmatched flows"
                           if self.n_unmatched else "")
        ]
        tripped = {k for k, _ in self.tripped()}
        for key, s in rows[:top]:
            prim, fab, stage = key
            mark = " TRIP" if key in tripped else ""
            lines.append(
                f"  {prim:>6s} f{fab} {stage:<9s} ewma {s.ewma:+9.3f} "
                f"last {s.last:+9.3f} worst {s.worst:+9.3f} n={s.n}{mark}")
        if len(rows) > top:
            lines.append(f"  ... {len(rows) - top} more cells")
        return lines

    def check(self) -> None:
        """Raise DriftError when any cell is out of envelope."""
        bad = self.tripped()
        if bad:
            cells = ", ".join(
                f"{k[0]}/f{k[1]}/{k[2]} ewma={s.ewma:+.3f} n={s.n}"
                for k, s in bad[:6])
            raise DriftError(
                f"{len(bad)} drift cell(s) exceed |ewma| > "
                f"{self.config.threshold:g}: {cells}")


class DriftError(AssertionError):
    """Model-vs-measured calibration left the configured envelope."""
