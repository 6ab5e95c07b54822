"""What a per-layer metric's reader (portbench/metrics/<name>.py, its
`read(ctx)`) is given: the cell's configuration and traffic, the window's
records, the reduced trace of the traced points, the plain reference on
the run's device, and `note` for lines on standard error.  A reader that
finds nothing to read returns None, and the metric is left out."""
from __future__ import annotations

import dataclasses
import sys
from typing import Optional

from portbench.cell import Window
from portbench.tracing import Trace
from portbench.traffic import Traffic


@dataclasses.dataclass
class Context:
    config: dict
    traffic: Traffic
    window: Window
    trace: Optional[Trace]
    reference: object
    card: dict

    def traced_steps(self) -> list:
        """(point plan, StepRec) of every step of the traced points, in
        order."""
        out = []
        for i in self.window.traced:
            if i < len(self.window.points):
                p = self.window.points[i]
                out.extend((p.plan, s) for s in self.window.steps[p.first:p.last])
        return out

    def launches_per_step(self, fragment: str) -> Optional[list]:
        """The kernels named with `fragment`, grouped by traced step ([[
        (name, start_us, end_us), ...] per step]), or None when their count
        is not a whole number of launches a step."""
        ks = self.trace.kernels(fragment) if self.trace else []
        steps = len(self.traced_steps())
        if not ks or not steps or len(ks) % steps:
            return None
        m = len(ks) // steps
        return [ks[k * m:(k + 1) * m] for k in range(steps)]

    def note(self, line: str) -> None:
        print(line, file=sys.stderr)
