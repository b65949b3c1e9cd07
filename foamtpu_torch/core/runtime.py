"""Time: the part of the master clock a Case needs (port of
openfoam-2.2.x_tpu/core/runtime.py: `time_name` and the start time of
`Time`, including startFrom latestTime). The time loop, write
scheduling and run-time modification are outside the ported slice: the
SIMPLE path drives its iterations itself.
"""

from __future__ import annotations

import os
from typing import Optional

from .dictionary import FoamDict


def time_name(t: float, precision: int = 6) -> str:
    """Format like the reference's timeFormat general (%g)."""
    return f"{t:.{precision}g}"


class Time:
    def __init__(self, control: FoamDict, case_dir: str = "."):
        self.case_dir = case_dir
        self.start_time = float(control.get("startTime", 0.0))
        if str(control.get("startFrom", "startTime")) == "latestTime":
            latest = self.latest_time()
            if latest is not None:
                self.start_time = latest

    def latest_time(self) -> Optional[float]:
        best = None
        for entry in os.listdir(self.case_dir):
            try:
                t = float(entry)
            except ValueError:
                continue
            if os.path.isdir(os.path.join(self.case_dir, entry)):
                best = t if best is None else max(best, t)
        return best
