"""Time: the master clock and run control (a copy of
openfoam-2.2.x_tpu/core/runtime.py, host code): owns controlDict, drives
the time loop, write scheduling (writeControl/writeInterval/purgeWrite),
the adjustable time step (adjustTimeStep/maxCo), run-time modification
of controlDict and time-directory naming.
"""

from __future__ import annotations

import os
import shutil
import time as _walltime
from typing import Iterator, List, Optional

from .dictionary import FoamDict


def time_name(t: float, precision: int = 6) -> str:
    """Format like the reference's timeFormat general (%g)."""
    return f"{t:.{precision}g}"


class Time:
    def __init__(self, control: FoamDict, case_dir: str = "."):
        self.case_dir = case_dir
        self.control = control
        self.start_time = float(control.get("startTime", 0.0))
        self.end_time = float(control.get("endTime", 1.0))
        self.delta_t = float(control.get("deltaT", 1.0))
        self.write_control = str(control.get("writeControl", "timeStep"))
        self.write_interval = float(control.get("writeInterval", 1))
        self.purge_write = int(control.get("purgeWrite", 0))
        self.adjust_time_step = str(control.get("adjustTimeStep", "no")) in (
            "yes", "true", "on", "1",
        )
        self.max_co = float(control.get("maxCo", 1.0))
        self.max_delta_t = float(control.get("maxDeltaT", 1e30))
        self.time_precision = int(control.get("timePrecision", 6))
        self.run_time_modifiable = str(
            control.get("runTimeModifiable", "no")) in (
            "yes", "true", "on", "1")
        self.stop_now = False
        self._ctrl_mtime = self._control_mtime()

        if str(control.get("startFrom", "startTime")) == "latestTime":
            latest = self.latest_time()
            if latest is not None:
                self.start_time = latest

        self.value = self.start_time
        self.index = 0
        self._written: List[str] = []
        self._wall0 = _walltime.time()
        self._cpu0 = _walltime.process_time()

    # -- time directories -----------------------------------------------------
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

    @property
    def name(self) -> str:
        return time_name(self.value, self.time_precision)

    # -- loop -------------------------------------------------------------------
    def loop(self) -> Iterator["Time"]:
        # stop tolerance scales with the case's own time scale — an
        # absolute floor would swallow sub-1e-10 end times (MD runs
        # finish in picoseconds)
        while (not self.stop_now and self.value
               < self.end_time - 1e-10 * max(abs(self.end_time),
                                             abs(self.delta_t))):
            dt = min(self.delta_t, self.end_time - self.value)
            self.value += dt
            self.current_dt = dt
            self.index += 1
            yield self

    def adjust_delta_t(self, courant_max: float) -> None:
        """adjustTimeStep logic (reference: include/setDeltaT.H): scale
        dt towards maxCo with a 1.2x growth damper."""
        if not self.adjust_time_step or courant_max <= 1e-12:
            return
        factor = min(min(self.max_co / courant_max, 1.0 + 0.1 * self.max_co / courant_max), 1.2)
        self.delta_t = min(factor * self.delta_t, self.max_delta_t)

    def _control_mtime(self):
        try:
            return os.stat(os.path.join(
                self.case_dir, "system", "controlDict")).st_mtime_ns
        except OSError:
            return None

    def read_if_modified(self) -> bool:
        """runTimeModifiable: re-read system/controlDict between
        chunks when its mtime changed (reference: Time::run ->
        regIOobject::readIfModified via fileMonitor). endTime, deltaT,
        write scheduling, purgeWrite and stopAt writeNow/noWriteNow are
        picked up mid-run."""
        if not self.run_time_modifiable:
            return False
        m = self._control_mtime()
        if m is None or m == self._ctrl_mtime:
            return False
        self._ctrl_mtime = m
        from .dictionary import parse_file

        try:
            c = parse_file(os.path.join(self.case_dir, "system",
                                        "controlDict"))
        except Exception:
            return False
        self.control = c
        self.end_time = float(c.get("endTime", self.end_time))
        self.delta_t = float(c.get("deltaT", self.delta_t))
        self.write_control = str(c.get("writeControl",
                                       self.write_control))
        self.write_interval = float(c.get("writeInterval",
                                          self.write_interval))
        self.purge_write = int(c.get("purgeWrite", self.purge_write))
        self.max_co = float(c.get("maxCo", self.max_co))
        stop_at = str(c.get("stopAt", "endTime"))
        if stop_at in ("writeNow", "noWriteNow", "nextWrite"):
            self.stop_now = True
        return True

    # -- write scheduling ---------------------------------------------------------
    def write_time(self) -> bool:
        if self.write_control == "timeStep":
            return self.index % max(int(self.write_interval), 1) == 0
        if self.write_control in ("runTime", "adjustableRunTime"):
            n = round(self.value / self.write_interval)
            return abs(self.value - n * self.write_interval) < 1e-6 * self.write_interval
        return False

    def register_write(self, name: str) -> None:
        if name in self._written:
            # the final write re-writes the already-registered latest
            # time — re-registering would purge a genuine older entry
            return
        self._written.append(name)
        if self.purge_write > 0 and len(self._written) > self.purge_write:
            victim = self._written.pop(0)
            path = os.path.join(self.case_dir, victim)
            if os.path.isdir(path) and victim not in ("0", "constant", "system"):
                shutil.rmtree(path, ignore_errors=True)

    # -- timing ----------------------------------------------------------------
    def execution_time(self) -> float:
        return _walltime.process_time() - self._cpu0

    def clock_time(self) -> float:
        return _walltime.time() - self._wall0
