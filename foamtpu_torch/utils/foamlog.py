"""foamLog: residual and metric time series from solver logs (host copy
of openfoam-2.2.x_tpu/utils/foamlog.py; bin/foamLog).

Parses the "Solving for X, Initial residual = ..." lines, the Courant
and continuity lines into column files under logs/. The port's solvers
print the reference's line shapes (utils/logging.py), so it reads both
packages' logs."""

from __future__ import annotations

import os
import re
from collections import defaultdict
from typing import Dict, List, Tuple

_TIME_RE = re.compile(r"^Time = (\S+)")
_SOLVE_RE = re.compile(
    r"Solving for (\w+), Initial residual = ([\deE.+-]+), "
    r"Final residual = ([\deE.+-]+), No Iterations (\d+)"
)
_NUM = r"([-+\d.eE]+)"
_COURANT_RE = re.compile(rf"Courant Number mean: {_NUM} max: {_NUM}")
_CONT_RE = re.compile(
    rf"time step continuity errors : sum local = {_NUM}, global = {_NUM}"
)


def parse(log_text: str) -> Dict[str, List[Tuple[float, float]]]:
    """Returns {series_name: [(time, value), ...]}."""
    series: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    t = 0.0
    seen_in_step: Dict[str, int] = defaultdict(int)
    for line in log_text.splitlines():
        m = _TIME_RE.match(line)
        if m:
            try:
                t = float(m.group(1))
            except ValueError:
                pass
            seen_in_step.clear()
            continue
        m = _SOLVE_RE.search(line)
        if m:
            name = m.group(1)
            n = seen_in_step[name]
            suffix = "" if n == 0 else f"_{n}"
            series[f"{name}{suffix}"].append((t, float(m.group(2))))
            series[f"{name}FinalRes{suffix}"].append((t, float(m.group(3))))
            series[f"{name}Iters{suffix}"].append((t, float(m.group(4))))
            seen_in_step[name] += 1
            continue
        m = _COURANT_RE.search(line)
        if m:
            series["CourantMean"].append((t, float(m.group(1))))
            series["CourantMax"].append((t, float(m.group(2))))
            continue
        m = _CONT_RE.search(line)
        if m:
            series["contLocal"].append((t, float(m.group(1))))
            series["contGlobal"].append((t, float(m.group(2))))
    return dict(series)


def write_logs(log_path: str, out_dir: str = None) -> str:
    """foamLog CLI behavior: logs/<series> column files next to the log."""
    with open(log_path) as f:
        series = parse(f.read())
    out = out_dir or os.path.join(os.path.dirname(os.path.abspath(log_path)),
                                  "logs")
    os.makedirs(out, exist_ok=True)
    for name, rows in series.items():
        with open(os.path.join(out, name), "w") as f:
            for t, v in rows:
                f.write(f"{t}\t{v}\n")
    return out
