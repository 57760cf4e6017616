"""The readings behind a cell's correctness limits, and the control.

The lower reading of a number is the largest the program gives over a
dozen seeds or more; the upper one the smallest the control gives: the
plain reference put in the program's place and computed one precision
below the configuration's (TF32 for float32 with TF32 off). Both are read
here the way a run reads its numbers: the cell's set-up, a window of
whole ticks at the cell's own load, the same sample of its graphs.
"""

from __future__ import annotations

import time

from perfbench.lib import harness


def readings(spec, seed: int, seconds: float, device: str) -> dict:
    """The program's and the control's numbers for one seed."""
    cell = spec.kind.Cell(spec.config, spec.traffic, spec.limits, seed,
                          device=device)
    t0 = time.perf_counter()
    cell.setup()
    run = harness.Run(spec, cell, time.perf_counter() - t0)
    harness.window(run, seconds, False)
    program = {c["name"]: c["value"] for c in cell.check()}
    pool, exact = cell.compared
    control = cell.reference(pool, tf32=True)
    gaps = spec.kind.pose_gaps(control, exact, cell.host["vmask"][pool])
    return {"workload": spec.workload["name"], "seed": seed,
            "ticks": len(run.tick_s), "program": program,
            "control": spec.kind.gap_stats(gaps)}
