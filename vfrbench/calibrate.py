"""The readings a cell's limits are set from: the port's, the controls'
and the planted faults', seed by seed, in one process.

    python3 -m vfrbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--seconds 2] [--controls all,score] [--faults offbyone,key16] \\
        [--out chiprun_out/calib.jsonl]

For each seed: the cell's set-up and a short window at its own load and
sizes, then the check of what the port produced (the lower readings);
then, for each of ``--controls``, the same check with the plain reference
one precision lower standing in for the port ("all" lowers every stage,
another name the serving stage it names: recurrence, projection, score),
and for each of ``--faults`` the reference at the stated precisions with
that select fault (``mcn.SELECT_FAULTS``): the upper readings, which the
limits have to fail.  One JSON line a seed and side, to standard output
and to ``--out``.  The benchmark's own runs never run a control or a
fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from vfrbench import catalog
from vfrbench.trace import Tracer


def readings(cell, seed: int, seconds: float, dev, controls=(), faults=()):
    """[(side, readings, failed)] of one seed: the port's, then each
    control's ("control:all", "control:score", ...), then each fault's
    ("fault:offbyone", ...)."""
    cfg = catalog.experiment(cell.config)
    driver = catalog.load_module("drivers", cell.driver)
    st = driver.setup(cell, cfg, seed, seconds, dev)
    win = driver.window(st, seconds, Tracer(False, seconds))
    driver.release(st)
    out = [("port", driver.check(st), win.get("failed", 0))]
    for c in controls:
        out.append((f"control:{c}",
                    driver.check(st, control=True if c == "all" else {c}), 0))
    for f in faults:
        out.append((f"fault:{f}", driver.check(st, fault=f), 0))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", default="all",
                    help="comma-separated: all, or a serving stage "
                         "(recurrence, projection, score); empty for none")
    ap.add_argument("--faults", default="",
                    help="comma-separated select faults (offbyone, key16)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("vfrbench.calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = catalog.cell(args.workload)
    dev = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None
    try:
        controls = [c for c in args.controls.split(",") if c]
        faults = [f for f in args.faults.split(",") if f]
        for seed in [int(s) for s in args.seeds.split(",")]:
            t = time.perf_counter()
            for side, r, failed in readings(cell, seed, args.seconds, dev,
                                            controls, faults):
                row = {"cell": cell.name, "seed": seed, "side": side,
                       "failed": failed, "seconds": time.perf_counter() - t,
                       **r}
                print(json.dumps(row), flush=True)
                if sink:
                    sink.write(json.dumps(row) + "\n")
                    sink.flush()
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
