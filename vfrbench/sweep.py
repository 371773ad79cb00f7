"""The daemon's offered-rate sweep: the highest rate the port sustains.

    python3 -m vfrbench.sweep --workload flagship-daemon \\
        --rates 4000,6000,8000 [--seconds 5] [--seed 1]

Runs the cell's daemon at each rate in turn (its own set-up each time, in
one process) and prints one JSON line a rate: requests offered and
answered a second, latency quantiles from the due time, how late the
offers went out, and the backlog's trend (the median latency of the last
quarter of the requests over the first quarter's).  A rate is sustained
while completions keep pace with the offers and that trend stays near 1;
past it the queue grows all through the window.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from vfrbench import catalog
from vfrbench.trace import Tracer


def at_rate(cell, rate: float, seconds: float, seed: int, dev):
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  rate_per_s=rate))
    cfg = catalog.experiment(cell.config)
    drv = catalog.load_module("drivers", "daemon")
    st = drv.setup(cell, cfg, seed, seconds, dev)
    win = drv.window(st, seconds, Tracer(False, seconds))
    drv.release(st)
    lat = win["latency_s"]
    q = max(1, len(lat) // 4)
    ms = 1e3 * np.quantile(lat, [0.5, 0.95, 0.99])
    return {"rate": rate, "offered_per_s": win["requests"] / seconds,
            "answered_per_s": win["answered"] / win["seconds"],
            "p50_ms": ms[0], "p95_ms": ms[1], "p99_ms": ms[2],
            "late_p99_ms": 1e3 * float(np.quantile(win["late_s"], 0.99)),
            "trend": float(np.median(lat[-q:]) / np.median(lat[:q])),
            "failed": win["failed"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="flagship-daemon")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("vfrbench.sweep: no CUDA card", file=sys.stderr)
        return 3
    cell = catalog.cell(args.workload)
    dev = torch.device("cuda", 0)
    for rate in [float(r) for r in args.rates.split(",")]:
        print(json.dumps(at_rate(cell, rate, args.seconds, args.seed, dev)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
