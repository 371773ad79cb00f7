"""Run one cell of the benchmark once and print its result line.

    python3 -m vfrbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up (imports, the card, the kernels'
build on a checkout's first run, seeded weights and inputs, the port's
set-up and warm-up) runs from the process's start to the window's first
call; the window measures for ``--seconds``; then the port's state is
freed and the plain reference judges what the window produced.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit;
the same numbers are the last lines of standard error.

Without a CUDA card, with fewer cards than the cell asks for, or with JAX
or the JAX package loaded once the window has closed, it exits with a code
other than 0 and prints no result.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from vfrbench import catalog  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vfr_tpu")
CACHE = os.path.join(catalog.REPO, ".vfrbench_cache")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: "catalog.Cell", seed: int, seconds: float, traced: bool,
             dev, t_start: float, bench: Optional[Dict] = None,
             root: str = catalog.ROOT, chips: int = 1) -> Dict:
    """One run of ``cell`` on ``dev``: its result line as a dict."""
    import torch

    from vfrbench.reference import judge
    from vfrbench.trace import Tracer

    card = torch.device(dev).type == "cuda"
    cfg = catalog.experiment(cell.config)
    driver = catalog.load_module("drivers", cell.driver, root)
    st = driver.setup(cell, cfg, seed, seconds, dev)
    tracer = Tracer(traced, seconds)
    tracer.warm()
    setup_s = time.perf_counter() - t_start
    win = driver.window(st, seconds, tracer)
    mem = int(torch.cuda.max_memory_allocated(dev)) if card else 0
    tr = tracer.result()
    driver.release(st)
    readings = driver.check(st)
    ok, rows = judge.verdict(readings, cell.limits)
    failed = int(win.get("failed", 0))
    record = {"kind": cell.driver, "setup_s": setup_s, "window": win,
              "trace": tr, "root": root}
    modules = catalog.metric_modules(root)
    wanted = catalog.cell_metrics(
        bench, cell.name, traced,
        [n for n, m in modules.items() if bool(m.TRACED) == traced])
    metrics = {}
    for name in wanted:
        value = modules[name].read(record) if name in modules else None
        if value is not None:
            metrics[name] = {"value": float(value), "unit": modules[name].UNIT}
    device = {"platform": "gpu" if card else "cpu",
              "kind": (torch.cuda.get_device_name(dev) if card
                       else "cpu"),
              "count": chips, "memory_peak_bytes": mem}
    line = {"correct": bool(ok and failed == 0),
            "attempted": int(win["attempted"]), "failed": failed,
            "metrics": metrics, "device": device}
    if tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in rows}
    return line


def _caches() -> None:
    """Kernel caches of the libraries under the checkout, at fixed paths
    (the port builds its own kernels in ``vfr_tpu_torch/_build``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ.setdefault(var, os.path.join(CACHE, sub))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = catalog.cell(args.workload)
    chips = int(cell.cell["chips"])
    _caches()
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"vfrbench: the cell {cell.name} needs {chips} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                    _T_START, bench=catalog.benchmark(), chips=chips)
    bad = forbidden_modules()
    if bad:
        print(f"vfrbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"check correct = {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
