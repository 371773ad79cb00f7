"""The port's bench entry point (``vfr_tpu_torch/bench.py``) and its timing
harness (``vfr_tpu_torch/utils/timing.py``) on the CPU: the harness gives
every call of every window its own index and returns a positive time; it
refuses a long window no longer than the baseline; the bench prints one
JSON line with the JAX bench's top-level keys and metric name, under
1,500 bytes, whose value is the index rows over the batch seconds and
whose timing names the method; without CUDA it raises unless ``--device
cpu`` is given.  The bench runs in a subprocess at its smallest corpus (8
videos) on the smallest schedule of the harness: one warm call and one
timed call a row (``--iters 1 --base-iters 0 --repeats 1``), so that it
ends well inside its limit on a loaded CPU and no window difference can go
negative.  The harness is held to the JAX package's under a scripted clock
in ``test_torch_timing.py``."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from vfr_tpu_torch import bench
from vfr_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}


@pytest.mark.parametrize("iters", [1, 4])
def test_device_seconds_per_iter_calls_each_index_once(iters):
    """``iters`` given, over the largest baseline below it (at most 2):
    two warm windows of base and base + 1 calls, then 3 repeats of a base
    and an ``iters`` window; each index once across them all."""
    seen = []

    def body(i, x):
        seen.append(i)
        return x * i

    base = min(2, iters - 1)
    sec = timing.device_seconds_per_iter(body, torch.ones(3), iters,
                                         base_iters=base)
    assert sec > 0
    assert seen == list(range(2 * base + 1 + 3 * (base + iters)))
    for bad in (dict(iters=iters, base_iters=iters), dict(iters=-1),
                dict(iters=iters, base_iters=-1)):
        with pytest.raises(ValueError, match="base_iters"):
            timing.device_seconds_per_iter(body, torch.ones(3), **bad)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert timing.bound(timing.H100_BYTES_PER_S, 0.0, "bfloat16") == (
        1e3, "bytes")
    ms, by = timing.bound(0.0, timing.PEAK_FLOPS["bfloat16"], "bfloat16")
    assert (ms, by) == (1e3, "operations")
    # f32 products: the lesser of f32 FMAs and three TF32 products
    ms, _ = timing.bound(0.0, timing.PEAK_FLOPS["float32"], "float32")
    assert ms == pytest.approx(1e3 * min(1.0, 3 * timing.PEAK_FLOPS[
        "float32"] / timing.PEAK_FLOPS["tf32"]))


def test_bench_line_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="4")
    r = subprocess.run(
        [sys.executable, "-m", "vfr_tpu_torch.bench", "--device", "cpu",
         "--videos", "8", "--iters", "1", "--base-iters", "0",
         "--repeats", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1, r.stdout
    assert len(lines[0].encode()) < 1500
    line = json.loads(lines[0])
    assert set(line) == TOP_KEYS
    assert line["metric"] == "proposals_scored_per_query_per_chip_per_sec"
    d = line["detail"]
    assert d["backend"] == "cpu" and d["index_rows"] == 8 * 21
    rate = d["index_rows"] / (d["batch_latency_ms"] / 1e3)
    assert line["value"] == pytest.approx(rate, rel=1e-5, abs=0.1)
    assert line["vs_baseline"] == pytest.approx(line["value"] / 1e5,
                                                abs=1e-3)
    # times and rates (the stage differences can go negative at this size)
    nums = [d["batch_latency_ms"], d["train_step_ms"],
            *d["flagship_serving"].values(), *d["flagship_train"].values()]
    assert all(math.isfinite(x) and x > 0 for x in nums)
    assert set(d["stages_ms"]) == {"encode", "score_direct", "topk",
                                   "score_prefix_diff"}
    assert d["timing"] == ("host clock (cpu): median of 1, n=1, "
                           "base 0 subtracted; headline n=1")


def test_bench_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--device", "cuda", "--videos", "8"])
