"""Timing on the card, and the card's published peaks.

The counterpart of the JAX package's ``utils/timing.py``
(``device_seconds_per_iter``).  There the measured body runs inside one
compiled loop, the loop index perturbs its inputs so that no iteration can
be elided, and a small-iteration baseline is subtracted to cancel a remote
runtime's fixed cost.  Here PyTorch runs eagerly: every call launches its
work, so ``device_seconds_per_iter`` records CUDA events around ``iters``
back-to-back calls of ``body(i, x)``, each with its own ``i`` (the caller
perturbs its inputs with it: a different batch every call), and adds no
host sync of its own between them.  Each result is consumed on the device
(a running max), as the JAX harness consumes it.  The mean is stream time
per call over every timed call: where the host cannot keep the card busy,
or stalls, the gaps count, as a user pays for them.  Events on the card
have no fixed relay cost, so nothing is subtracted.

On a CPU tensor it uses ``time.perf_counter``: only when the caller hands
it one, never as a fallback.

``H100_BYTES_PER_S`` / ``PEAK_FLOPS`` are NVIDIA's data-sheet rates of
one H100 SXM (dense, at its 700 W limit); ``bound`` gives the least time
the card could take for a given work.  ``nvidia_smi_line`` is the card's
name and power limit, to stand beside every number kept.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core rate
              "tf32": 495e12,       # dense tensor-core rate
              "float32": 67e12}     # f32 outside the tensor cores
WARMUP = 3                          # untimed calls before the timed ones


def nvidia_smi_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float, dtype: str):
    """(ms, "bytes" | "operations").  f32 products can run as f32 FMAs or,
    to the same accuracy, as three TF32 tensor-core products of hi/lo
    splits: the operations time of "float32" is the lesser of the two."""
    t_bytes = bytes_moved / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    if dtype == "float32":
        t_ops = min(t_ops, 3.0 * flops / PEAK_FLOPS["tf32"])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _first(out) -> torch.Tensor:
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def device_seconds_per_iter(
    body: Callable[[int, torch.Tensor], object],
    x: torch.Tensor,
    iters: int = 20,
) -> float:
    """Mean seconds per call of ``body(i, x)`` on ``x``'s device:
    ``WARMUP`` calls, then ``iters`` timed ones, ``i`` running from 0 over
    all of them; the total time of the timed calls over ``iters``, so a
    stall inside the window counts.  Each call's result (its first tensor)
    is consumed on the device.  CUDA: events around the timed calls, no
    sync among them.  CPU: the host clock, the same calls."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev = x.device
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    calls = iter(range(WARMUP + iters))

    def run(n):
        for _ in range(n):
            out = _first(body(next(calls), x)).detach()
            torch.maximum(acc, out.float().amax(), out=acc)

    if dev.type != "cuda":
        run(WARMUP)
        t0 = time.perf_counter()
        run(iters)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(dev):
        run(WARMUP)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(iters)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
