"""Timing on the card, and the card's published peaks.

The counterpart of the JAX package's ``utils/timing.py``
(``device_seconds_per_iter``), with its signature and schedule: two warm
windows, then windows that grow from 16 calls by x4 until a long window
outlasts a ``base_iters`` window by ``min_signal`` seconds, then the
median of ``repeats`` such differences over the extra calls.

What is kept from JAX, and why: the baseline cancels a window's fixed
cost (here the gap from the start event to the first launch, on a card
left idle by the previous window's sync), and the median drops a window
that a stall hit.  The gaps between the calls of a window still count, as
a user pays for them.  What differs: PyTorch runs eagerly, so every call
launches its work and a window is ``n`` back-to-back calls of
``body(i, x, *operands)`` between two CUDA events, with no host sync
inside it.  ``i`` is distinct on every call of every window (JAX's
``salt``): the caller perturbs its inputs with it, so no two windows see
the same batches.  Each call's result (its first tensor) is consumed on
the device by a running max, as the JAX harness consumes it.

On a CPU tensor it uses ``time.perf_counter``: only when the caller hands
it one, never as a fallback.

``H100_BYTES_PER_S`` / ``PEAK_FLOPS`` are NVIDIA's data-sheet rates of
one H100 SXM (dense, at its 700 W limit); ``bound`` gives the least time
the card could take for a given work.  ``nvidia_smi_line`` is the card's
name and power limit, to stand beside every number kept.
"""

from __future__ import annotations

import itertools
import subprocess
import time
from typing import Callable, Tuple

import torch

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core rate
              "tf32": 495e12,       # dense tensor-core rate
              "float32": 67e12}     # f32 outside the tensor cores


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


def device_seconds_and_window(
    body: Callable[..., object],
    x: torch.Tensor,
    iters: int = 0,                 # 0 = adaptive
    base_iters: int = 2,
    repeats: int = 3,
    min_signal: float = 0.25,       # seconds the measured diff must reach
    max_iters: int = 8192,
    operands: tuple = (),
) -> Tuple[float, int]:
    """(seconds per call, the long window's calls ``n``) of
    ``device_seconds_per_iter``, whose arguments it takes."""
    if base_iters < 0 or iters < 0 or 0 < iters <= base_iters:
        raise ValueError(f"iters must be 0 (adaptive) or above base_iters="
                         f"{base_iters} >= 0, got {iters}")
    dev = x.device
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    calls = itertools.count()

    def run(n):
        for _ in range(n):
            out = _first(body(next(calls), x, *operands)).detach()
            torch.maximum(acc, out.float().amax(), out=acc)

    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def window(n):
            with torch.cuda.device(dev):
                start.record()
                run(n)
                end.record()
                end.synchronize()
            return start.elapsed_time(end) / 1e3
    else:
        def window(n):
            t0 = time.perf_counter()
            run(n)
            return time.perf_counter() - t0

    window(base_iters)               # warm
    window(base_iters + 1)

    n = iters if iters else 16
    while True:
        t_base = window(base_iters)
        diff = window(n) - t_base
        if iters or diff >= min_signal or n >= max_iters:
            break
        n = min(n * 4, max_iters)

    diffs = [diff]
    for _ in range(max(repeats - 1, 0)):
        t_base = window(base_iters)
        diffs.append(window(n) - t_base)
    diffs.sort()
    med = diffs[len(diffs) // 2]
    return max(med / (n - base_iters), 1e-12), n


def device_seconds_per_iter(
    body: Callable[..., object],
    x: torch.Tensor,
    iters: int = 0,
    base_iters: int = 2,
    repeats: int = 3,
    min_signal: float = 0.25,
    max_iters: int = 8192,
    operands: tuple = (),
) -> float:
    """Seconds per call of ``body(i, x, *operands)`` on ``x``'s device.

    Two warm windows of ``base_iters`` and ``base_iters + 1`` calls; then
    ``n = iters or 16`` and one measurement t(n) - t(base_iters), each
    window timed on its own, ``n`` grown x4 (to at most ``max_iters``)
    until the difference reaches ``min_signal`` seconds, unless ``iters``
    was given; ``repeats - 1`` more measurements at that ``n``; the median
    difference over ``n - base_iters``.  ``iters`` is 0 (adaptive) or
    above ``base_iters``.  CUDA: events around each window, no sync
    inside one.  CPU: the host clock, the same calls."""
    return device_seconds_and_window(body, x, iters, base_iters, repeats,
                                     min_signal, max_iters, operands)[0]
