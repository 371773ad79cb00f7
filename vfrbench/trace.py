"""The traced run: torch.profiler over the window's steady part, the
benchmark's own host spans, and their reduction.

The profiler traces the card alone (CUDA activity: kernels, copies and
fills, each with its device start and duration; the kernels of one CUDA
graph replay share the replay's correlation id).  It runs from a quarter
of the window for at most ``TRACE_SECONDS``, so its trace holds a few
hundred batches or steps and is read within the run's time; its first
start in a process takes seconds, so ``Tracer.warm`` pays it before the
window.  The host
spans are the benchmark's, around its calls into the port, on the clock
the profiler stamps its events with (``time.time_ns``).

Reductions: ``busy_s``, the union of the device intervals inside the
traced window; ``window_s``, its length; ``device_ops``, the operations
that took most device time; ``idle_gaps``, the longest spans of the
window in which nothing ran on the card, each named by the host span it
fell in ("harness" outside every span).
"""

from __future__ import annotations

import re
import time
import warnings
from typing import Dict, List, Optional, Tuple

TRACE_SECONDS = 3.0
START_AT = 0.25

Kernel = Tuple[int, int, str, int]    # start ns, duration ns, name, corr


class Tracer:
    """Starts and stops the profiler inside a window of ``seconds`` (when
    ``enabled``); records the benchmark's host spans while it runs."""

    def __init__(self, enabled: bool, seconds: float):
        self.enabled = enabled
        self.begin = START_AT * seconds
        self.length = min(TRACE_SECONDS, 0.5 * seconds)
        self.prof = None
        self.on = False
        self.done = False
        self.t0_ns = self.t1_ns = 0
        self.spans: List[Tuple[str, int, int]] = []
        self.counts: Dict[str, int] = {}

    def warm(self) -> None:
        """Start and stop the profiler once before the window, so that the
        tracer's own initialisation (seconds, the first time in a process)
        is set-up and not a stall inside the window."""
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]):
                torch.ones(1).to("cuda" if torch.cuda.is_available()
                                 else "cpu").sum()

    def tick(self, elapsed: float) -> None:
        """Called by the window's loop with the seconds since it began."""
        if not self.enabled or self.done:
            return
        if not self.on and elapsed >= self.begin:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0_ns = time.time_ns()
            self.on = True
        elif self.on and time.time_ns() - self.t0_ns >= self.length * 1e9:
            self.stop()

    def stop(self) -> None:
        """Close the traced window (at the window's end at the latest)."""
        if self.on:
            import torch

            self.t1_ns = time.time_ns()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                self.prof.__exit__(None, None, None)
            self.on = False
            self.done = True

    def count(self, what: str, n: int = 1) -> None:
        """Count ``what`` while the profiler runs (batches, steps)."""
        if self.on:
            self.counts[what] = self.counts.get(what, 0) + n

    def span(self, name: str):
        return _Span(self, name)

    def result(self) -> Optional[Dict]:
        """The traced window's reduction, or None when nothing was traced."""
        self.stop()
        if self.prof is None:
            return None
        kernels = device_events(self.prof)
        t0, t1 = self.t0_ns, self.t1_ns
        inside = [k for k in kernels if k[0] + k[1] > t0 and k[0] < t1]
        busy = union_ns(inside, t0, t1)
        return {
            "window_s": (t1 - t0) / 1e9,
            "busy_s": busy / 1e9,
            "kernels": inside,
            "counts": dict(self.counts),
            "device_ops": top_ops(inside),
            "idle_gaps": idle_gaps(inside, t0, t1, self.spans),
        }


class _Span:
    def __init__(self, tracer: Tracer, name: str):
        self.t, self.name = tracer, name

    def __enter__(self):
        self.a = time.time_ns() if self.t.on else 0
        return self

    def __exit__(self, *exc):
        if self.a and self.t.on:
            self.t.spans.append((self.name, self.a, time.time_ns()))


def device_events(prof) -> List[Kernel]:
    """(start ns, duration ns, name, correlation id) of every device
    event of the profile, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        out.append((int(e.start_ns()), int(e.duration_ns()), e.name(),
                    int(e.correlation_id())))
    out.sort()
    return out


def merged(kernels: List[Kernel], t0: int, t1: int) -> List[Tuple[int, int]]:
    """The device's busy intervals [a, b) inside [t0, t1), merged."""
    iv = []
    for s, d, _, _ in kernels:
        a, b = max(s, t0), min(s + d, t1)
        if b <= a:
            continue
        if iv and a <= iv[-1][1]:
            iv[-1][1] = max(iv[-1][1], b)
        else:
            iv.append([a, b])
    return [(a, b) for a, b in iv]


def union_ns(kernels: List[Kernel], t0: int, t1: int) -> int:
    return sum(b - a for a, b in merged(kernels, t0, t1))


_TEMPLATE = re.compile(r"[<(].*$")


def short_name(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    n = name[5:] if name.startswith("void ") else name
    n = _TEMPLATE.sub("", n).strip()
    return n[-80:] or name[:80]


def top_ops(kernels: List[Kernel], n: int = 10) -> List[List]:
    tot: Dict[str, int] = {}
    for _, d, name, _ in kernels:
        k = short_name(name)
        tot[k] = tot.get(k, 0) + d
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in rows]


def idle_gaps(kernels: List[Kernel], t0: int, t1: int,
              spans: List[Tuple[str, int, int]], n: int = 10) -> List[List]:
    """The ``n`` longest idle spans of [t0, t1), each named by the host
    span its midpoint fell in."""
    iv = merged(kernels, t0, t1)
    gaps = []
    prev = t0
    for a, b in iv:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if t1 > prev:
        gaps.append((prev, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = sorted(spans, key=lambda s: s[1])
    out = []
    for a, b in gaps[:n]:
        mid = (a + b) // 2
        name = "harness"
        for sname, sa, sb in spans:
            if sa <= mid < sb:
                name = sname
            if sa > mid:
                break
        out.append([name, (b - a) / 1e9])
    return out


# ------------------------------------------------------------- stages

GEMM = re.compile(r"gemm|Gemm|GEMM|xmma|cutlass|nvjet")
RECURRENCE = re.compile(r"rnn_|lstm|gru", re.IGNORECASE)


def replays(kernels: List[Kernel]) -> List[List[Kernel]]:
    """The kernels of each serving batch's graph replay: the groups of one
    correlation id that hold a recurrence kernel, each by start."""
    groups: Dict[int, List[Kernel]] = {}
    for k in kernels:
        groups.setdefault(k[3], []).append(k)
    return [sorted(g) for g in groups.values()
            if any(RECURRENCE.search(k[2]) for k in g)]


def stage_seconds(replay: List[Kernel]) -> Optional[Dict[str, float]]:
    """Device seconds of a batch's stages: ``score`` the index GEMM (the
    longest GEMM after the recurrence) and the kernel after it (the
    squared norms' subtraction); ``encode`` every kernel before it (the
    recurrence, the projection, the normalisation and the few small
    kernels that scale and cast the queries for the score); ``select``
    every kernel after it.  None when no such GEMM is found."""
    rec = [i for i, k in enumerate(replay) if RECURRENCE.search(k[2])]
    if not rec:
        return None
    cands = [i for i, k in enumerate(replay)
             if i > rec[-1] and GEMM.search(k[2])]
    if not cands:
        return None
    g = max(cands, key=lambda i: replay[i][1])
    if g + 1 >= len(replay):
        return None
    dur = [k[1] / 1e9 for k in replay]
    return {"encode": sum(dur[:g]), "score": dur[g] + dur[g + 1],
            "select": sum(dur[g + 2:])}
