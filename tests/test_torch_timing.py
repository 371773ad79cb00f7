"""The port's timing harness (``vfr_tpu_torch/utils/timing.py::
device_seconds_per_iter``) against the JAX package's
(``vfr_tpu/utils/timing.py``), on the CPU.

Both functions read ``time.perf_counter`` around each window of calls, so
a scripted clock stands in for it in both modules: window k of n calls
lasts ``FIXED + per_call * n`` seconds, plus a stall where the case puts
one.  The clock records each window's n (the port's: its body's calls;
the JAX package's: the loop count handed to its compiled program), so
the test holds the two to the same sequence of window sizes (calibration
growth from 16 by x4, the ``max_iters`` cap, ``iters`` given, one repeat
or three) and to the same returned value, exactly; where a stall hits one
window, the median of three drops it, even where it ended the
calibration.  Then the counterpart of
``tests/test_timing.py::test_positive_and_scales_with_work`` on the real
clock; each call of every window given its own index, and the baseline
refused where it is not below the window; the bound, the larger of the
bytes' and the operations' time."""

import time
import types

import jax
import numpy as np
import pytest
import torch

from vfr_tpu.utils import timing as jtiming
from vfr_tpu_torch.utils import timing as ttiming

FIXED = 0.003           # seconds a window costs whatever its calls
PER_CALL = 0.002        # grows 16 -> 64 -> 256 under min_signal 0.25


class Clock:
    """``perf_counter`` for one harness: even calls open a window, odd ones
    close it ``FIXED + per_call * n + stalls.get(k, 0)`` seconds later."""

    def __init__(self, per_call, stalls):
        self.per_call, self.stalls = per_call, stalls
        self.t, self.n, self.sizes, self.open = 1000.0, 0, [], False

    def __call__(self):
        if not self.open:
            self.open, self.n = True, 0
            return self.t
        self.open = False
        k = len(self.sizes)
        self.sizes.append(self.n)
        self.t += FIXED + self.per_call * self.n + self.stalls.get(k, 0.0)
        return self.t


def _jax_run(monkeypatch, kw, per_call, stalls):
    clock = Clock(per_call, stalls)

    def jit(fn):
        run = jax.jit(fn)

        def counted(x, salt, n, *ops):
            clock.n = int(n)
            return run(x, salt, n, *ops)
        return counted

    monkeypatch.setattr(jtiming, "time", types.SimpleNamespace(
        perf_counter=clock, sleep=time.sleep))
    monkeypatch.setattr(jtiming, "jax", types.SimpleNamespace(
        jit=jit, lax=jax.lax, errors=jax.errors))
    sec = jtiming.device_seconds_per_iter(
        lambda i, x: x * i, jax.numpy.ones(3), **kw)
    return sec, clock.sizes


def _port_run(monkeypatch, kw, per_call, stalls):
    clock = Clock(per_call, stalls)
    seen = []

    def body(i, x):
        clock.n += 1
        seen.append(i)
        return x * i

    monkeypatch.setattr(ttiming, "time", types.SimpleNamespace(
        perf_counter=clock))
    sec = ttiming.device_seconds_per_iter(body, torch.ones(3), **kw)
    assert seen == list(range(sum(clock.sizes)))
    return sec, clock.sizes


GROWN = [2, 3, 2, 16, 2, 64, 2, 256]      # warm, then calibration
CASES = {
    "calibrated": (dict(), PER_CALL, {}, GROWN + [2, 256] * 2),
    "max_iters_cap": (dict(max_iters=100), 1e-5, {},
                      [2, 3, 2, 16, 2, 64, 2, 100] + [2, 100] * 2),
    "iters_given": (dict(iters=8), PER_CALL, {}, [2, 3] + [2, 8] * 3),
    "one_repeat": (dict(repeats=1), PER_CALL, {}, GROWN),
    # window 9 is the second repeat's long one, 10 the third's baseline
    "stalled_repeat": (dict(), PER_CALL, {9: 0.3},
                       GROWN + [2, 256] * 2),
    "stalled_baseline": (dict(), PER_CALL, {10: 0.3},
                         GROWN + [2, 256] * 2),
    # a stall in the 16-call window ends the calibration there
    "stalled_calibration": (dict(), PER_CALL, {3: 0.3},
                            [2, 3, 2, 16] + [2, 16] * 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax_under_a_scripted_clock(monkeypatch, case):
    kw, per_call, stalls, sizes = CASES[case]
    j_sec, j_sizes = _jax_run(monkeypatch, kw, per_call, stalls)
    t_sec, t_sizes = _port_run(monkeypatch, kw, per_call, stalls)
    assert j_sizes == sizes
    assert t_sizes == sizes
    assert t_sec == j_sec
    # the median of three drops the one stalled window
    assert t_sec == pytest.approx(per_call, rel=1e-6)


def test_positive_and_scales_with_work():
    x_small = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))
    x_big = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (512, 512)).astype(np.float32))

    def body(i, x):
        return torch.sin(x + i) @ x.T

    # one intra-op thread: on a host busier than its cores (the test
    # workers), every op's thread-pool barrier waits on preempted threads,
    # tens of ms a call whatever the work; adaptive windows: a fixed
    # 6-call difference of the small body is tens of microseconds, which
    # a busy host's preemptions swamp, grown to 0.05 s it outweighs them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        s_small = ttiming.device_seconds_per_iter(body, x_small,
                                                  min_signal=0.05)
        s_big = ttiming.device_seconds_per_iter(body, x_big, min_signal=0.05)
    finally:
        torch.set_num_threads(threads)
    assert s_small > 0 and s_big > 0
    # 512x the FLOPs; demand at least 2x the time (CPU noise)
    assert s_big > 2 * s_small, (s_small, s_big)


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
    sec = ttiming.device_seconds_per_iter(body, torch.ones(3), iters,
                                          base_iters=base)
    assert sec > 0
    assert seen == list(range(2 * base + 1 + 3 * (base + iters)))
    for bad in (dict(iters=iters, base_iters=iters), dict(iters=-1),
                dict(iters=iters, base_iters=-1)):
        with pytest.raises(ValueError, match="base_iters"):
            ttiming.device_seconds_per_iter(body, torch.ones(3), **bad)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert ttiming.bound(ttiming.H100_BYTES_PER_S, 0.0, "bfloat16") == (
        1e3, "bytes")
    ms, by = ttiming.bound(0.0, ttiming.PEAK_FLOPS["bfloat16"], "bfloat16")
    assert (ms, by) == (1e3, "operations")
    # f32 products: the lesser of f32 FMAs and three TF32 products
    ms, _ = ttiming.bound(0.0, ttiming.PEAK_FLOPS["float32"], "float32")
    assert ms == pytest.approx(1e3 * min(1.0, 3 * ttiming.PEAK_FLOPS[
        "float32"] / ttiming.PEAK_FLOPS["tf32"]))
