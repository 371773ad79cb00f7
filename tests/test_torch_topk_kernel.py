"""The long-row top-k kernel's host side (``ops/kernels/topk_kernel.py``,
``csrc/row_topk.cu``) on the CPU:

* ``plan_row_topk``: slices a row for a batch, a daemon pack and one row;
  no slice shorter than ``MIN_SLICE`` and no more than ``MAX_SLICES`` a
  row; at least two pass-1 blocks a SM where these allow; the slices
  cover the row, none empty.
* ``ops/topk.py::select_route``: the kernel only for contiguous f32 rows
  longer than ``KEY_MAX`` on the card with ``1 <= k <= K_MAX``; every other
  input keeps the route it had (64-bit key, or 32-bit order and tie pass).
* ``row_topk_plain`` (the kernel's algorithm: each slice's k best, then
  theirs) against ``jax.lax.top_k``, bit for bit, on rows whose ties
  straddle every slice boundary; ``row_topk`` refuses every input the
  kernel does not take, a CPU tensor included.
* The kernel source: its ``__global__`` names match neither the
  benchmark's GEMM nor its recurrence name pattern
  (``vfrbench/trace.py``), and its ``kKMax`` is ``K_MAX``.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu_torch.ops import topk
from vfr_tpu_torch.ops.kernels import topk_kernel
from vfr_tpu_torch.ops.kernels.topk_kernel import (
    K_MAX,
    MAX_SLICES,
    MIN_SLICE,
    plan_row_topk,
    row_topk,
    row_topk_plain,
)
from torch_kernel_route import H100_SMS
from vfrbench.trace import GEMM, RECURRENCE

SOURCE = os.path.join(os.path.dirname(topk_kernel.__file__), "..", "..",
                      "csrc", "row_topk.cu")
N_CELL = 210_000


@pytest.mark.parametrize("Q, slices", [(1, 16), (8, 16), (16, 16), (32, 9),
                                       (256, 2)])
def test_plan_slices_a_row_by_the_batch(Q, slices):
    plan = plan_row_topk(Q, N_CELL, 100, 132)
    assert plan.slices == slices
    assert plan.slice_len >= MIN_SLICE
    # two blocks a SM where the row and MAX_SLICES allow, else as many as
    # they allow
    assert Q * plan.slices >= min(2 * 132, Q * MAX_SLICES,
                                  Q * (N_CELL // MIN_SLICE))


@pytest.mark.parametrize("N", [topk.KEY_MAX + 1, 52_500, N_CELL, N_CELL + 3,
                               MIN_SLICE - 1, 5])
@pytest.mark.parametrize("Q", [1, 8, 256, 5000])
@pytest.mark.parametrize("k", [1, 100, K_MAX])
def test_plan_covers_the_row(N, Q, k):
    plan = plan_row_topk(Q, N, k, 132)
    assert plan.slice_len % 4 == 0
    assert (plan.slices - 1) * plan.slice_len < N <= plan.slices * \
        plan.slice_len
    assert plan.slice_len >= min(MIN_SLICE, N)
    assert plan.slices <= MAX_SLICES
    if Q >= 2 * 132:
        assert plan.slices == 1


def test_plan_refuses_an_empty_call():
    with pytest.raises(ValueError):
        plan_row_topk(0, 10, 1, 132)


F32 = torch.float32
LONG = topk.KEY_MAX + 1
BIG = topk.KEY_BATCH * topk.KEY_MAX + LONG       # past the 64-bit key's batch


@pytest.mark.parametrize("args, route", [
    (("cuda", F32, True, LONG, 10, LONG), "kernel"),
    (("cuda", F32, True, LONG, 10, BIG), "kernel"),
    (("cuda", F32, True, N_CELL, 1, BIG), "kernel"),
    (("cuda", F32, True, N_CELL, K_MAX, BIG), "kernel"),
    (("cuda", F32, True, N_CELL, K_MAX + 1, BIG), "order32_tie"),
    (("cuda", F32, True, N_CELL, K_MAX + 1, N_CELL), "key64"),
    (("cuda", F32, True, N_CELL, 0, BIG), "key64"),
    (("cuda", F32, True, topk.KEY_MAX, 10, BIG), "key64"),
    (("cuda", F32, False, N_CELL, 10, BIG), "order32_tie"),
    (("cuda", torch.bfloat16, True, N_CELL, 10, BIG), "order32_tie"),
    (("cuda", torch.float64, True, N_CELL, 10, N_CELL), "key64"),
    (("cpu", F32, True, N_CELL, 10, BIG), "order32_tie"),
    (("cpu", F32, True, N_CELL, 10, N_CELL), "key64"),
    (("cpu", F32, True, 100, 10, 100), "key64"),
    (("meta", F32, True, N_CELL, 10, BIG), "order32_tie"),
])
def test_select_route(args, route):
    assert topk.select_route(*args) == route


def test_the_route_takes_the_tensor_as_it_is(monkeypatch):
    """``topk_lowest_index`` asks ``select_route`` with the tensor's own
    device, dtype, contiguity and sizes, k cut to the row."""
    seen = []
    real = topk.select_route
    monkeypatch.setattr(topk, "select_route",
                        lambda *a: seen.append(a) or real(*a))
    x = torch.randn(3, LONG).t()
    topk.topk_lowest_index(x, 5)
    topk.topk_lowest_index(torch.randn(2, 7), 9)
    assert seen == [("cpu", F32, False, 3, 3, 3 * LONG),
                    ("cpu", F32, True, 7, 7, 14)]


def _straddled(Q, N, k, plan, seed):
    """[Q, N] normals with a tie of 9.0 over 2 (k // 2 + 1) columns around
    every slice boundary (the middle of a one-slice row): the k-th place
    falls inside the ties, on both sides of a boundary."""
    x = np.random.default_rng(seed).standard_normal((Q, N)).astype(
        np.float32)
    w = k // 2 + 1
    for e in [s * plan.slice_len for s in range(1, plan.slices)] or [N // 2]:
        x[:, max(0, e - w):e + w] = 9.0
    return x


def _assert_lax(v, i, x, k):
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))


@pytest.mark.parametrize("N", [LONG, 40_003])
@pytest.mark.parametrize("Q", [1, 3])
@pytest.mark.parametrize("k", [1, 10, 100, K_MAX])
def test_plain_keeps_lax_order_across_slice_boundaries(N, Q, k):
    plan = plan_row_topk(Q, N, k, H100_SMS)
    assert plan.slices > 1
    x = _straddled(Q, N, k, plan, seed=N + Q + k)
    v, i = row_topk_plain(torch.from_numpy(x), k, plan)
    _assert_lax(v, i, x, k)
    # the k-th place lies inside the ties, and for k > 1 the k taken
    # cross the first boundary
    assert (v[:, -1] == 9.0).all()
    e = plan.slice_len
    if k > 1:
        assert ((i == e - 1).any(1) & (i == e).any(1)).all()


@pytest.mark.parametrize("slices", [1, 2, 7])
def test_plain_is_exact_for_any_slices(slices):
    """Any cut of the row gives the same answer: ascending rows (every
    value enters each slice's best) and one repeated value."""
    N, k = 9_001, 37
    length = -(-N // slices)
    length += (-length) % 4
    plan = topk_kernel.RowTopkPlan(-(-N // length), length)
    for x in (np.arange(N, dtype=np.float32)[None].repeat(2, 0),
              np.full((2, N), -0.0, np.float32)):
        v, i = row_topk_plain(torch.from_numpy(x), k, plan)
        _assert_lax(v, i, x, k)


def test_plain_takes_leading_dims():
    x = torch.randn(2, 3, LONG)
    plan = plan_row_topk(6, LONG, 20, H100_SMS)
    v, i = row_topk_plain(x, 20, plan)
    pv, pi = row_topk_plain(x.reshape(6, LONG), 20, plan)
    assert v.shape == i.shape == (2, 3, 20) and i.dtype == torch.int64
    assert torch.equal(v.reshape(6, 20), pv)
    assert torch.equal(i.reshape(6, 20), pi)


@pytest.mark.parametrize("x, k, why", [
    (torch.randn(2, LONG, dtype=torch.bfloat16), 4, "contiguous f32"),
    (torch.randn(LONG, 2).t(), 4, "contiguous f32"),
    (torch.randn(2, LONG), K_MAX + 1, "out of 1"),
    (torch.randn(2, LONG), 0, "out of 1"),
    (torch.randn(2, 3), 4, "out of 1"),
    (torch.randn(2, LONG), 4, "not a CUDA device"),
    (torch.zeros(0, LONG), 4, "not a CUDA device"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(x, k, why):
    with pytest.raises(ValueError, match=why):
        row_topk(x, k)


def _source():
    with open(SOURCE) as f:
        return f.read()


def test_kernel_names_stay_out_of_the_benchmark_name_split():
    """The benchmark's name split takes the longest GEMM-named kernel after
    the recurrence as the score: no name of the select may look like
    either, nor any template argument come from cutlass."""
    src = _source()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", src)
    assert sorted(names) == ["row_topk_filter", "row_topk_merge"]
    for name in names:
        assert not GEMM.search(name) and not RECURRENCE.search(name)
    assert not re.search("cutlass", src, re.IGNORECASE)


def test_kernel_k_limit_is_the_module_s():
    assert re.search(rf"constexpr int kKMax = {K_MAX};", _source())
