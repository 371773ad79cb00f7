"""The f32 score kernel's host side (``ops/kernels/score_kernel.py``,
``csrc/score_gemm.cu``) and its route (``parallel/sharding.py``) on the CPU:

* ``score_route``: the plain product on the CPU, the library's bf16 GEMM
  for a bf16 product off the CPU, the kernel for an f32 product on the
  card of operands it takes; everything else on the card raises
  (misaligned, non-contiguous or too-long rows, other dtypes).
* ``score_gemm_plain`` is the exact f32 product (``device.mm_f32``), bit
  for bit; ``score_mm`` on CPU tensors is unchanged.
* A model of the kernel's split arithmetic (x = hi + lo, hi the TF32 the
  tensor core reads, lo rounded to TF32; lo.hi + hi.lo + hi.hi) against an
  f64 product at flagship-like operands (unit-norm stream rows, K = 256
  and 128): each score within 2^-19 of its sum of |a_k m_k|, where one
  TF32 product alone is not; and of the tensor cores' truncating
  accumulators: a fresh one a stage, as the kernel takes them, stays near
  an f32 product's error, one for all of K does not.
* ``plan_score_gemm``: the tile shape (wide past 64 queries, else a pack
  of 16 or 64) and grid at a daemon's packs, the flagship batch and the
  shards' rows.
* ``score_gemm`` refuses every input the kernel does not take, a CPU
  tensor included; through the CPU stand-in, ``fused_corpus_scores``
  takes the kernel once a product and subtracts ``msq`` after it.
* The kernel source: a ``__global__`` a tile shape, each named so that the
  benchmark's GEMM pattern finds it (and not its recurrence pattern); its K
  limit and tile shapes are the module's; its shared memory fits an H100's
  SM.
"""

import os
import re

import numpy as np
import pytest
import torch

from torch_kernel_route import H100_SMS, route_scores_to_the_plain_kernel
from vfr_tpu_torch.device import mm_f32
from vfr_tpu_torch.ops.kernels import score_kernel
from vfr_tpu_torch.ops.kernels.score_kernel import (
    K_MAX,
    PACK_Q,
    SHAPES,
    plan_score_gemm,
    score_gemm,
    score_gemm_plain,
)
from vfr_tpu_torch.parallel import sharding
from vfr_tpu_torch.utils import trace
from vfrbench.trace import GEMM, RECURRENCE

SOURCE = os.path.join(os.path.dirname(score_kernel.__file__), "..", "..",
                      "csrc", "score_gemm.cu")
F32, BF16 = torch.float32, torch.bfloat16
N_CELL = 210_000


def _rows(n, k, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, k)).astype(np.float32))


def _misaligned(n, k):
    """[n, k] f32 rows 4 bytes past a 16-byte boundary."""
    flat = torch.randn(n * k + 4)
    off = next(o for o in range(4) if (flat.data_ptr() + 4 * o) % 16 == 4)
    return flat[off:off + n * k].view(n, k)


# -- the route ---------------------------------------------------------------

@pytest.mark.parametrize("device_type, in_dtype, route", [
    ("cpu", F32, "plain"), ("cpu", BF16, "plain"),
    ("cpu", torch.float16, "plain"),
    ("cuda", BF16, "library"), ("meta", BF16, "library"),
    ("cuda", F32, "kernel"),
])
def test_score_route(device_type, in_dtype, route):
    a, m = _rows(8, 256), _rows(100, 256, 1)
    assert sharding.score_route(device_type, in_dtype, a, m.T) == route


def _view_of(width, cols=256):
    """The first ``cols`` columns of [100, ``width``] rows."""
    return _rows(100, width, 1)[:, :cols]


@pytest.mark.parametrize("make_m, why", [
    (lambda: _misaligned(100, 256), "aligned"),
    (lambda: _rows(256, 100).T, "contiguous rows"),
    (lambda: _view_of(258), "contiguous rows"),
    (lambda: _rows(100, 12), "multiple of 8"),
    (lambda: _rows(100, 264), "multiple of 8"),
    (lambda: _rows(100, 256).to(BF16), "f32 operands"),
])
def test_the_card_refuses_what_the_kernel_does_not_take(make_m, why):
    m = make_m()
    a = _rows(8, m.shape[1])
    with pytest.raises(ValueError, match=why):
        sharding.score_route("cuda", F32, a, m.T)


def test_rows_with_a_longer_stride_are_taken():
    m = _view_of(264)
    assert m.stride() == (264, 1)
    assert sharding.score_route("cuda", F32, _rows(8, 256), m.T) == "kernel"


@pytest.mark.parametrize("device_type, in_dtype", [
    ("cuda", torch.float16), ("meta", F32)])
def test_no_other_product_off_the_cpu(device_type, in_dtype):
    with pytest.raises(ValueError, match="no score product"):
        sharding.score_route(device_type, in_dtype, _rows(8, 256),
                             _rows(100, 256).T)


def test_the_route_takes_the_operands_as_they_are(monkeypatch):
    seen = []
    real = sharding.score_route
    monkeypatch.setattr(sharding, "score_route",
                        lambda *a: seen.append(a) or real(*a))
    a, m = _rows(4, 16), _rows(30, 16, 1)
    sharding.score_mm(a, m.T, F32)
    (dt, ind, a_seen, b_seen), = seen
    assert (dt, ind) == ("cpu", F32)
    assert a_seen is a and b_seen.shape == (16, 30)


# -- the plain version and the CPU path ----------------------------------------

@pytest.mark.parametrize("Q, N, K", [(1, 37, 8), (8, 300, 128),
                                     (70, 513, 256)])
def test_plain_is_the_exact_f32_product(Q, N, K):
    a, m = _rows(Q, K, Q), _rows(N, K, N)
    got = score_gemm_plain(a, m)
    assert got.dtype == F32 and got.shape == (Q, N)
    assert torch.equal(got, mm_f32(a, m.T, F32))


def test_score_mm_on_the_cpu_is_unchanged():
    trace.reset()
    a, m = _rows(8, 256), _rows(90, 256, 1)
    for dt in (F32, BF16):
        assert torch.equal(sharding.score_mm(a, m.T, dt), mm_f32(a, m.T, dt))
    # and counts no route: the recorder counts the card's products
    assert not any(k.startswith("score.") for k in trace.counters())


# -- the split arithmetic ------------------------------------------------------

def _trunc(x):
    """x as the tensor core reads it: the low 13 mantissa bits cleared."""
    return (x.view(torch.int32) & -8192).view(F32)


def _rna(x):
    """x rounded to TF32, to nearest with ties away from zero (cvt.rna)."""
    b = x.view(torch.int32)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (mag | (b & -0x80000000)).view(F32)


def _split(x):
    """(hi, lo): hi as the tensor core reads x (truncated), lo the rest
    rounded to TF32 (read truncated, exactly)."""
    hi = _trunc(x)
    return hi, _rna(x - hi)


def _flagship_operands(Q=64, N=1500, S=2, seed=5):
    """Queries and index rows of S unit-norm streams of 128, concatenated
    (K = S x 128): the flagship's query_cat_scaled at weights 0.5 (2 w q
    = q) and its stream-concatenated rows at S = 2."""
    g = torch.Generator().manual_seed(seed)

    def unit(n):
        x = torch.randn(S, n, 128, generator=g)
        x = x / x.norm(dim=-1, keepdim=True)
        return torch.cat(list(x), dim=-1)

    return unit(Q), unit(N)


@pytest.mark.parametrize("S", [2, 1])
def test_split_arithmetic_keeps_f32_accuracy(S):
    """The kernel's products in f64, lo.hi + hi.lo + hi.hi with lo.lo
    dropped: each score within 2^-19 of its sum of |a_k m_k| (the
    dropped term and lo's rounding, each at most 2^-20 and 2^-21 of a
    product), where one TF32 product alone is not."""
    a, m = _flagship_operands(S=S)
    (ah, al), (mh, ml) = _split(a), _split(m)
    d = torch.float64
    model = (al.to(d) @ mh.to(d).T + ah.to(d) @ ml.to(d).T
             + ah.to(d) @ mh.to(d).T)
    exact = a.double() @ m.double().T
    scale = a.double().abs() @ m.double().abs().T      # sum_k |a_k m_k|
    err = (model - exact).abs() / scale
    assert err.max() < 2.0 ** -19
    tf32 = (ah.double() @ mh.double().T - exact).abs() / scale
    assert tf32.max() > 100 * 2.0 ** -19
    # what the split drops is below what an f32 product's own sums round
    # away: the accumulation, not the split, sets the kernel's accuracy
    f32 = ((a @ m.T).double() - exact).abs() / scale
    assert err.max() < f32.max()


def _rz32(x):
    """f64 -> f32 rounded toward zero, as a tensor core's accumulator
    keeps a sum."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _tensor_cores(a, m, warpgroups):
    """The kernel's sums on the tensor cores: each wgmma adds one k-step's
    8 products (exact) of one term to an f32 accumulator and truncates;
    ``warpgroups`` lists, for each warpgroup, its groups of k-steps, each
    group's products (small terms first) in a fresh accumulator, added to
    the warpgroup's sum rounded to nearest; then the warpgroups' sums are
    added."""
    (ah, al), (mh, ml) = _split(a), _split(m)
    out = None
    for groups in warpgroups:
        total = None
        for steps in groups:
            acc = torch.zeros(a.shape[0], m.shape[0])
            for ks in steps:
                sl = slice(8 * ks, 8 * ks + 8)
                for x, y in ((al, mh), (ah, ml), (ah, mh)):
                    acc = _rz32(acc.double()
                                + x[:, sl].double() @ y[:, sl].double().T)
            total = acc if total is None else total + acc
        out = total if out is None else out + total
    return out


def test_fresh_accumulators_keep_the_f32_product_s_accuracy():
    """In one accumulator (96 truncated steps of the same sign) the
    error grows to several times an f32 product's; with a fresh one a
    stage, as the kernel's two tile shapes take them (wide: 8 k-steps; a
    pack: 4), it stays near it."""
    a, m = _flagship_operands(Q=16, N=3000, seed=9)
    exact = a.double() @ m.double().T
    f32 = torch.zeros(a.shape[0], m.shape[0])     # an f32 product, k by k
    for k in range(a.shape[1]):
        f32 = f32 + a[:, k, None] * m[None, :, k]
    sums = dict(
        f32=f32,
        one=_tensor_cores(a, m, [[range(32)]]),
        wide=_tensor_cores(a, m, [[range(8 * s, 8 * s + 8)
                                   for s in range(4)]]),
        pack=_tensor_cores(a, m, [[range(4 * c, 4 * c + 4)
                                   for c in range(8)]]))
    err = {name: (x.double() - exact).abs().max().item()
           for name, x in sums.items()}
    # (here f32 2.86e-7, one 1.33e-6, wide 3.41e-7, pack 2.37e-7)
    assert max(err["wide"], err["pack"]) < 1.5 * err["f32"]
    assert err["one"] > 4 * err["f32"]


def test_rna_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -11])
    assert _rna(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                1.0, 1.0 + 2.0 ** -9]


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("Q, shape", [(1, "pack16"), (8, "pack16"),
                                      (64, "pack64"), (256, "wide")])
@pytest.mark.parametrize("N", [26_250, 52_500, N_CELL])
def test_plan_at_the_main_shapes(Q, shape, N):
    plan = plan_score_gemm(Q, N, 256, H100_SMS)
    assert plan.shape == shape
    assert plan.q_tiles == (2 if Q == 256 else 1)
    assert plan.rows == (64 if Q > PACK_Q else 128)
    assert plan.n_tiles == -(-N // plan.rows)
    # one block an SM, each keeping its query tile for its life
    assert plan.grid == H100_SMS and plan.grid % plan.q_tiles == 0


@pytest.mark.parametrize("Q, N, shape, q_tiles, grid", [
    (65, 1000, "wide", 1, 16),     # fewer units than SMs: one a unit
    (256, 1000, "wide", 2, 32),
    (64, 1000, "pack64", 1, 8),
    (16, 1000, "pack16", 1, 8),
    (17, N_CELL, "pack64", 1, 132),
    (300, N_CELL, "wide", 3, 132),    # 3 x 44
    (1000, N_CELL, "wide", 8, 128),   # 8 x 16
    (40_000, N_CELL, "wide", 313, 132),   # more query tiles than SMs
])
def test_plan_grid(Q, N, shape, q_tiles, grid):
    plan = plan_score_gemm(Q, N, 128, H100_SMS)
    assert (plan.shape, plan.q_tiles, plan.grid) == (shape, q_tiles, grid)
    assert plan.grid <= plan.q_tiles * plan.n_tiles


def test_plan_refuses_an_empty_call():
    with pytest.raises(ValueError):
        plan_score_gemm(0, 10, 8, H100_SMS)


# -- the wrapper ---------------------------------------------------------------

@pytest.mark.parametrize("a, m, why", [
    (_rows(8, 256), _rows(100, 256), "not a CUDA device"),
    (_rows(8, 256).double(), _rows(100, 256).double(), "f32 operands"),
    (_rows(8, 12), _rows(100, 12), "multiple of 8"),
    (_rows(8, 256), _rows(100, 128), r"a \[Q, K\] and m \[N, K\]"),
    (_rows(8, 256), _misaligned(100, 256), "aligned"),
    (_rows(256, 8).T, _rows(100, 256), "contiguous rows"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(a, m, why):
    with pytest.raises(ValueError, match=why):
        score_gemm(a, m)


def test_scores_take_the_kernel_once_then_msq(monkeypatch):
    """Through the CPU stand-in (the plain version in the kernel's place):
    one launch and one ``score.kernel`` a product, the scores those of the
    plain product less the fused norms."""
    route_scores_to_the_plain_kernel(monkeypatch)
    before = dict(score_kernel.LAUNCHES)
    trace.reset()
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 8, 128, generator=g)
    m_cat = torch.randn(500, 256, generator=g)
    msq = (m_cat * m_cat).sum(-1)
    got = sharding.fused_corpus_scores(q, m_cat, msq, [0.5, 0.5])
    want = mm_f32(sharding.query_cat_scaled(q, [0.5, 0.5]), m_cat.T,
                  F32) - msq[None, :]
    assert torch.equal(got, want)
    assert score_kernel.LAUNCHES["score_gemm"] == before["score_gemm"] + 1
    assert trace.counters()["score.kernel"] == 1
    assert "score.library" not in trace.counters()


# -- the source ----------------------------------------------------------------

def _source():
    with open(SOURCE) as f:
        return f.read()


def test_kernel_names_are_found_by_the_benchmark_gemm_pattern():
    """The benchmark's name split takes the longest GEMM-named kernel after
    the recurrence as the score: each of the kernel's shapes is one launch
    whose name the GEMM pattern finds and the recurrence pattern does
    not."""
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", _source())
    assert names == ["score_gemm_tf32x3", "score_gemm_tf32x3_pack"]
    for name in names:
        assert GEMM.search(name) and not RECURRENCE.search(name)


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _source()).group(1))


def _struct(name):
    """The literal ``static constexpr int`` values of a struct."""
    body = re.search(rf"struct {name} {{(.*?)\n}};", _source(), re.S)
    return {k: int(v) for k, v in re.findall(
        r"static constexpr int (\w+) = (\d+);", body.group(1))}


def test_kernel_limits_fit_the_module_and_the_card():
    src = _source()
    assert _constant("K_MAX") == K_MAX
    wide, pack = _struct("Wide"), _struct("Pack")
    assert (0, wide["QT"], wide["SR"]) == SHAPES["wide"]
    assert wide["KQ"] * 8 == K_MAX
    assert pack["SR"] == SHAPES["pack16"][2] == SHAPES["pack64"][2]
    assert "NST = NQ == 16 ? 12 : 6;" in src
    # each ring, the packs' query tiles, the barriers and the alignment
    # slack in 227 KB; a producer copies at most NST - 2 stages ahead
    rings = [(wide["NST"], 2 * wide["CPS"] * wide["SR"] * 128, 0)]
    rings += [(nst, pack["SR"] * 128, 2 * 8 * nq * 128)
              for nq, nst in ((16, 12), (64, 6))]
    for nst, stage, queries in rings:
        assert 1024 + nst * stage + queries + 2 * nst * 8 <= 232_448
        assert _constant("LAG") <= nst - 2
    # the registers moved between the warpgroups stay within the 65,536
    # of an SM: 384 threads launched at 168 each
    dec = int(re.search(r"setmaxnreg\.dec\.sync\.aligned\.u32 (\d+)",
                        src).group(1))
    inc = int(re.search(r"setmaxnreg\.inc\.sync\.aligned\.u32 (\d+)",
                        src).group(1))
    threads = 32 * _constant("CONSUMER_WARPS") + _constant("PRODUCERS")
    assert threads == 384 and _constant("PRODUCERS") == 128
    assert dec % 8 == inc % 8 == 0 and dec + 2 * inc <= 3 * 168
