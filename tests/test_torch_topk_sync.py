"""The long-row select of ``ops/topk.py`` reads no value on the host.

While the selects run, ``torch.Tensor``'s ways to a host value (``tolist``,
``item``, ``numpy``, ``__bool__``, ``__int__``, ``__float__``,
``__index__``) raise; on a card each of them would stall the stream until
the select is done.  Checked on rows of 40,000 (past ``KEY_MAX``) with no
tie, a tie at the k-th place, ties inside the k, NaNs of both signs and
signed zeros, by the 64-bit key, by the tie pass (``KEY_BATCH`` set
to 0) and by the kernel's route with its plain version in the kernel's
place (``torch_kernel_route``), through ``topk_lowest_index`` (one row
and a [2, N] batch),
``topk_lowest_index_many`` (two and three rows), ``top_k_select`` and
``hierarchical_top_k``; each result equals ``jax.lax.top_k``'s indices,
and its values bit for bit.

Then the sharded retriever: ``make_score_topk(mesh=)`` over a ``[cpu] *
2`` "corpus" mesh (``parallel/sharding.py::corpus_topk_shards``) with more
than ``KEY_MAX`` rows a shard, integer rows and queries (exact scores,
ties at the k-th place), under the same patch: its rows and distances
equal the unsharded retriever's and numpy's (distance ascending, lowest
row first).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu_torch.eval import corpus as tcorpus
from vfr_tpu_torch.ops import topk as ttopk
from vfr_tpu_torch.parallel.mesh import make_mesh

from test_torch_train_loss import _models
from torch_kernel_route import route_to_the_plain_kernel

N = 40_000
HOST_READS = ("tolist", "item", "numpy", "__bool__", "__int__", "__float__",
              "__index__")


@contextlib.contextmanager
def no_host_reads():
    """Every way of ``torch.Tensor`` to a host value raises inside."""
    def refuse(name):
        def read(self, *a, **kw):
            raise AssertionError(f"Tensor.{name} read a value on the host")
        return read

    with pytest.MonkeyPatch.context() as mp:
        for name in HOST_READS:
            mp.setattr(torch.Tensor, name, refuse(name))
        yield


def _case(name: str) -> np.ndarray:
    """One f32 row of ``N`` (k = 7 places the ties as named)."""
    x = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    if name == "tie_at_kth":          # 5 nines, then 2 of 6 eights enter
        x[[31000, 4, 17, 22000, 39999]] = 9.0
        x[[38000, 900, 12, 25000, 7, 33333]] = 8.0
    elif name == "ties_inside":       # the 7 hold two tied pairs, no more
        x[[300, 7, 39000]] = 9.0
        x[[50, 20]] = 8.5
    elif name == "nans":              # +NaN above all, -NaN below all
        x[[100, 2000, 39000]] = np.nan
        x[[5, 30000]] = -np.nan
    elif name == "neg_nans_in_k":     # the k reaches -inf, then the -NaNs
        x[:] = -np.nan
        x[[10, 20]] = 1.0
        x[30] = -np.inf
    elif name == "signed_zeros":      # +0.0 above -0.0, lowest index first
        x[:] = 0.0
        x[0::2] = -0.0
    return x


CASES = ["no_tie", "tie_at_kth", "ties_inside", "nans", "neg_nans_in_k",
         "signed_zeros"]


def _assert_lax(v, i, row, k):
    jv, ji = jax.lax.top_k(jnp.asarray(row), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))


@pytest.fixture(params=["key", "tie_pass", "kernel_plain"])
def long_path(request, monkeypatch):
    """The three selects of a long row: the 64-bit key (a small batch, as
    here), the tie pass (``KEY_BATCH`` 0: every batch of rows longer than
    ``KEY_MAX``, as a corpus scored for many queries) and the kernel's
    route, the CPU standing for the card and the kernel's plain version,
    slice by slice, in the kernel's place."""
    if request.param == "tie_pass":
        monkeypatch.setattr(ttopk, "KEY_BATCH", 0)
    if request.param == "kernel_plain":
        route_to_the_plain_kernel(monkeypatch)
    return request.param


@pytest.mark.parametrize("name", CASES)
def test_long_row_select_reads_nothing_on_the_host(name, long_path):
    x = _case(name)
    rows = [x, x[::-1].copy(), np.roll(x, 1234)]
    ts = [torch.from_numpy(r) for r in rows]
    with no_host_reads():
        single = ttopk.topk_lowest_index(ts[0], 7)
        batch = ttopk.topk_lowest_index(torch.stack(ts[:2]), 7)
        many2 = ttopk.topk_lowest_index_many(ts[:2], 7)
        many3 = ttopk.topk_lowest_index_many(ts, 7)
        select = ttopk.top_k_select(ts[0], 7, "approx")
        # chunk 64 at k = 60: 37,500 candidates, past KEY_MAX
        hier = ttopk.hierarchical_top_k(ts[0], 60, chunk=64)
    _assert_lax(*single, rows[0], 7)
    _assert_lax(*select, rows[0], 7)
    _assert_lax(*hier, rows[0], 60)
    for (v, i), row in zip([*zip(*batch), *many2, *many3],
                           [*rows[:2], *rows[:2], *rows]):
        _assert_lax(v, i, row, 7)


def test_sharded_exact_retriever_reads_nothing_on_the_host(monkeypatch,
                                                            long_path):
    """Two shards of KEY_MAX + 600 integer rows each: the sharded
    ``make_score_topk`` under the patch gives the unsharded retriever's
    rows and distances, which are numpy's exact top-k."""
    k, D, P = 10, 4, 4
    n = 2 * (ttopk.KEY_MAX + 600)
    rng = np.random.default_rng(7)
    rows = rng.integers(-1, 2, (n, D)).astype(np.float32)
    q = rng.integers(-2, 3, (1, 3, D)).astype(np.float32)
    monkeypatch.setattr(tcorpus, "_embed_query_streams",
                        lambda *a, **kw: torch.from_numpy(q))
    _, tm = _models(("rgb",), distance="sqeuclidean")
    m_sq = (rows * rows).sum(-1)[None]
    index = tcorpus.MomentIndex(
        m=torch.from_numpy(rows[None]), m_sq=torch.from_numpy(m_sq),
        video_row=np.repeat(np.arange(n // P, dtype=np.int32), P),
        prop_idx=np.tile(np.arange(P, dtype=np.int32), n // P),
        spans_sec=np.zeros((n, 2), np.float32),
        weights=np.ones(1, np.float32))
    mesh = make_mesh(("corpus",), devices=[torch.device("cpu")] * 2)
    sharded = tcorpus.make_score_topk(tm, index, k, "exact", mesh=mesh)
    whole = tcorpus.make_score_topk(tm, index, k, "exact")
    toks, lens = torch.zeros((3, 2), dtype=torch.int32), torch.ones(
        3, dtype=torch.int32)
    with no_host_reads():
        d_s, r_s = sharded(None, toks, lens)
        d_w, r_w = whole(None, toks, lens)
    dist = ((q[0][:, None, :] - rows[None]) ** 2).sum(-1)      # [3, n]
    order = np.stack([np.lexsort((np.arange(n), d)) for d in dist])
    kth = np.take_along_axis(dist, order[:, k - 1:k + 1], 1)
    assert (kth[:, 0] == kth[:, 1]).all()     # the k-th place is tied
    np.testing.assert_array_equal(r_s.numpy(), order[:, :k])
    np.testing.assert_array_equal(r_s.numpy(), r_w.numpy())
    np.testing.assert_array_equal(d_s.numpy(), d_w.numpy())
    np.testing.assert_array_equal(
        d_s.numpy(), np.take_along_axis(dist, order[:, :k], 1))
