"""The port's mesh and sharded primitives (``vfr_tpu_torch.parallel.mesh``
and ``parallel.sharding``) against the JAX package's, a port mesh of
``[cpu] * n`` against ``devices8[:n]`` for n in {2, 4, 8}.

The inputs are integer-valued (products and sums exact in f32) and hold
many duplicated rows, placed across shard boundaries, with a row count
that is no multiple of n (``pad_index``): the global top-k's rows and
order, the tie order included, and the GT ranks must EQUAL the JAX
package's; a merge by a bare ``torch.topk`` fails them.  Distances are
exact too (atol 0).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.parallel import sharding as jsh
from vfr_tpu.parallel.mesh import make_mesh as j_make_mesh
from vfr_tpu_torch.ops import topk as ttopk
from vfr_tpu_torch.parallel import sharding as tsh
from vfr_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
NS = [2, 4, 8]


def _meshes(devices8, n):
    return (j_make_mesh(("corpus",), devices=devices8[:n]),
            make_mesh(("corpus",), devices=[CPU] * n))


def _jit(fn, mesh, *args, **kw):
    """``fn(mesh, *args, **kw)`` of the JAX package, jitted (its eager
    shard_map dispatches op by op)."""
    return jax.jit(partial(fn, mesh, **kw))(*args)


def _tied_problem(seed, N=150, Q=6, S=2, d=8, pool=9):
    """Index rows drawn from ``pool`` distinct integer rows (so most rows
    tie with many others), queries equal to some of them."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-2, 3, size=(S, pool, d)).astype(np.float32)
    m = base[:, rng.integers(0, pool, size=N)]                # [S, N, d]
    q = base[:, rng.integers(0, pool, size=Q)]                # [S, Q, d]
    m_sq = (m * m).sum(-1)
    w = np.array([0.5, 0.5][:S], np.float32)
    return q, m, m_sq, w


def test_make_mesh():
    mesh = make_mesh(("corpus",), devices=[CPU] * 4)
    assert mesh.shape == {"corpus": 4} and mesh.axis_names == ("corpus",)
    assert mesh.axis_devices("corpus") == [CPU] * 4
    two = make_mesh(("data", "corpus"), shape=(2, 3), devices=[CPU] * 6)
    assert two.shape == {"data": 2, "corpus": 3}
    assert len(two.axis_devices("corpus")) == 3
    assert len(two.axis_devices("data")) == 2
    with pytest.raises(ValueError, match=r"needs 9 devices, have 8"):
        make_mesh(("corpus",), shape=(9,), devices=[CPU] * 8)
    assert make_mesh(("corpus",), devices=[CPU] * 2) is not \
        make_mesh(("corpus",), devices=[CPU] * 2)


def test_make_mesh_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_make_mesh_error_matches_jax(devices8):
    with pytest.raises(ValueError) as j:
        j_make_mesh(("corpus",), shape=(9,), devices=devices8)
    with pytest.raises(ValueError) as t:
        make_mesh(("corpus",), shape=(9,), devices=[CPU] * 8)
    assert str(t.value) == str(j.value)


def test_pad_index_matches_jax():
    q, m, m_sq, w = _tied_problem(0, N=150)
    jm, jsq = jsh.pad_index(jnp.asarray(m), jnp.asarray(m_sq), 8)
    tm, tsq = tsh.pad_index(torch.from_numpy(m), torch.from_numpy(m_sq), 8)
    assert tm.shape == (2, 152, 8)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tsq.numpy(), np.asarray(jsq))
    same = tsh.pad_index(torch.from_numpy(m), torch.from_numpy(m_sq), 5)
    assert same[0].shape[1] == 150


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", [1, 7, 40])
def test_sharded_topk_equals_jax(devices8, n, k):
    """Rows and tie order equal, distances exact; k=40 spans shards and
    exceeds an 8-shard mesh's 19 rows a shard."""
    q, m, m_sq, w = _tied_problem(n * 10 + k)
    jm, jsq = jsh.pad_index(jnp.asarray(m), jnp.asarray(m_sq), n)
    tm, tsq = tsh.pad_index(torch.from_numpy(m), torch.from_numpy(m_sq), n)
    jmesh, tmesh = _meshes(devices8, n)
    d_j, r_j = _jit(jsh.sharded_corpus_topk, jmesh, jnp.asarray(q), jm, jsq,
                    jnp.asarray(w), k=k)
    d_t, r_t = tsh.sharded_corpus_topk(tmesh, torch.from_numpy(q), tm, tsq,
                                       w, k)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert (r_t.numpy() < 150).all()       # pad rows never come back
    # the ties are real: the k-th value recurs at most places
    if k > 1:
        assert (d_t.numpy()[:, 1:] == d_t.numpy()[:, :-1]).any()


@pytest.mark.parametrize("n", NS)
def test_sharded_topk_cat_on_placed_shards(devices8, n):
    """The one-matmul layout split into shards once (as
    ``prep_score_operands`` places it) equals the JAX package's
    ``sharded_corpus_topk_cat``; so does ``corpus_topk_shards`` on those
    shards, and on the whole layout as one shard the single-device
    retrieval (held to the same rows by the merged result)."""
    q, m, m_sq, w = _tied_problem(3 + n, N=160)
    jmesh, tmesh = _meshes(devices8, n)
    jc, jq = jsh.fuse_index_cat(jnp.asarray(m), jnp.asarray(m_sq),
                                jnp.asarray(w))
    d_j, r_j = _jit(jsh.sharded_corpus_topk_cat, jmesh, jnp.asarray(q), jc,
                    jq, jnp.asarray(w), k=12)
    tc, tq = tsh.fuse_index_cat(torch.from_numpy(m), torch.from_numpy(m_sq),
                                w)
    qt = torch.from_numpy(q)
    mc, ms = tsh.shard_rows(tc, [CPU] * n), tsh.shard_rows(tq, [CPU] * n)
    for d_t, r_t in (tsh.sharded_corpus_topk_cat(tmesh, qt, mc, ms, w, 12),
                     tsh.corpus_topk_shards(qt, mc, ms, w, 12),
                     tsh.corpus_topk_shards(qt, [tc], [tq], w, 12)):
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def test_unpadded_rows_and_bad_method_raise(devices8):
    q, m, m_sq, w = _tied_problem(1, N=150)
    jmesh, tmesh = _meshes(devices8, 8)
    jc, jq = jsh.fuse_index_cat(jnp.asarray(m), jnp.asarray(m_sq),
                                jnp.asarray(w))
    with pytest.raises(ValueError, match="padded to a multiple"):
        jsh.sharded_corpus_topk_cat(jmesh, jnp.asarray(q), jc, jq,
                                    jnp.asarray(w), 5)
    tc, tq = tsh.fuse_index_cat(torch.from_numpy(m), torch.from_numpy(m_sq),
                                w)
    with pytest.raises(ValueError, match="padded to a multiple"):
        tsh.sharded_corpus_topk(tmesh, torch.from_numpy(q),
                                torch.from_numpy(m), torch.from_numpy(m_sq),
                                w, 5)
    with pytest.raises(ValueError, match="padded to a multiple"):
        tsh.shard_rows(tc, [CPU] * 8)
    tc, tq = tc[:144], tq[:144]
    with pytest.raises(ValueError, match="unknown topk method 'fused'"):
        tsh.sharded_corpus_topk_cat(tmesh, torch.from_numpy(q),
                                    tsh.shard_rows(tc, [CPU] * 8),
                                    tsh.shard_rows(tq, [CPU] * 8), w, 5,
                                    method="fused")
    with pytest.raises(ValueError, match="shards"):       # a whole tensor
        tsh.sharded_corpus_topk_cat(tmesh, torch.from_numpy(q), tc, tq, w, 5)
    with pytest.raises(ValueError, match="shards"):
        tsh.sharded_corpus_topk_cat(tmesh, torch.from_numpy(q),
                                    tsh.shard_rows(tc, [CPU] * 4),
                                    tsh.shard_rows(tq, [CPU] * 4), w, 5)


def test_shard_with_fewer_rows_than_k(devices8):
    """An 8-shard mesh over 24 rows: 3 rows a shard, k = 10 > 3; the merge
    takes k_out = min(k, 8 * 3) candidates."""
    q, m, m_sq, w = _tied_problem(5, N=21, pool=4)
    jm, jsq = jsh.pad_index(jnp.asarray(m), jnp.asarray(m_sq), 8)
    tm, tsq = tsh.pad_index(torch.from_numpy(m), torch.from_numpy(m_sq), 8)
    jmesh, tmesh = _meshes(devices8, 8)
    d_j, r_j = _jit(jsh.sharded_corpus_topk, jmesh, jnp.asarray(q), jm, jsq,
                    jnp.asarray(w), k=10)
    d_t, r_t = tsh.sharded_corpus_topk(tmesh, torch.from_numpy(q), tm, tsq,
                                       w, 10)
    assert r_t.shape == (6, 10)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("n", NS)
def test_sharded_gt_ranks_equal_jax(devices8, n):
    """Duplicated rows across shard boundaries: every GT row's rank equals
    the JAX package's sharded count and the stable-argsort position."""
    q, m, m_sq, w = _tied_problem(40 + n, N=150, Q=5)
    rng = np.random.default_rng(n)
    gt = rng.integers(0, 150, size=(5, 4)).astype(np.int32)
    jm, jsq = jsh.pad_index(jnp.asarray(m), jnp.asarray(m_sq), n)
    tm, tsq = tsh.pad_index(torch.from_numpy(m), torch.from_numpy(m_sq), n)
    jmesh, tmesh = _meshes(devices8, n)
    r_j = np.asarray(_jit(jsh.sharded_gt_ranks, jmesh, jnp.asarray(q), jm,
                          jsq, jnp.asarray(w), jnp.asarray(gt)))
    r_t = tsh.sharded_gt_ranks(
        tmesh, torch.from_numpy(q), tsh.shard_rows(tm, [CPU] * n, dim=1),
        tsh.shard_rows(tsq, [CPU] * n, dim=1), w,
        torch.from_numpy(gt)).numpy()
    np.testing.assert_array_equal(r_t, r_j)
    D = tsh.fused_corpus_distances(torch.from_numpy(q), tm, tsq, w).numpy()
    order = np.argsort(D, axis=1, kind="stable")
    position = np.argsort(order, axis=1)
    np.testing.assert_array_equal(r_t, np.take_along_axis(position, gt, 1))


@pytest.mark.parametrize("n", NS)
def test_sharded_gt_ranks_on_placed_shards(n):
    """The same counts from shards placed once (as ``make_gt_ranker(mesh=)``
    holds them) as from the whole index on one device (a one-shard mesh),
    and a whole tensor is refused."""
    q, m, m_sq, w = _tied_problem(7, N=160, Q=3)
    gt = torch.tensor([[0, 159, 80], [5, 6, 7], [100, 20, 40]])
    tmesh = make_mesh(("corpus",), devices=[CPU] * n)
    tm, tsq = torch.from_numpy(m), torch.from_numpy(m_sq)
    whole = tsh.sharded_gt_ranks(make_mesh(("corpus",), devices=[CPU]),
                                 torch.from_numpy(q), [tm], [tsq], w, gt)
    placed = tsh.sharded_gt_ranks(
        tmesh, torch.from_numpy(q), tsh.shard_rows(tm, [CPU] * n, dim=1),
        tsh.shard_rows(tsq, [CPU] * n, dim=1), w, gt)
    assert torch.equal(whole, placed)
    with pytest.raises(ValueError, match="shards"):
        tsh.sharded_gt_ranks(tmesh, torch.from_numpy(q), tm, tsq, w, gt)


def test_topk_many_equals_one_at_a_time(monkeypatch):
    """Rows longer than KEY_MAX (the tie pass), with a tie at the k-th
    place, ties inside the k, and none: each equals its own
    ``topk_lowest_index``, and none of them reads a value on the host
    (no ``tolist``)."""
    rng = np.random.default_rng(0)
    N = ttopk.KEY_MAX + 500
    rows = []
    for kind in ("left_out", "inside", "none"):
        x = rng.standard_normal((2, N)).astype(np.float32)
        if kind == "left_out":
            x[:, [5, 900, N - 3]] = 9.0           # three tie for 2 places
        elif kind == "inside":
            x[:, [40, 7]] = 9.0
        rows.append(torch.from_numpy(x))
    rows.append(torch.from_numpy(rng.standard_normal((2, 300)).astype(
        np.float32)))                             # a short row: key path
    want = [ttopk.topk_lowest_index(x, 2) for x in rows]
    calls = []
    tolist = torch.Tensor.tolist

    def counting(self):
        calls.append(1)
        return tolist(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    got = ttopk.topk_lowest_index_many(rows, 2)
    assert len(calls) == 0
    for (gv, gi), (wv, wi) in zip(got, want):
        assert torch.equal(gv, wv) and torch.equal(gi, wi)
    assert got[0][1].tolist() == [[5, 900], [5, 900]]


def test_topk_many_one_row_costs_one_select(monkeypatch):
    """One long row through ``topk_lowest_index_many`` (the one-shard
    retrieval) is ``topk_lowest_index`` itself: the same result, with no
    ``torch.stack`` of flags and no ``tolist``."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, ttopk.KEY_MAX + 100)).astype(np.float32)
    x[:, [11, 700, 5000]] = 7.0
    x = torch.from_numpy(x)
    want = ttopk.topk_lowest_index(x, 2)
    calls = {"stack": 0, "tolist": 0}
    stack, tolist = torch.stack, torch.Tensor.tolist

    def counting_stack(*a, **kw):
        calls["stack"] += 1
        return stack(*a, **kw)

    def counting_tolist(self):
        calls["tolist"] += 1
        return tolist(self)

    monkeypatch.setattr(torch, "stack", counting_stack)
    monkeypatch.setattr(torch.Tensor, "tolist", counting_tolist)
    (gv, gi), = ttopk.topk_lowest_index_many([x], 2)
    assert calls == {"stack": 0, "tolist": 0}
    assert torch.equal(gv, want[0]) and torch.equal(gi, want[1])
    assert gi.tolist() == [[11, 700]] * 3


def test_one_shard_equals_shards_and_jax(devices8):
    """``corpus_topk_shards`` over the whole layout as one shard (the
    single-device retrieval of ``make_operand_retriever``) and over 4
    shards give the JAX package's top-k on a one-device mesh, rows and
    distances equal, and the stable-argsort order of the distances."""
    q, m, m_sq, w = _tied_problem(11, N=160)
    jmesh, _ = _meshes(devices8, 1)
    jc, jq = jsh.fuse_index_cat(jnp.asarray(m), jnp.asarray(m_sq),
                                jnp.asarray(w))
    d_j, r_j = _jit(jsh.sharded_corpus_topk_cat, jmesh, jnp.asarray(q), jc,
                    jq, jnp.asarray(w), k=9)
    tc, tq = tsh.fuse_index_cat(torch.from_numpy(m), torch.from_numpy(m_sq),
                                w)
    qt = torch.from_numpy(q)
    one = tsh.corpus_topk_shards(qt, [tc], [tq], w, 9)
    four = tsh.corpus_topk_shards(qt, tsh.shard_rows(tc, [CPU] * 4),
                                  tsh.shard_rows(tq, [CPU] * 4), w, 9)
    for d_t, r_t in (one, four):
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    D = tsh.fused_corpus_distances(qt, torch.from_numpy(m),
                                   torch.from_numpy(m_sq), w).numpy()
    np.testing.assert_array_equal(
        one[1].numpy(), np.argsort(D, axis=1, kind="stable")[:, :9])
