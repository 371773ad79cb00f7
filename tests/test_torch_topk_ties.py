"""Top-k order under exact ties in the PyTorch port, against
``jax.lax.top_k`` and the JAX package's retrievers: larger value first,
equal values by lowest index, and at the k-th place the lowest-index tied
rows enter.  One test per site that selects:

* ``ops/topk.py::top_k_select`` (and ``topk_lowest_index``) on vectors and
  matrices with many ties and -inf entries, both through the 64-bit
  (value, -index) key and through ``torch.topk`` with the tie search
  (``KEY_MAX`` set to 0; ``TIE_CHUNK`` from 3 to 2048);
* the exact retriever (``make_retriever``, the one-GEMM score + top-k);
* the fused retriever's final top-k over the distance-select kernel's
  candidates (its plain version on the CPU);
* the coarse retriever's stage 1 (blocks, blockmax and centroid) and
  stage 2 (rows).

The retrievers run over an index of duplicated integer rows, and the
query embedding is replaced by integer vectors in both packages, so every
score is exact in f32 and the ties are real.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.eval import coarse as jcoarse
from vfr_tpu.eval import corpus as jcorpus
from vfr_tpu_torch.eval import coarse as tcoarse
from vfr_tpu_torch.eval import corpus as tcorpus
from vfr_tpu_torch.ops.topk import top_k_select, topk_lowest_index

from test_torch_train_loss import _models


def test_three_tied_rows_come_back_lowest_index_first():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    x[[10, 500, 900]] = 5.0
    _, idx = top_k_select(torch.from_numpy(x), 3)
    _, jidx = jax.lax.top_k(jnp.asarray(x), 3)
    assert idx.tolist() == [10, 500, 900] == np.asarray(jidx).tolist()


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("key_max,chunk", [(32768, 2048), (0, 3), (0, 64),
                                            (0, 2048)])
def test_top_k_select_matches_lax_top_k(monkeypatch, seed, key_max, chunk):
    """Rows through the 64-bit key, and rows through torch.topk with the
    tie search over one or many chunks."""
    import vfr_tpu_torch.ops.topk as topk_mod

    monkeypatch.setattr(topk_mod, "KEY_MAX", key_max)
    monkeypatch.setattr(topk_mod, "TIE_CHUNK", chunk)
    rng = np.random.default_rng(seed)
    for _ in range(40):
        Q, N = int(rng.integers(1, 6)), int(rng.integers(1, 400))
        k = int(rng.integers(1, N + 4))
        x = rng.integers(0, int(rng.integers(1, 12)), (Q, N)).astype(
            np.float32)
        x[:, rng.random(N) < 0.1] = -np.inf
        v, i = top_k_select(torch.from_numpy(x), k, "approx")
        jv, ji = jax.lax.top_k(jnp.asarray(x), min(k, N))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    with pytest.raises(ValueError):
        top_k_select(torch.zeros(3), 1, "fused")
    assert topk_lowest_index(torch.zeros(2, 3), 0)[1].shape == (2, 0)


N_VID, P, D_ = 16, 4, 4          # 64 index rows of dimension 4, one stream


def _tied_rows(seed=0):
    """[N, D] small-integer rows; videos 0-3 all copy video 4, and rows
    repeat inside videos, so most scores tie somewhere."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-1, 3, (N_VID * P, D_)).astype(np.float32)
    for v in range(4):
        rows[v * P:(v + 1) * P] = rows[4 * P:5 * P]
    rows[1::P] = rows[0::P]
    return rows


def _queries(seed=1, Q=6):
    return np.random.default_rng(seed).integers(-2, 3, (1, Q, D_)).astype(
        np.float32)


def _indexes(rows):
    m_sq = (rows * rows).sum(-1)[None]
    common = dict(video_row=np.repeat(np.arange(N_VID, dtype=np.int32), P),
                  prop_idx=np.tile(np.arange(P, dtype=np.int32), N_VID),
                  spans_sec=np.zeros((N_VID * P, 2), np.float32),
                  weights=np.ones(1, np.float32))
    return (jcorpus.MomentIndex(m=jnp.asarray(rows[None]),
                                m_sq=jnp.asarray(m_sq), **common),
            tcorpus.MomentIndex(m=torch.from_numpy(rows[None]),
                                m_sq=torch.from_numpy(m_sq), **common))


@pytest.fixture
def integer_queries(monkeypatch):
    """Both packages' query embedding replaced by fixed integer vectors."""
    q = _queries()
    monkeypatch.setattr(jcorpus, "_embed_query_streams",
                        lambda *a, **k: jnp.asarray(q))
    monkeypatch.setattr(tcorpus, "_embed_query_streams",
                        lambda *a, **k: torch.from_numpy(q))
    monkeypatch.setattr(jcoarse, "_embed_query_streams",
                        lambda *a, **k: jnp.asarray(q))
    monkeypatch.setattr(tcoarse, "_embed_query_streams",
                        lambda *a, **k: torch.from_numpy(q))
    return q


def _both(jfn, tfn):
    toks = np.zeros((6, 3), np.int32)
    lens = np.ones(6, np.int32)
    jd, jr = jfn(None, jnp.asarray(toks), jnp.asarray(lens))
    td, tr = tfn(None, torch.from_numpy(toks), torch.from_numpy(lens))
    return (np.asarray(jd), np.asarray(jr)), (td.numpy(), tr.numpy())


@pytest.mark.parametrize("key_max", [32768, 0])
@pytest.mark.parametrize("method,k", [("exact", 7), ("exact", 13),
                                      ("fused", 5), ("fused", 9)])
def test_retriever_tie_order_matches_jax(integer_queries, monkeypatch,
                                         key_max, method, k):
    import vfr_tpu_torch.ops.topk as topk_mod

    monkeypatch.setattr(topk_mod, "KEY_MAX", key_max)
    jm, tm = _models(("rgb",), distance="sqeuclidean")
    jidx, tidx = _indexes(_tied_rows())
    (jd, jr), (td, tr) = _both(
        jcorpus.make_retriever(jm, jidx, k, topk_method=method),
        tcorpus.make_retriever(tm, tidx, k, topk_method=method))
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tr, jr)
    # real ties: some query's k-th distance is shared with a row left out
    # or with a neighbour
    assert (np.diff(jd, axis=1) == 0).any()


def _tied_blocks(seed=2, B=32, G=8):
    """[G * B, D] small-integer rows whose blocks 0-3 copy block 4, with
    repeated rows inside every block."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-1, 3, (G * B, D_)).astype(np.float32)
    for g in range(4):
        rows[g * B:(g + 1) * B] = rows[4 * B:5 * B]
    rows[1::4] = rows[0::4]
    return rows


def _coarse_pair(rows, B=32):
    """The same hand-built coarse index in both packages: identity basis,
    the rows themselves as the low-rank rows, each block's first row as
    its centroid."""
    N, D = rows.shape
    G = N // B
    blocks = rows.reshape(G, B, D)
    msq = (rows * rows).sum(-1)
    f = dict(proj=np.eye(D, dtype=np.float32), msq_low=msq,
             m_blk=blocks.reshape(G, B * D), msq_blk=msq.reshape(G, B),
             c_low=blocks[:, 0].copy(),
             csq=(blocks[:, 0] ** 2).sum(-1))
    j = jcoarse.CoarseIndex(
        m_low=jnp.asarray(rows, jnp.bfloat16),
        perm=jnp.arange(N, dtype=jnp.int32), n_rows=N, block_rows=B,
        **{k: jnp.asarray(v) for k, v in f.items()})
    t = tcoarse.CoarseIndex(
        m_low=torch.from_numpy(rows).to(torch.bfloat16),
        perm=torch.arange(N), n_rows=N, block_rows=B,
        **{k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in f.items()})
    return j, t


@pytest.mark.parametrize("key_max", [32768, 0])
@pytest.mark.parametrize("mode", ["blockmax", "centroid"])
@pytest.mark.parametrize("cands,k", [(64, 3), (96, 6), (160, 9)])
def test_coarse_stage_tie_order_matches_jax(integer_queries, monkeypatch,
                                            key_max, mode, cands, k):
    import vfr_tpu_torch.ops.topk as topk_mod

    monkeypatch.setattr(topk_mod, "KEY_MAX", key_max)
    jm, tm = _models(("rgb",), distance="sqeuclidean")
    jc, tc = _coarse_pair(_tied_blocks())
    (jd, jr), (td, tr) = _both(
        jcoarse.make_coarse_retriever(jm, jc, k, num_candidates=cands,
                                      mode=mode),
        tcoarse.make_coarse_retriever(tm, tc, k, num_candidates=cands,
                                      mode=mode))
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tr, jr)
