"""The PyTorch port's distance + strided-bin selection and top-k against the
JAX package's.

The plain version (what ``distance_select`` runs on CPU tensors) is held
against ``pallas_distance_select(interpret=True)`` and the reference's jnp
twin ``_binned_min_reference``: values within rtol 1e-5 / atol 1e-5 (same
f32 arithmetic, another summation order), rows equal (the random inputs
have no near-ties).  Shapes cover S = 1 and 2, f32 and bf16 index rows, N
not a multiple of ``block_n`` and Q not a multiple of 8; ``block_n`` is
small to keep the interpreter fast.  The CUDA kernel itself runs only on
the card (chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.ops.pallas.select_kernel import (
    _binned_min_reference,
    pallas_distance_select,
)
from vfr_tpu_torch.ops.kernels import select_kernel
from vfr_tpu_torch.ops.kernels.select_kernel import (
    distance_select,
    distance_select_plain,
)
from vfr_tpu_torch.ops.topk import top_k_select

Q, N, D_EMB, BIN, BLOCK_N = 13, 700, 16, 16, 256


def _inputs(S, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, Q, D_EMB)).astype(np.float32)
    m = rng.standard_normal((S, N, D_EMB)).astype(np.float32)
    m_t = torch.from_numpy(m).to(getattr(torch, dtype))
    m_sq = (m_t.float() ** 2).sum(-1).numpy()
    w = [0.7] if S == 1 else [0.5, 0.5]
    return q, m, m_t, m_sq, w


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_reference(S, dtype):
    q, m, m_t, m_sq, w = _inputs(S, dtype)
    m_j = jnp.asarray(m, jnp.dtype(dtype))
    assert np.array_equal(np.asarray(m_j.astype(jnp.float32)),
                          m_t.float().numpy())
    got_v, got_r = distance_select(torch.from_numpy(q), m_t,
                                   torch.from_numpy(m_sq), w, BIN, BLOCK_N)
    assert got_v.shape == (Q, -(-N // BLOCK_N) * (BLOCK_N // BIN))
    for ref_v, ref_r in (
        pallas_distance_select(jnp.asarray(q), m_j, jnp.asarray(m_sq), w,
                               bin_size=BIN, block_n=BLOCK_N,
                               interpret=True),
        _binned_min_reference(jnp.asarray(q), m_j, jnp.asarray(m_sq), w,
                              bin_size=BIN, block_n=BLOCK_N),
    ):
        np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(ref_r))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,w,n,bin_size", [
    (2, [0.3, 0.7], 513, 16),      # one row past two tiles, odd weights
    (2, [0.7, 0.3], 1000, 32),     # the heavier stream first
    (1, [0.3], 255, 32),           # less than one tile, one stream
    (1, [1.0], 700, 64),
    (2, [0.5, 0.5], 512, 256),     # one bin a tile
])
def test_plain_matches_pallas_ragged_bins_and_weights(S, w, n, bin_size,
                                                      dtype):
    """Ragged N, bins of 16 to 256 rows, S = 1 and stream weights that are
    no powers of two: same tolerances as above."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((S, Q, D_EMB)).astype(np.float32)
    m_t = torch.from_numpy(rng.standard_normal((S, n, D_EMB)).astype(
        np.float32)).to(getattr(torch, dtype))
    m_sq = (m_t.float() ** 2).sum(-1).numpy()
    m_j = jnp.asarray(m_t.float().numpy(), jnp.dtype(dtype))
    got_v, got_r = distance_select(torch.from_numpy(q), m_t,
                                   torch.from_numpy(m_sq), w, bin_size,
                                   BLOCK_N)
    assert got_v.shape == (Q, -(-n // BLOCK_N) * (BLOCK_N // bin_size))
    ref_v, ref_r = pallas_distance_select(
        jnp.asarray(q), m_j, jnp.asarray(m_sq), w, bin_size=bin_size,
        block_n=BLOCK_N, interpret=True)
    ref_v, ref_r = np.asarray(ref_v), np.asarray(ref_r)
    live = ref_v < 1e29                      # bins of padding hold ~1e30
    np.testing.assert_allclose(got_v.numpy()[live], ref_v[live], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_v.numpy()[~live], ref_v[~live], rtol=1e-6)
    np.testing.assert_array_equal(got_r.numpy(), ref_r)


def test_ties_go_to_the_lowest_row():
    """Identical index rows tie exactly: every bin must report its first
    row, as jnp.argmin does."""
    q = torch.ones(1, 3, 4)
    m = torch.ones(1, 300, 4)
    m_sq = (m * m).sum(-1)
    vals, rows = distance_select(q, m, m_sq, [1.0], bin_size=4, block_n=64)
    bins = 64 // 4
    expect = (np.arange(rows.shape[1]) // bins) * 64 + np.arange(
        rows.shape[1]) % bins
    np.testing.assert_array_equal(rows[0].numpy(), expect)


def test_cpu_wrapper_is_plain_and_counts_nothing():
    q, m, m_t, m_sq, w = _inputs(2, "float32", seed=3)
    before = dict(select_kernel.LAUNCHES)
    got = distance_select(torch.from_numpy(q), m_t, torch.from_numpy(m_sq),
                          w, BIN, BLOCK_N)
    ref = distance_select_plain(torch.from_numpy(q), m_t,
                                torch.from_numpy(m_sq), w, BIN, BLOCK_N)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert select_kernel.LAUNCHES == before


def test_wrapper_validates():
    q, m, m_t, m_sq, w = _inputs(2, "float32")
    with pytest.raises(ValueError, match="multiple of bin_size"):
        distance_select(torch.from_numpy(q), m_t, torch.from_numpy(m_sq), w,
                        bin_size=24, block_n=BLOCK_N)
    with pytest.raises(ValueError, match="shapes"):
        distance_select(torch.from_numpy(q), m_t, torch.from_numpy(m_sq),
                        [1.0], BIN, BLOCK_N)


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_top_k_select(method):
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4, 50)).astype(np.float32))
    vals, idx = top_k_select(x, 7, method)
    ref = torch.sort(x, dim=-1, descending=True)
    assert torch.equal(vals, ref.values[:, :7])
    assert torch.equal(idx, ref.indices[:, :7])
    assert top_k_select(x, 99, method)[0].shape == (4, 50)
    with pytest.raises(ValueError):
        top_k_select(x, 3, "fused")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scores_and_distances_match_jax(dtype):
    """The exact path's score layers against the JAX package's (f32 sums of
    the same rounded products, atol 1e-4)."""
    from vfr_tpu.parallel import sharding as jsh
    from vfr_tpu_torch.parallel import sharding as tsh

    q, m, m_t, m_sq, w = _inputs(2, dtype, seed=5)
    m_j = jnp.asarray(m, jnp.dtype(dtype))
    w_np = np.asarray(w, np.float32)
    q_t, msq_t = torch.from_numpy(q), torch.from_numpy(m_sq)
    np.testing.assert_allclose(
        tsh.fused_corpus_distances(q_t, m_t, msq_t, w).numpy(),
        np.asarray(jsh.fused_corpus_distances(jnp.asarray(q), m_j,
                                              jnp.asarray(m_sq), w_np)),
        atol=1e-4)
    mc_t, mf_t = tsh.fuse_index_cat(m_t, msq_t, w)
    mc_j, mf_j = jsh.fuse_index_cat(m_j, jnp.asarray(m_sq), w_np)
    ref = np.asarray(jsh.fused_corpus_scores(jnp.asarray(q), mc_j, mf_j,
                                             w_np))
    np.testing.assert_allclose(
        tsh.fused_corpus_scores(q_t, mc_t, mf_t, w).numpy(), ref, atol=1e-4)
    # the prepared f32 carrier (bf16 values upcast once) gives the same
    np.testing.assert_allclose(
        tsh.fused_corpus_scores(q_t, mc_t.float(), mf_t, w,
                                in_dtype=m_t.dtype).numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(
        tsh.query_sq_const(q_t, w).numpy(),
        np.asarray(jsh.query_sq_const(jnp.asarray(q), w_np)), rtol=1e-6)
