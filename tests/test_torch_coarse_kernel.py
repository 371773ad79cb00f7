"""The PyTorch port's coarse stage-1 block maxima (K4) against the JAX
package's.

The plain version (what ``coarse_blockmax`` runs on CPU tensors) is held
against ``coarse_blockmax(..., interpret=True)`` and its jnp twin
``coarse_blockmax_reference`` over the shape grid of the JAX package's own
kernel tests (N not a multiple of the block, Q not a multiple of 8, small
blocks, one tile), for bf16 and f32 index rows: rtol 1e-5 (atol 1e-5 for
values near zero), since the products of the rounded values are exact in
f32 and only the summation order differs.  The CUDA kernel itself runs
only on the card (chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfr_tpu.ops.pallas.coarse_kernel import (
    coarse_blockmax as pallas_coarse_blockmax,
)
from vfr_tpu.ops.pallas.coarse_kernel import coarse_blockmax_reference
from vfr_tpu_torch.ops.kernels import coarse_kernel
from vfr_tpu_torch.ops.kernels.coarse_kernel import (
    coarse_blockmax,
    coarse_blockmax_plain,
)


def _case(N, Q, d_c, dtype="bfloat16", seed=0, n_invalid=0):
    """Numpy inputs and both packages' copies of them (same values)."""
    rng = np.random.default_rng(seed)
    m_t = torch.from_numpy(rng.standard_normal((N, d_c)).astype(
        np.float32)).to(getattr(torch, dtype))
    m_np = m_t.float().numpy()
    msq = (m_np ** 2).sum(-1).astype(np.float32)
    if n_invalid:
        msq[-n_invalid:] = 1e30
    q = rng.standard_normal((Q, d_c)).astype(np.float32)
    m_j = jnp.asarray(m_np, jnp.dtype(dtype))
    assert np.array_equal(np.asarray(m_j.astype(jnp.float32)), m_np)
    return (torch.from_numpy(q), m_t, torch.from_numpy(msq),
            jnp.asarray(q), m_j, jnp.asarray(msq))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("N,Q,d_c,B,bn", [
    (4096, 16, 32, 128, 2048),
    (5000, 37, 24, 128, 1024),    # ragged N, ragged Q
    (1024, 128, 8, 64, 512),      # small blocks
    (256, 4, 16, 128, 256),       # single tile
])
def test_plain_matches_pallas_and_reference(N, Q, d_c, B, bn, dtype):
    q, m, msq, qj, mj, msqj = _case(N, Q, d_c, dtype)
    got = coarse_blockmax(q, m, msq, block_rows=B)
    assert got.shape == (Q, -(-N // B)) and got.dtype == torch.float32
    for ref in (pallas_coarse_blockmax(qj, mj, msqj, block_rows=B,
                                       block_n=bn, interpret=True),
                coarse_blockmax_reference(qj, mj, msqj, block_rows=B)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,Q,d_c,B,bn", [
    (4999, 200, 32, 32, 1024),    # ragged N, 32-row blocks, Q off the tiles
    (3001, 70, 64, 64, 1024),
    (1300, 33, 48, 128, 512),     # a width between the usual two
    (130, 5, 16, 32, 256),
])
def test_plain_matches_pallas_block_sizes_and_ragged_rows(N, Q, d_c, B, bn):
    """The shapes the card's check adds (block_rows 32 and 64, N not a
    multiple of anything, Q = 200), with invalid rows at the end."""
    q, m, msq, qj, mj, msqj = _case(N, Q, d_c, "bfloat16", seed=4,
                                    n_invalid=3)
    got = coarse_blockmax(q, m, msq, block_rows=B)
    assert got.shape == (Q, -(-N // B))
    ref = pallas_coarse_blockmax(qj, mj, msqj, block_rows=B, block_n=bn,
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_invalid_rows_never_win():
    """A block whose rows are all invalid scores <= -1e29, and rows past N
    (a ragged last block) read as msq = 1e30."""
    q, m, msq, *_ = _case(512, 8, 16, n_invalid=128)
    got = coarse_blockmax(q, m, msq, block_rows=128).numpy()
    assert np.all(got[:, -1] <= -1e29)
    assert np.all(got[:, :-1] > -1e29)
    q, m, msq, *_ = _case(130, 5, 16)
    ragged = coarse_blockmax(q, m, msq, block_rows=128).numpy()
    s = 2.0 * q.to(torch.bfloat16).float().numpy() @ m.float().numpy().T \
        - msq.numpy()[None, :]
    np.testing.assert_allclose(ragged[:, 1], s[:, 128:].max(-1), rtol=1e-5)
    # with 32-row blocks the last block holds rows 128-129 and 30 pad rows
    padded = coarse_blockmax_plain(q, m, msq, block_rows=32)
    assert padded.shape == (5, 5)
    np.testing.assert_allclose(padded[:, 4].numpy(), s[:, 128:].max(-1),
                               rtol=1e-5)


def test_cpu_wrapper_is_plain_and_counts_nothing():
    q, m, msq, *_ = _case(700, 9, 12, seed=3)
    before = dict(coarse_kernel.LAUNCHES)
    assert torch.equal(coarse_blockmax(q, m, msq),
                       coarse_blockmax_plain(q, m, msq))
    assert coarse_kernel.LAUNCHES == before


def test_wrapper_validates():
    q, m, msq, *_ = _case(256, 4, 16)
    with pytest.raises(ValueError, match="block_rows"):
        coarse_blockmax(q, m, msq, block_rows=100)
    with pytest.raises(ValueError, match="shapes"):
        coarse_blockmax(q, m[:, :8], msq)
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in (q, m, msq)]
    with pytest.raises(ValueError, match="meta"):
        coarse_blockmax(*meta)
