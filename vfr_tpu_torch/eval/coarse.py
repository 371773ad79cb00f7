"""Coarse-to-fine two-stage corpus retrieval, single device.

For corpora past ~1M rows, where streaming the whole ``[N, S*d]`` index
per query batch is the wall, a PCA prefilter picks a few contiguous blocks
of rows per query and only those are scored exactly.

* **Build** (``build_coarse_index``): PCA of the stream-concatenated rows
  ``m_tilde = concat_s(sqrt(w_s) m_s)`` (the space in which the fused
  distance is the plain L2 distance), projected down to ``d_coarse`` dims
  and stored in bf16.  The covariance is summed in f64 on the host from f32
  device chunks, then ``np.linalg.eigh``.  Rows are permuted by a PCA-space
  bisection so that each block of ``block_rows`` rows is spatially
  coherent, and the full rows are laid out again as ``G`` contiguous
  blocks (``m_blk [G, B*D]``).
* **Stage 1**: per query, the best coarse score of every block, either the
  exact per-block max of the row scores (``mode="blockmax"``: the CUDA
  kernel K4, ``ops/kernels/coarse_kernel.py``) or the score of the block's
  centroid (``mode="centroid"``: one small matmul), then an exact top-k of
  ``g = ceil(num_candidates / B)`` blocks.
* **Stage 2**: gather the surviving blocks' full rows, score every row
  exactly (f32), exact top-k, and map back to original rows through
  ``perm``.  Distances are exact fused distances; only the candidate set is
  approximate.

The port of the JAX package's ``eval/coarse.py``; coarse files cross
between the two packages bit for bit.  Not ported yet: the sharded
retriever (``pad_coarse_blocks``, ``make_sharded_coarse_retriever``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vfr_tpu_torch.eval.corpus import MomentIndex, _embed_query_streams
from vfr_tpu_torch.models.mcn import Model
from vfr_tpu_torch.ops.kernels.coarse_kernel import (
    KERNEL_BLOCK_N,
    coarse_blockmax,
)
from vfr_tpu_torch.ops.topk import topk_lowest_index
from vfr_tpu_torch.parallel.sharding import fuse_index_cat, query_sq_const
from vfr_tpu_torch.utils.io import atomic_savez, to_numpy

_INVALID = 1e29   # rows with msq above this are padding: never retrievable

BLOCK_ROWS = 128  # rows per stage-2 gather block


@dataclass
class CoarseIndex:
    proj: torch.Tensor      # [D, d_c] f32 PCA basis (D = S*d)
    m_low: torch.Tensor     # [Npad, d_c] projected rows (bf16 by default)
    msq_low: torch.Tensor   # [Npad] f32 |m_low|^2, 1e30 on invalid/pad rows
    m_blk: torch.Tensor     # [G, block_rows * D] full rows, index dtype
    msq_blk: torch.Tensor   # [G, block_rows] f32, 1e30 on invalid/pad rows
    c_low: torch.Tensor     # [G, d_c] f32 per-block centroids
    csq: torch.Tensor       # [G] f32 |c|^2, 1e30 on all-pad blocks
    # operand row i is original index row perm[i] (identity when built
    # with reorder=False); pad rows map to N, N+1, ...
    perm: torch.Tensor      # [Npad] int64
    n_rows: int             # real (unpadded) row count
    block_rows: int = BLOCK_ROWS

    @property
    def d_coarse(self) -> int:
        return int(self.proj.shape[1])

    @property
    def num_rows(self) -> int:
        return self.n_rows

    @property
    def num_blocks(self) -> int:
        return int(self.m_blk.shape[0])

    @property
    def row_dim(self) -> int:
        return int(self.m_blk.shape[1]) // self.block_rows


def _tilde_rows(index: MomentIndex) -> torch.Tensor:
    """[N, D] = concat_s(sqrt(w_s) m_s): fused sqeuclidean == plain L2."""
    w = np.sqrt(np.asarray(index.weights, np.float64)).astype(np.float32)
    return torch.cat([index.m[s].float() * float(w[s])
                      for s in range(index.m.shape[0])], dim=-1)


def _pad_rows(x: torch.Tensor, n_pad: int, fill: float = 0.0
              ) -> torch.Tensor:
    if n_pad == 0:
        return x
    return torch.cat([x, x.new_full((n_pad, *x.shape[1:]), fill)])


def _row_alignment(N: int, block_rows: int) -> int:
    """Row padding granularity: the stage-1 kernel tile of the JAX package
    for large corpora (written into the coarse file), else one block."""
    return KERNEL_BLOCK_N if N >= KERNEL_BLOCK_N else block_rows


def _bisection_perm(x: np.ndarray, block_rows: int) -> np.ndarray:
    """Recursive PCA-space bisection -> a row permutation that packs
    spatially coherent FIXED-SIZE blocks (host-side, build time).

    At each node, rows are split on their widest-variance coordinate at a
    block-aligned median; leaves are exactly ``block_rows`` rows (the last
    may be short).  This is a kd-tree packing rather than k-means: it
    guarantees balanced cells (so stage 2 stays a dense fixed-shape
    gather) at O(N log(N/B)) build cost, and cell coherence only affects
    RECALL, never correctness (stage 2 rescores exactly).  The split uses
    ``argpartition`` on the split column only and picks the split dim from
    a <=64k-row sample.  Deterministic for a fixed input; the code is the
    JAX package's, so both packages give the same permutation.
    """
    N, _ = x.shape
    out = np.empty(N, np.int64)
    pos = 0
    stack = [np.arange(N)]
    while stack:
        ids = stack.pop()
        n = len(ids)
        if n <= block_rows:
            out[pos:pos + n] = ids
            pos += n
            continue
        samp = ids if n <= 65_536 else ids[:: n // 32_768]
        dim = int(np.argmax(x[samp].var(axis=0)))
        h = max(block_rows, (n // (2 * block_rows)) * block_rows)
        part = ids[np.argpartition(x[ids, dim], h)]
        stack.append(part[h:])
        stack.append(part[:h])
    assert pos == N
    return out


def _blocked(index: MomentIndex, perm_dev: torch.Tensor, n_pad: int,
             block_rows: int):
    """Stage-2 operands: the one-matmul rows and fused norms permuted by
    ``perm_dev`` (the real rows), padded, as G blocks of block_rows."""
    m_cat, msq_fused = fuse_index_cat(index.m, index.m_sq, index.weights)
    D = m_cat.shape[1]
    m_blk = _pad_rows(m_cat[perm_dev], n_pad).reshape(-1, block_rows * D)
    msq_blk = _pad_rows(msq_fused[perm_dev], n_pad, 1e30).reshape(
        -1, block_rows)
    return m_blk, msq_blk


@torch.no_grad()
def build_coarse_index(
    index: MomentIndex,
    d_coarse: int = 32,
    store_dtype: torch.dtype = torch.bfloat16,
    chunk: int = 262_144,
    block_rows: int = BLOCK_ROWS,
    reorder: bool = True,
) -> CoarseIndex:
    """PCA prefilter over the fused-distance space, on the index's device
    (matmuls there, one host ``eigh`` of a [D, D] matrix)."""
    if index.m is None:
        raise ValueError("index.m was dropped; build_coarse_index needs the "
                         "per-stream rows (build the coarse index first)")
    N = index.num_rows
    D = int(index.m.shape[0] * index.m.shape[2])
    d_c = min(d_coarse, D)
    dev = index.m.device
    valid = index.m_sq[0] < _INVALID                              # [N]
    valid_np = valid.cpu().numpy()

    mt = _tilde_rows(index)                                       # [N, D] f32

    # centered covariance in chunks (second moment minus mean outer), with
    # invalid rows zeroed out of both sums; f32 chunks, f64 host sums
    cov = np.zeros((D, D), np.float64)
    mean = np.zeros((D,), np.float64)
    n_valid = float(valid_np.sum())
    for s in range(0, N, chunk):
        r = mt[s:s + chunk] * valid[s:s + chunk, None].float()
        cov += (r.T @ r).double().cpu().numpy()
        mean += r.sum(0).double().cpu().numpy()
    mean /= max(n_valid, 1.0)
    cov = cov / max(n_valid, 1.0) - np.outer(mean, mean)
    _, evecs = np.linalg.eigh(cov)                                # ascending
    proj = torch.from_numpy(
        evecs[:, ::-1][:, :d_c].astype(np.float32)).to(dev)

    # project, then round to the store dtype BEFORE the norm so |m_low|^2
    # matches the stored rows exactly
    lows, sqs = [], []
    for s in range(0, N, chunk):
        low = (mt[s:s + chunk] @ proj).to(store_dtype).float()
        sq = torch.where(valid[s:s + chunk], (low * low).sum(-1),
                         torch.full_like(low[:, 0], 1e30))
        lows.append(low.to(store_dtype))
        sqs.append(sq)
    del mt
    m_low = torch.cat(lows)
    msq_low = torch.cat(sqs)

    # coherent blocks via PCA bisection of the valid rows (invalid rows
    # sink to the end, ahead of the alignment pads)
    if reorder:
        x = m_low.float().cpu().numpy()
        valid_ids = np.nonzero(valid_np)[0]
        packed = valid_ids[_bisection_perm(x[valid_ids], block_rows)]
        perm_np = np.concatenate([packed, np.nonzero(~valid_np)[0]])
        del x
    else:
        perm_np = np.arange(N)

    n_pad = (-N) % _row_alignment(N, block_rows)
    perm_dev = torch.from_numpy(perm_np.astype(np.int64)).to(dev)
    m_low = _pad_rows(m_low[perm_dev], n_pad)
    msq_low = _pad_rows(msq_low[perm_dev], n_pad, 1e30)
    perm = torch.cat([perm_dev, torch.arange(N, N + n_pad, device=dev)])
    m_blk, msq_blk = _blocked(index, perm_dev, n_pad, block_rows)
    c_low, csq = _block_centroids(m_low, msq_low, block_rows)
    return CoarseIndex(proj=proj, m_low=m_low, msq_low=msq_low,
                       m_blk=m_blk, msq_blk=msq_blk, c_low=c_low, csq=csq,
                       perm=perm, n_rows=N, block_rows=block_rows)


def _block_centroids(m_low: torch.Tensor, msq_low: torch.Tensor,
                     block_rows: int):
    """Masked per-block means of the projected rows (+1e30 csq on all-pad
    blocks so centroid-mode stage 1 can never pick them)."""
    d_c = m_low.shape[1]
    m = m_low.float().view(-1, block_rows, d_c)                   # [G, B, d]
    v = (msq_low.view(-1, block_rows) < _INVALID).float()         # [G, B]
    cnt = v.sum(1)
    c = (m * v[..., None]).sum(1) / torch.clamp(cnt, min=1.0)[:, None]
    csq = (c * c).sum(-1) + torch.where(cnt == 0, 1e30, 0.0)
    return c, csq


def save_coarse(coarse: CoarseIndex, path: str) -> str:
    """Persist the coarse operands in the JAX package's npz format (a bf16
    ``m_low`` as its uint16 bit pattern); the stage-2 operands are not
    duplicated (reload them from the moment index).  Atomic."""
    bf16 = coarse.m_low.dtype == torch.bfloat16
    return atomic_savez(path, dict(
        proj=to_numpy(coarse.proj.float()),
        m_low=to_numpy(coarse.m_low if bf16 else coarse.m_low.float()),
        m_dtype=np.asarray("bfloat16" if bf16 else "float32"),
        msq_low=to_numpy(coarse.msq_low.float()),
        c_low=to_numpy(coarse.c_low.float()),
        csq=to_numpy(coarse.csq.float()),
        perm=to_numpy(coarse.perm).astype(np.int32),
        n_rows=np.asarray(coarse.n_rows),
        block_rows=np.asarray(coarse.block_rows)))


def load_coarse(path: str, index: MomentIndex) -> CoarseIndex:
    """Inverse of ``save_coarse`` (bit-exact); the stage-2 operands come
    from ``index``, everything lands on the index's device."""
    dev = index.m.device
    with np.load(path) as z:
        if str(z["m_dtype"]) == "bfloat16":
            m_low = torch.from_numpy(z["m_low"].view(np.int16)).view(
                torch.bfloat16)
        else:
            m_low = torch.from_numpy(np.asarray(z["m_low"], np.float32))

        def f32(key):
            return torch.from_numpy(np.asarray(z[key], np.float32)).to(dev)

        proj, msq_low, c_low, csq = (f32(k) for k in
                                     ("proj", "msq_low", "c_low", "csq"))
        perm_np = z["perm"].astype(np.int64)
        n_rows = int(z["n_rows"])
        block_rows = int(z["block_rows"])
    if n_rows != index.num_rows:
        raise ValueError(
            f"coarse index has {n_rows} rows but the moment "
            f"index has {index.num_rows}: built from a different corpus")
    n_pad = int(m_low.shape[0]) - n_rows      # alignment chosen at build
    perm = torch.from_numpy(perm_np).to(dev)
    m_blk, msq_blk = _blocked(index, perm[:n_rows], n_pad, block_rows)
    return CoarseIndex(proj=proj, m_low=m_low.to(dev), msq_low=msq_low,
                       m_blk=m_blk, msq_blk=msq_blk, c_low=c_low, csq=csq,
                       perm=perm, n_rows=n_rows, block_rows=block_rows)


def _num_blocks(num_candidates: int, block_rows: int, G: int) -> int:
    """Stage-1 survivors in BLOCKS from a row-denominated budget."""
    return int(min(max(1, -(-int(num_candidates) // block_rows)), G))


def _coarse_fn(model: Model, coarse: CoarseIndex, k: int, g: int,
               rnn_kernel: Optional[str], mode: str):
    """One query batch through both stages: ``(params, tokens [Q, T],
    lengths [Q]) -> (dists [Q, k], rows [Q, k])`` with ``g`` survivor
    blocks per query.  ``mode``: "blockmax" (exact per-block max of the
    row scores, K4) or "centroid" (block centroids, one small matmul)."""
    if mode not in ("blockmax", "centroid"):
        raise ValueError(f"unknown coarse mode {mode!r}")
    B = coarse.block_rows
    D = coarse.row_dim
    # sqrt-weight fold for stage 1 (m_tilde space); stage 2 uses the
    # one-matmul scaled-query layout
    w = np.asarray(model.cfg.stream_weights, np.float32)
    sqrt_w = np.sqrt(w.astype(np.float64)).astype(np.float32)

    @torch.no_grad()
    def fn(params, tokens, lengths):
        qs = _embed_query_streams(params, model, tokens, lengths,
                                  rnn_kernel)                     # [S, Q, d]
        S, Q = qs.shape[0], qs.shape[1]
        q_t = torch.cat([qs[s] * float(sqrt_w[s]) for s in range(S)], -1)
        q_low = q_t @ coarse.proj                                 # [Q, d_c]
        if mode == "centroid":
            sb = (2.0 * q_low) @ coarse.c_low.T - coarse.csq[None, :]
        else:
            sb = coarse_blockmax(q_low, coarse.m_low, coarse.msq_low, B)
        _, blk = topk_lowest_index(sb, g)                         # [Q, g]
        g_eff = blk.shape[1]
        mc = coarse.m_blk[blk].view(Q, g_eff * B, D)              # [Q, C, D]
        msq_c = coarse.msq_blk[blk].view(Q, g_eff * B)
        qc = torch.cat([2.0 * float(w[s]) * qs[s] for s in range(S)], -1)
        s_full = torch.bmm(mc.float(), qc.float()[:, :, None])[..., 0] \
            - msq_c
        vals, pos = topk_lowest_index(s_full, k)
        cand = (blk[:, :, None] * B
                + torch.arange(B, device=blk.device)).view(Q, g_eff * B)
        rows = coarse.perm[torch.gather(cand, 1, pos)]  # original rows
        return query_sq_const(qs, w)[:, None] - vals, rows

    return fn


def make_coarse_score_topk(
    model: Model,
    coarse: CoarseIndex,
    k: int,
    num_candidates: int = 2048,
    rnn_kernel: Optional[str] = None,
    mode: str = "blockmax",
):
    """One query batch: ``(params, tokens [Q, T], lengths [Q]) -> (dists
    [Q, k], rows [Q, k])``.  Distances are exact fused distances of the
    returned rows; only candidate-set membership is approximate.
    ``num_candidates`` (rows) is rounded up to whole blocks.  Stage 1 is
    exact, so the JAX package's ``approx_recall`` has no counterpart."""
    g = _num_blocks(num_candidates, coarse.block_rows, coarse.num_blocks)
    k = int(min(k, coarse.num_rows, g * coarse.block_rows))
    return _coarse_fn(model, coarse, k, g, rnn_kernel, mode)


def make_coarse_retriever(
    model: Model,
    coarse: CoarseIndex,
    k: int,
    num_candidates: int = 2048,
    approx_recall: float = 0.95,
    rnn_kernel: Optional[str] = None,
    mode: str = "blockmax",
):
    """The JAX package's ``make_coarse_retriever`` contract (what
    ``corpus_evaluate`` calls): ``(params, tokens [Q, T], lengths [Q]) ->
    (dists [Q, k], rows [Q, k])``; ``approx_recall`` is accepted for that
    contract and unused (stage 1 is exact)."""
    return make_coarse_score_topk(model, coarse, k, num_candidates,
                                  rnn_kernel, mode)


def make_coarse_stream_retriever(
    model: Model,
    coarse: CoarseIndex,
    k: int,
    num_candidates: int = 2048,
    rnn_kernel: Optional[str] = None,
    mode: str = "blockmax",
):
    """Throughput serving through the two-stage retriever: ``(params,
    tokens [M, Q, T], lengths [M, Q]) -> (dists [M, Q, k], rows [M, Q,
    k])``, the M batches in a Python loop (the JAX package scans them
    inside one program)."""
    fn = make_coarse_score_topk(model, coarse, k, num_candidates,
                                rnn_kernel, mode)

    def retrieve_stream(params, tokens, lengths):
        outs = [fn(params, tokens[b], lengths[b])
                for b in range(tokens.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    return retrieve_stream
