"""Query x corpus scoring, on one device and sharded over a mesh.

The JAX package leaves the score GEMM to XLA outside any Pallas kernel.
Its product dtype follows the JAX package's rule: the operand's dtype when
it is bf16, else the compute dtype.  ``score_route`` says what runs it
(``score_mm``).  An f32 product on the card is the hand-written 3 x TF32
kernel (``ops/kernels/score_kernel.py``, ``csrc/score_gemm.cu``), at f32
accuracy.  A bf16 product multiplies bf16 operands into f32 sums, as JAX's
``preferred_element_type=float32``, never a bf16 ``matmul`` output: on
CUDA tensors one bf16 GEMM with f32 outputs (``aten::mm.dtype``).  On the
CPU, and as the plain version of both, both operands are rounded to the
product dtype and multiplied in f32 (``device.mm_f32``).  The products are
exact or f32-accurate either way; only the order of the sums differs.

Sharded (``corpus_topk_shards``, its mesh forms ``sharded_corpus_topk
(_cat)``, and ``sharded_gt_ranks``): the index rows are split over the
mesh's "corpus" axis as a list of per-shard tensors (``shard_rows``;
``parallel/mesh.py``); one shard is the single-device index.  Each shard scores its own
rows on its device with the single-device arithmetic and takes a LOCAL
top-k; only the [Q, k] candidates travel, to the lead device (the axis's
first), where one top-k over ndev * k candidates merges them: O(ndev * Q *
k) bytes a batch, whatever the corpus size.  The JAX package replicates
the merge on every device (``all_gather``); the port runs it once, on the
lead device, with the same result.  The GT ranker's ``psum``s are sums on
the lead device.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from vfr_tpu_torch.device import mm_f32
from vfr_tpu_torch.ops.kernels.score_kernel import refusal, score_gemm
from vfr_tpu_torch.ops.topk import (
    check_topk_method,
    topk_lowest_index,
    topk_lowest_index_many,
)
from vfr_tpu_torch.utils import trace

Weights = Union[torch.Tensor, Sequence[float]]


def _w(weights: Weights) -> List[float]:
    """The stream weights as host floats holding f32 values: scalars of
    the device ops, never a host -> device copy (a sync) per call."""
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    return [float(x) for x in np.asarray(weights, np.float32).reshape(-1)]


def _weighted_sum(w: List[float], x: torch.Tensor) -> torch.Tensor:
    """sum_s w_s x[s] over the leading axis."""
    out = w[0] * x[0]
    for s in range(1, len(w)):
        out = out + w[s] * x[s]
    return out


def fused_corpus_distances(
    q: torch.Tensor,        # [S, Q, d]
    m: torch.Tensor,        # [S, N, d]
    m_sq: torch.Tensor,     # [S, N]
    weights: Weights,       # [S]
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Fused squared-euclidean distance [Q, N] = sum_s w_s ||q_s - m_s||^2;
    products at m's storage dtype when it is bf16, else ``compute_dtype``
    (``score_mm``)."""
    w = _w(weights)
    in_dt = m.dtype if m.dtype == torch.bfloat16 else compute_dtype
    D = None
    for s in range(q.shape[0]):
        qm = score_mm(q[s], m[s].T, in_dt)
        q_sq = (q[s] * q[s]).sum(-1)[:, None]
        d_s = q_sq + m_sq[s][None, :] - 2.0 * qm
        D = w[s] * d_s if D is None else D + w[s] * d_s
    return D


def fuse_index_cat(m: torch.Tensor, m_sq: torch.Tensor, weights: Weights):
    """One-matmul score layout ``(m_cat [N, S*d], msq_fused [N])``: the
    fused distance ranks like the negated score 2 sum_s w_s q_s.m_s -
    sum_s w_s |m_s|^2."""
    m_cat = torch.cat([m[s] for s in range(m.shape[0])], dim=-1)
    return m_cat, _weighted_sum(_w(weights), m_sq)


def query_cat_scaled(q: torch.Tensor, weights: Weights) -> torch.Tensor:
    """[S, Q, d] -> [Q, S*d]: concat_s(2 w_s q_s)."""
    w = _w(weights)
    return torch.cat([2.0 * w[s] * q[s] for s in range(q.shape[0])], dim=-1)


def query_sq_const(q: torch.Tensor, weights: Weights) -> torch.Tensor:
    """[Q]: sum_s w_s |q_s|^2 (distance = q_sq_const - score)."""
    return _weighted_sum(_w(weights), (q * q).sum(-1))


def score_route(device_type: str, in_dtype: torch.dtype, a: torch.Tensor,
                b: torch.Tensor) -> str:
    """Which product ``score_mm`` runs for ``a [Q, K] @ b [K, N]`` on a
    device of ``device_type``: "plain" (``device.mm_f32``) on the CPU;
    "library" (``aten::mm.dtype``) for a bf16 product elsewhere; "kernel"
    (``score_kernel.score_gemm``) for an f32 product on the card of f32
    operands whose rows the kernel takes (``score_kernel.refusal``: ``b``
    the transpose of rows of 8k <= 256 contiguous values, 16-byte aligned).
    Any other input raises: nothing falls back to another product."""
    if device_type == "cpu":
        return "plain"
    if in_dtype == torch.bfloat16:
        return "library"
    if device_type != "cuda" or in_dtype != torch.float32:
        raise ValueError(f"no score product for {in_dtype} operands on "
                         f"{device_type}")
    why = refusal(a, b.T)
    if why is not None:
        raise ValueError(why)
    return "kernel"


def score_mm(a: torch.Tensor, b: torch.Tensor, in_dtype: torch.dtype
             ) -> torch.Tensor:
    """``a @ b`` with both operands at ``in_dtype`` and f32 products and
    sums, by ``score_route``; each call off the CPU counts its route in
    the recorder (``score.kernel``, ``score.library``).  An f32 product
    on the card is the 3 x TF32 kernel (``score_gemm``); a bf16 product
    of CUDA tensors one bf16 GEMM into f32 outputs (``aten::mm.dtype``),
    and a torch without it raises.  CPU tensors take ``device.mm_f32``:
    the plain version."""
    route = score_route(a.device.type, in_dtype, a, b)
    if route == "plain":
        return mm_f32(a, b, in_dtype)
    trace.count("score." + route)
    if route == "kernel":
        return score_gemm(a, b.T)
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    try:
        return torch.mm(a, b, out_dtype=torch.float32)
    except (TypeError, NotImplementedError) as e:
        raise RuntimeError(
            f"the bf16 score product needs aten::mm.dtype (bf16 operands, "
            f"f32 outputs) on {a.device.type} tensors; torch "
            f"{torch.__version__} has none") from e


def fused_corpus_scores(
    q: torch.Tensor,          # [S, Q, d]
    m_cat: torch.Tensor,      # [N, S*d]
    msq_fused: torch.Tensor,  # [N]
    weights: Weights,         # [S]
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Scores [Q, N] (higher = closer): 2 sum_s w_s q_s.m_s - msq_fused.

    Products run at m's dtype when it is bf16, else ``compute_dtype``
    (``score_mm``): an f32 operand under bf16 compute (an f32 live arena
    of a bf16-compute model) is rounded on every call, as in the JAX
    package."""
    in_dtype = m_cat.dtype if m_cat.dtype == torch.bfloat16 else compute_dtype
    return (score_mm(query_cat_scaled(q, weights), m_cat.T, in_dtype)
            - msq_fused[None, :])


Shards = List[torch.Tensor]


def shard_rows(x: torch.Tensor, devices: Sequence[torch.device],
               dim: int = 0) -> Shards:
    """``x`` split along ``dim`` into ``len(devices)`` equal shards, shard i
    a tensor of its own on ``devices[i]`` holding rows ``[i * n_loc, (i +
    1) * n_loc)``; the row count must be a multiple of the device count
    (``pad_index``)."""
    ndev = len(devices)
    n = x.shape[dim]
    if n % ndev:
        raise ValueError(
            f"index rows ({n}) must be padded to a multiple of the corpus "
            f"axis size ({ndev}); use pad_index()")
    n_loc = n // ndev
    return [x.narrow(dim, i * n_loc, n_loc).to(d, copy=True).contiguous()
            for i, d in enumerate(devices)]


def _check_shards(x: Shards, devices, dim: int = 0) -> Shards:
    """A sharded operand: a list of ``len(devices)`` equal shards
    (``shard_rows``), shard i on ``devices[i]``."""
    if (isinstance(x, torch.Tensor) or len(x) != len(devices)
            or len({t.shape[dim] for t in x}) != 1):
        raise ValueError(
            f"a sharded operand is a list of {len(devices)} equal shards "
            f"on {devices} (parallel.sharding.shard_rows)")
    return list(x)


def pad_index(m: torch.Tensor, m_sq: torch.Tensor, multiple: int):
    """Pad the index rows ([S, N, d], [S, N]) to a multiple; pad rows get
    |m|^2 = 1e30 so their distance can never enter a top-k."""
    S, N, d = m.shape
    rem = (-N) % multiple
    if rem == 0:
        return m, m_sq
    return (torch.cat([m, m.new_zeros((S, rem, d))], dim=1),
            torch.cat([m_sq, m_sq.new_full((S, rem), 1e30)], dim=1))


def merge_candidates(vals: Shards, rows: Shards, k: int, lead: torch.device):
    """The all-gather merge: each shard's [Q, k_loc] candidates (values,
    global rows) to ``lead``, laid out shard by shard, and one top-k over
    them.  A tie goes to the lower position: the lower shard, then the
    lower local rank, i.e. the lowest global row (``lax.top_k``'s order over
    the JAX package's gathered layout).  The row is at most ndev * k long:
    the 64-bit key path of ``topk_lowest_index``."""
    cand_v = torch.cat([v.to(lead, non_blocking=True) for v in vals], 1)
    cand_r = torch.cat([r.to(lead, non_blocking=True) for r in rows], 1)
    best, pos = topk_lowest_index(cand_v, min(k, cand_v.shape[1]))
    return best, torch.gather(cand_r, 1, pos)


def corpus_topk_shards(
    q: torch.Tensor,        # [S, Q, d]
    m_sh: Shards,           # [n_loc, S*d] each
    sq_sh: Shards,          # [n_loc] each
    weights: Weights,       # [S]
    k: int,
    compute_dtype: torch.dtype = torch.float32,
    method: str = "exact",
    recall: float = 0.95,
):
    """The top-k over the one-matmul layout held as shards, each on its own
    device: (distances [Q, k], global row ids [Q, k]) on shard 0's device.
    Per shard: the scores of its rows (``fused_corpus_scores``), a local
    top-k of ``min(k, n_loc)``, its global
    rows; then ``merge_candidates``.  No selection reads a value on the
    host (``topk_lowest_index_many``), so shards on separate cards never
    wait on each other.  One shard is the single-device retrieval, launch
    for launch (no merge).  The select starts at the stage mark
    ``select`` (``utils/trace.py``)."""
    check_topk_method(method)        # "approx" is exact, as top_k_select
    n_loc = m_sh[0].shape[0]
    k_loc = min(k, n_loc)            # a shard can hold fewer than k rows
    scores = [fused_corpus_scores(q.to(mc.device, non_blocking=True), mc, ms,
                                  weights, compute_dtype)
              for mc, ms in zip(m_sh, sq_sh)]
    trace.stage("select")
    local = topk_lowest_index_many(scores, k_loc)
    lead = m_sh[0].device
    if len(local) == 1:
        best, rows = local[0]
    else:
        best, rows = merge_candidates([v for v, _ in local],
                                      [i + s * n_loc
                                       for s, (_, i) in enumerate(local)],
                                      k, lead)
    return query_sq_const(q.to(lead), weights)[:, None] - best, rows


def sharded_corpus_topk(
    mesh,
    q: torch.Tensor,        # [S, Q, d]
    m: torch.Tensor,        # [S, N, d] (N a multiple of the axis: pad!)
    m_sq: torch.Tensor,     # [S, N]
    weights: Weights,       # [S]
    k: int,
    axis: str = "corpus",
    compute_dtype: torch.dtype = torch.float32,
    method: str = "exact",
    recall: float = 0.95,
):
    """Distributed top-k over a whole per-stream index, split here over
    ``axis``: (distances [Q, k], global row ids [Q, k]) on the lead
    device.  Every shard contributes its full local top-k before the
    merge, so ties and a k spanning shards come out as on one device."""
    devices = mesh.axis_devices(axis)
    m_cat, msq_fused = fuse_index_cat(m, m_sq, weights)
    return sharded_corpus_topk_cat(
        mesh, q, shard_rows(m_cat, devices), shard_rows(msq_fused, devices),
        weights, k, axis=axis, compute_dtype=compute_dtype, method=method,
        recall=recall)


def sharded_corpus_topk_cat(
    mesh,
    q: torch.Tensor,        # [S, Q, d]
    m_cat: Shards,          # [N, S*d] split by shard_rows
    msq_fused: Shards,      # [N] split by shard_rows
    weights: Weights,       # [S]
    k: int,
    axis: str = "corpus",
    compute_dtype: torch.dtype = torch.float32,
    method: str = "exact",
    recall: float = 0.95,
):
    """The distributed top-k over the one-matmul layout (``fuse_index_cat``)
    split over ``axis`` once (``shard_rows``, as ``eval.corpus.
    prep_score_operands`` places it): ``corpus_topk_shards`` on the
    mesh's shards."""
    devices = mesh.axis_devices(axis)
    return corpus_topk_shards(q, _check_shards(m_cat, devices),
                              _check_shards(msq_fused, devices), weights, k,
                              compute_dtype, method, recall)


def sharded_gt_ranks(
    mesh,
    q: torch.Tensor,        # [S, Q, d]
    m: Shards,              # [S, N, d] split along N by shard_rows
    m_sq: Shards,           # [S, N] split along N by shard_rows
    weights: Weights,       # [S]
    gt_rows: torch.Tensor,  # [Q, A] global row ids
    axis: str = "corpus",
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Exact corpus ranks [Q, A] (int64, on the lead device) of ``gt_rows``
    with the index sharded: rank = #{rows with a smaller distance} +
    #{equal-distance rows with a smaller global row id}, the single-device
    ranker's count (``eval.corpus.make_gt_ranker``).  Each shard builds its
    [Q, n_loc] distances with the single-device arithmetic
    (``fused_corpus_distances``); a GT row's distance comes from the shard
    that owns it (a masked pick, summed over shards: one owner, zeros
    elsewhere, so exact); each shard counts against it and the counts are
    summed.  Only [Q, A] values travel."""
    devices = mesh.axis_devices(axis)
    m_sh = _check_shards(m, devices, dim=1)
    sq_sh = _check_shards(m_sq, devices, dim=1)
    n_loc = m_sh[0].shape[1]
    N = n_loc * len(devices)
    lead = devices[0]
    g = gt_rows.to(lead).long().clamp(0, N - 1)                  # [Q, A]
    D, picks = [], []
    for s, (dev, ml, sl) in enumerate(zip(devices, m_sh, sq_sh)):
        d = fused_corpus_distances(q.to(dev, non_blocking=True), ml, sl,
                                   weights, compute_dtype)        # [Q, n_loc]
        gs = g.to(dev, non_blocking=True) - s * n_loc
        owned = (gs >= 0) & (gs < n_loc)
        here = torch.gather(d, 1, gs.clamp(0, n_loc - 1))
        D.append(d)
        picks.append(torch.where(owned, here, torch.zeros_like(here)))
    d_g = sum(p.to(lead, non_blocking=True) for p in picks)       # [Q, A]
    counts = []
    for s, (dev, d) in enumerate(zip(devices, D)):
        rows = s * n_loc + torch.arange(n_loc, device=dev)
        dg = d_g.to(dev, non_blocking=True)
        gs = g.to(dev, non_blocking=True)
        counts.append(torch.stack([
            ((d < dg[:, a, None])
             | ((d == dg[:, a, None]) & (rows[None, :] < gs[:, a, None])))
            .sum(1) for a in range(g.shape[1])], dim=1))
    return sum(c.to(lead, non_blocking=True) for c in counts)
