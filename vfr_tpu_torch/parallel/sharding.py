"""Query x corpus scoring, single-device part (the sharded top-k of the JAX
package's ``parallel/sharding.py`` is not ported yet).

The score GEMM is ``torch.matmul`` on f32 operands: the JAX package leaves
this product to XLA outside any Pallas kernel.  A bf16 operand is rounded
and then upcast to f32 (exact), so the result is the f32-accumulated
product that JAX's ``preferred_element_type=float32`` gives, never a bf16
``matmul`` output.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from vfr_tpu_torch.device import mm_f32

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
    products at m's storage dtype when it is bf16, else ``compute_dtype``."""
    w = _w(weights)
    in_dt = m.dtype if m.dtype == torch.bfloat16 else compute_dtype
    D = None
    for s in range(q.shape[0]):
        qm = mm_f32(q[s], m[s].T, in_dt)
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


def fused_corpus_scores(
    q: torch.Tensor,          # [S, Q, d]
    m_cat: torch.Tensor,      # [N, S*d]
    msq_fused: torch.Tensor,  # [N]
    weights: Weights,         # [S]
    compute_dtype: torch.dtype = torch.float32,
    in_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Scores [Q, N] (higher = closer): 2 sum_s w_s q_s.m_s - msq_fused.

    Products run at ``in_dtype``: by default m's storage dtype when it is
    bf16, else ``compute_dtype``.  A caller that carries a bf16 index
    upcast to f32 once (``eval.corpus.prep_score_operands``) passes
    ``in_dtype=torch.bfloat16`` so the queries are still rounded; such an
    f32 carrier must already hold ``in_dtype`` values (it is not rounded
    again on every call)."""
    qc = query_cat_scaled(q, weights)
    if in_dtype is None:
        in_dtype = (m_cat.dtype if m_cat.dtype == torch.bfloat16
                    else compute_dtype)
        return mm_f32(qc, m_cat.T, in_dtype) - msq_fused[None, :]
    qc = qc.to(in_dtype).float()
    return torch.matmul(qc, m_cat.T) - msq_fused[None, :]
