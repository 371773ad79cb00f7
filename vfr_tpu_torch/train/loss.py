"""Training objectives (the port of the JAX package's ``train/loss.py``):
the triplet ranking loss with intra-/inter-video negatives and the InfoNCE
objective over the same ``[B, B, P]`` cross-distance tensor, each with the
optional mined hard-negative term.

Triplet, with fused distance D and the ground-truth proposal g(b):

  L_intra = mean over valid (b, p != g(b)) of relu(margin + D[b,b,g(b)] - D[b,b,p])
  L_inter = mean over valid (b, b') of relu(margin + D[b,b,g(b)] - D[b,b',n(b')])
  L = lambda_intra * L_intra + lambda_inter * L_inter (+ lambda_hard * L_hard)

n(b') = g(b) (``inter_negatives="same_span"``) or every span
(``"all_spans"``); rows of another query on the SAME video are never
negatives.  InfoNCE takes the same candidate sets as cross-entropies over
logits -D / tau.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vfr_tpu_torch.config import TrainConfig
from vfr_tpu_torch.models.mcn import Model, _stream_distance, cross_distances

NEG_INF = float("-inf")


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def _relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(0.0, x)``: the gradient is split at a tie."""
    return torch.maximum(x.new_zeros(()), x)


def _fused_hard_distances(
    model: Model, q: torch.Tensor, hard_moments: Dict[str, torch.Tensor]
) -> torch.Tensor:
    """Stream-fused distance between each query and ITS mined hard
    negatives: [B, d] (or [S, B, d]) vs stream -> [B, Hn, d] -> [B, Hn]."""
    qs = q if q.ndim == 3 else torch.stack([q] * len(model.streams))
    d_hard = None
    for s, name in enumerate(model.streams):
        d_s = _stream_distance(model.cfg, qs[s][:, None, :],
                               hard_moments[name])
        w = model.cfg.stream_weights[s]
        d_hard = w * d_s if d_hard is None else d_hard + w * d_s
    return d_hard


def _own(D: torch.Tensor) -> torch.Tensor:
    """D[b, b, :] of [B, B, P] -> [B, P]."""
    return torch.diagonal(D, dim1=0, dim2=1).t()


def _train_r1(D_own, pmask, target):
    D_masked = torch.where(pmask, D_own, torch.full_like(D_own, float("inf")))
    return (torch.argmin(D_masked, dim=1) == target).to(torch.float32).mean()


def ranking_loss(
    model: Model,
    tcfg: TrainConfig,
    q: torch.Tensor,                         # [B, d] or [S, B, d]
    moments: Dict[str, torch.Tensor],        # stream -> [B, P, d]
    target: torch.Tensor,                    # [B] gt proposal index
    video_idx: torch.Tensor,                 # [B] video identity
    proposal_mask: Optional[torch.Tensor] = None,     # [B, P] bool
    hard_moments: Optional[Dict[str, torch.Tensor]] = None,  # -> [B, Hn, d]
    hard_valid: Optional[torch.Tensor] = None,              # [B, Hn] bool
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    D = cross_distances(model, q, moments)           # [B, B, P]
    B, _, P = D.shape
    bidx = torch.arange(B, device=D.device)
    target = target.long()
    D_own = _own(D)                                  # [B, P]
    pos = D_own[bidx, target]                        # [B]

    pmask = (torch.ones(B, P, dtype=torch.bool, device=D.device)
             if proposal_mask is None else proposal_mask)
    intra_mask = pmask & (torch.arange(P, device=D.device)[None, :]
                          != target[:, None])
    l_intra = _masked_mean(_relu(tcfg.margin + pos[:, None] - D_own),
                           intra_mask)

    diff_video = video_idx[:, None] != video_idx[None, :]       # [B, B']
    if tcfg.inter_negatives == "same_span":
        # D_span[b, b'] = D[b, b', g(b)]
        D_span = torch.gather(D, 2, target[:, None, None].expand(B, B, 1))[
            ..., 0]
        neg_valid = diff_video
        if proposal_mask is not None:
            neg_valid = neg_valid & pmask[:, target].t()
        l_inter = _masked_mean(_relu(tcfg.margin + pos[:, None] - D_span),
                               neg_valid)
    elif tcfg.inter_negatives == "all_spans":
        viol = _relu(tcfg.margin + pos[:, None, None] - D)      # [B, B', P]
        l_inter = _masked_mean(viol, diff_video[:, :, None]
                               & pmask[None, :, :])
    else:
        raise ValueError(f"unknown inter_negatives {tcfg.inter_negatives!r}")

    loss = tcfg.lambda_intra * l_intra + tcfg.lambda_inter * l_inter
    l_hard = D.new_zeros(())
    if hard_moments is not None:
        d_hard = _fused_hard_distances(model, q, hard_moments)
        viol = _relu(tcfg.margin + pos[:, None] - d_hard)
        hv = (torch.ones_like(viol, dtype=torch.bool) if hard_valid is None
              else hard_valid)
        l_hard = _masked_mean(viol, hv)
        lam = tcfg.lambda_hard if tcfg.lambda_hard > 0 else tcfg.lambda_inter
        loss = loss + lam * l_hard

    aux = {
        "loss": loss,
        "loss_intra": l_intra,
        "loss_inter": l_inter,
        "loss_hard": l_hard,
        "pos_dist": pos.mean(),
        "train_r1": _train_r1(D_own, pmask, target),
    }
    return loss, {k: v.detach() for k, v in aux.items()}


def infonce_loss(
    model: Model,
    tcfg: TrainConfig,
    q: torch.Tensor,
    moments: Dict[str, torch.Tensor],
    target: torch.Tensor,
    video_idx: torch.Tensor,
    proposal_mask: Optional[torch.Tensor] = None,
    hard_moments: Optional[Dict[str, torch.Tensor]] = None,
    hard_valid: Optional[torch.Tensor] = None,
    log_tau: Optional[torch.Tensor] = None,    # learnable log-temperature
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax contrastive objective over the same negatives as
    ``ranking_loss``: L_intra over the query's own video's valid proposals;
    L_inter over every valid (video, proposal) row of the batch (rows of
    another query on the same video excluded) plus the mined hard
    negatives; optionally the reverse CE of each GT moment over the
    queries (``lambda_inter_rev``).  ``log_tau`` (learned or scheduled) is
    exp'd and clamped to [5e-3, 1]; else ``tcfg.temperature``."""
    D = cross_distances(model, q, moments)           # [B, B, P]
    B, _, P = D.shape
    bidx = torch.arange(B, device=D.device)
    target = target.long()
    if log_tau is not None:
        tau = torch.clamp(torch.exp(log_tau), 5e-3, 1.0)
    else:
        tau = tcfg.temperature             # a Python float: no host copy
    logits = -D / tau

    l_own = _own(logits)                             # [B, P]
    pos_logit = l_own[bidx, target]                  # [B]
    pmask = (torch.ones(B, P, dtype=torch.bool, device=D.device)
             if proposal_mask is None else proposal_mask)

    own_masked = torch.where(pmask, l_own, torch.full_like(l_own, NEG_INF))
    l_intra = (torch.logsumexp(own_masked, dim=1) - pos_logit).mean()

    same_video = video_idx[:, None] == video_idx[None, :]      # [B, B']
    keep_row = torch.eye(B, dtype=torch.bool, device=D.device) | ~same_video
    valid = keep_row[:, :, None] & pmask[None, :, :]           # [B, B', P]
    flat = torch.where(valid, logits, torch.full_like(logits, NEG_INF)
                       ).reshape(B, B * P)
    l_hard = D.new_zeros(())
    if hard_moments is not None:
        d_hard = _fused_hard_distances(model, q, hard_moments)  # [B, Hn]
        hlog = -d_hard / tau
        if hard_valid is not None:
            hlog = torch.where(hard_valid, hlog,
                               torch.full_like(hlog, NEG_INF))
        flat = torch.cat([flat, hlog], dim=1)
        # the hard negatives' share of the softmax denominator
        l_hard = torch.exp(torch.logsumexp(hlog, dim=1)
                           - torch.logsumexp(flat, dim=1)).mean()
    l_inter = (torch.logsumexp(flat, dim=1) - pos_logit).mean()
    loss = tcfg.lambda_intra * l_intra + tcfg.lambda_inter * l_inter

    l_inter_rev = D.new_zeros(())
    if tcfg.lambda_inter_rev > 0.0:
        rev = logits[:, bidx, target]                 # [B', B]
        rev = torch.where(keep_row, rev, torch.full_like(rev, NEG_INF))
        l_inter_rev = (torch.logsumexp(rev, dim=0) - pos_logit).mean()
        loss = loss + tcfg.lambda_inter_rev * l_inter_rev

    D_own = _own(D)
    aux = {
        "loss": loss,
        "loss_intra": l_intra,
        "loss_inter": l_inter,
        "loss_inter_rev": l_inter_rev,
        "loss_hard": l_hard,
        "pos_dist": D_own[bidx, target].mean(),
        "train_r1": _train_r1(D_own, pmask, target),
    }
    if log_tau is not None:
        aux["tau"] = tau
    return loss, {k: v.detach() for k, v in aux.items()}


def compute_loss(model: Model, tcfg: TrainConfig, *args, log_tau=None,
                 **kwargs):
    """Dispatch on ``tcfg.loss_type``; ``log_tau`` is InfoNCE's only."""
    if tcfg.loss_type == "triplet":
        return ranking_loss(model, tcfg, *args, **kwargs)
    if tcfg.loss_type == "infonce":
        return infonce_loss(model, tcfg, *args, log_tau=log_tau, **kwargs)
    raise ValueError(f"unknown loss_type {tcfg.loss_type!r}")
