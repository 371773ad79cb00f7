"""Per-video moment localization eval (the port of the JAX package's
``eval/moment_eval.py``).

Scoring runs on the params' device, one batch at a time (query tower +
moment tower + fused distances, features gathered from device-resident
banks by ``video_idx``); metric aggregation is vectorized numpy on the host
over the whole batch.

Two protocols (EvalConfig.protocol):

``threshold``: a query is a hit at (k, tiou_thr) if any of its top-k
  proposals reaches tIoU >= thr against ANY annotator span; mIoU = mean
  over queries of the top-1 proposal's best tIoU.

``didemo_official`` (MCN-paper rank aggregation): per query, rank = mean of
  the best-3 ranks of the annotator GT proposals in the predicted order;
  R@k = fraction with 1-based mean rank <= k; mIoU = mean of the best-3
  tIoUs between the top-1 prediction and the annotator spans.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vfr_tpu_torch.config import EvalConfig
from vfr_tpu_torch.data.features import banks_to_device
from vfr_tpu_torch.eval.corpus import _params_device
from vfr_tpu_torch.models.mcn import (
    Model,
    embed_moments,
    embed_queries_multi,
    fused_distances,
    prepare_query_params,
)
from vfr_tpu_torch.ops.tiou import tiou


def make_scorer(model: Model, feature_banks=None, rnn_kernel: str = "scan"):
    """``(params, batch) -> D [B, P]`` fused distances (lower = better) on
    the params' device; ``batch`` is a dict of host numpy arrays.

    With ``feature_banks`` (stream -> [V, C, F] tensors on that device)
    batches carry only ``video_idx`` and features are gathered there.
    Windows outside ``window_mask`` (Charades) score ``inf``.

    ``rnn_kernel`` defaults to the f32 scan twin, so reported metrics are
    at training precision (EvalConfig.rnn_kernel); "pallas" scores at
    serving precision (the recurrence kernel, bf16 weights), "plain" with
    that kernel's plain version."""

    @torch.no_grad()
    def score(params, batch):
        dev = _params_device(params)

        def put(key):
            return torch.from_numpy(np.asarray(batch[key])).to(dev)

        if feature_banks is not None:
            vidx = put("video_idx").long()
            feats = {s: feature_banks[s][vidx] for s in model.streams}
        else:
            feats = {s: put(s) for s in model.streams}
        q = embed_queries_multi(params, model, put("tokens"), put("lengths"),
                                inference=True, rnn_kernel=rnn_kernel)
        m = embed_moments(
            params, model, feats,
            tef=put("tef") if "tef" in batch else None,
            context_mask=put("context_mask") if "context_mask" in batch
            else None)
        D = fused_distances(model, q, m)
        if "window_mask" in batch:
            D = torch.where(put("window_mask"), D,
                            torch.full_like(D, float("inf")))
        return D

    return score


def _order_from_distances(D: np.ndarray) -> np.ndarray:
    """[B, P] distances -> [B, P] proposal indices, best first (stable)."""
    return np.argsort(D, axis=1, kind="stable")


def _best_tiou_vs_annotators(
    pred_spans: np.ndarray,   # [B, K, 2] seconds
    gt_spans: np.ndarray,     # [B, A, 2]
    gt_mask: np.ndarray,      # [B, A]
) -> np.ndarray:
    """[B, K] best tIoU of each prediction against any valid annotator."""
    ious = tiou(pred_spans[:, :, None, :], gt_spans[:, None, :, :])  # [B,K,A]
    ious = np.where(gt_mask[:, None, :], ious, -1.0)
    return ious.max(axis=2)


def evaluate(
    params,
    model: Model,
    dataset,
    ecfg: EvalConfig,
    feature_banks=None,
) -> Dict[str, float]:
    """Full-dataset localization metrics.

    ``feature_banks``: banks already on the params' device, to reuse across
    repeated evals; by default they are built and copied once here.  Batch
    tails are padded and masked by ``valid``, so every denominator counts
    real queries only."""
    if hasattr(dataset, "span_seconds"):
        prop_seconds = np.asarray(dataset.span_seconds)   # DiDeMo static spans
    else:
        prop_seconds = np.asarray(dataset.windows)        # Charades window bank
    ks = tuple(ecfg.recall_ks)
    taus = tuple(ecfg.tiou_thresholds)
    kmax = max(ks)
    if feature_banks is None:
        feature_banks = banks_to_device(dataset.feature_banks(),
                                        ecfg.bank_dtype,
                                        device=_params_device(params))
    score = make_scorer(model, feature_banks, rnn_kernel=ecfg.rnn_kernel)
    # the recurrence kernel's bf16 weights, cast once for all batches
    params = prepare_query_params(params, model, ecfg.rnn_kernel)

    hits = {(k, t): 0.0 for k in ks for t in taus}
    miou_sum, n_queries = 0.0, 0
    official_rank_sum: Dict[int, float] = {k: 0.0 for k in ks}
    official_miou_sum = 0.0

    for batch in dataset.eval_batches(ecfg.eval_batch_size,
                                      with_features=False):
        D = score(params, batch).cpu().numpy()
        valid = batch["valid"]
        order = _order_from_distances(D)                   # [B, P]
        topk = order[:, :kmax]                             # [B, K]
        pred_spans = prop_seconds[topk]                    # [B, K, 2]
        best = _best_tiou_vs_annotators(
            pred_spans, batch["gt_spans"], batch["gt_mask"])   # [B, K]
        for k in ks:
            for t in taus:
                hit = (best[:, :k] >= t).any(axis=1)
                hits[(k, t)] += float((hit & valid).sum())
        miou_sum += float((best[:, 0] * valid).sum())
        n_queries += int(valid.sum())

        if ecfg.protocol == "didemo_official" and "gt_prop_idx" in batch:
            ranks = _official_ranks(order, batch["gt_prop_idx"])
            for k in ks:
                official_rank_sum[k] += float(
                    (_official_hit(ranks, k) & valid).sum())
            official_miou_sum += float(
                (_official_miou(pred_spans[:, 0], batch) * valid).sum())

    out: Dict[str, float] = {}
    for k in ks:
        for t in taus:
            out[f"R@{k}_tiou{t}"] = hits[(k, t)] / max(n_queries, 1)
    out["mIoU"] = miou_sum / max(n_queries, 1)
    out["num_queries"] = float(n_queries)
    if ecfg.protocol == "didemo_official":
        for k in ks:
            out[f"R@{k}_official"] = official_rank_sum[k] / max(n_queries, 1)
        out["mIoU_official"] = official_miou_sum / max(n_queries, 1)
    return out


def _official_ranks(order: np.ndarray, gt_prop_idx: np.ndarray) -> np.ndarray:
    """Mean of the best-3 predicted ranks of the annotator GT proposals.

    ``order`` [B, P] proposal indices best-first; ``gt_prop_idx`` [B, A]
    with -1 padding.  position[b, j] = rank of proposal j."""
    B, P = order.shape
    position = np.empty_like(order)
    np.put_along_axis(position, order, np.broadcast_to(np.arange(P), (B, P)),
                      1)
    safe = np.clip(gt_prop_idx, 0, P - 1)
    r = np.take_along_axis(position, safe, axis=1).astype(np.float64)
    r = np.where(gt_prop_idx >= 0, r, np.inf)             # [B, A]
    r_sorted = np.sort(r, axis=1)[:, :3]
    cnt = np.minimum((gt_prop_idx >= 0).sum(axis=1), 3)
    r_sorted = np.where(np.isfinite(r_sorted), r_sorted, 0.0)
    return r_sorted.sum(axis=1) / np.maximum(cnt, 1)


def _official_hit(ranks: np.ndarray, k: int) -> np.ndarray:
    """R@k hit mask from 0-based mean ranks: the canonical 1-based
    ``average_rank <= k``, i.e. 0-based ``mean <= k - 1``."""
    return ranks <= k - 1


def _official_miou(pred_top1: np.ndarray, batch) -> np.ndarray:
    """Mean of the best-3 tIoUs of the top-1 prediction vs annotator spans."""
    ious = tiou(pred_top1[:, None, :], batch["gt_spans"])   # [B, A]
    ious = np.where(batch["gt_mask"], ious, -np.inf)
    top3 = np.sort(ious, axis=1)[:, ::-1][:, :3]
    cnt = np.minimum(batch["gt_mask"].sum(axis=1), 3)
    top3 = np.where(np.isfinite(top3), top3, 0.0)
    return top3.sum(axis=1) / np.maximum(cnt, 1)
