"""The numbers that decide ``correct``, each held against its limit.

Retrieval (a batch's rows, a daemon's records), per query of the sample,
with the reference's own distances D over the whole index, each gap over
the spread (standard deviation) of that query's D: the scale on which the
index tells rows apart, whatever constant the distances share.

* ``dist_gap``: the widest gap between a distance the port returned and
  the reference's distance of the same row;
* ``rank_gap``: the widest amount by which the row the port put at rank j
  lies farther than the reference's j-th nearest row;
* ``set_gap``: the mean over the queries of how much farther the port's k
  rows lie, summed, than the reference's k nearest: order-free, it reads
  a select that misses a row on every query (the (k+1)-th nearest for the
  k-th) where rounding swaps rows at the boundary of a few;
* ``lower_share``: how much of a lower precision's rounding is in the
  returned distances.  For each serving stage (the recurrence, the
  projection, the score's products), the slope of the regression of each
  returned distance's gap (port minus reference) on the gap that stage
  alone one precision lower would make for that row; the largest of the
  stages' magnitudes (about 0 where every stage keeps its stated
  precision, about 1 where one runs a step lower).  Each stage's share is
  reported beside it (``lower_share.<stage>``), not compared.

``bad`` counts the queries whose answer cannot be read: a row outside the
index, a row twice, a distance that is not finite, a record that never
came.  Its limit is 0.  Beside them, not compared: ``shared_rows``, the
mean share of one query's k rows that another query of the sample also
returned.

Training, over the first three steps (which the port runs in its set-up,
through the window's own call):

* ``loss_gap``: the gap of the first step's loss, over the reference's;
* ``grad_gap``: by the worst leaf, the gap between the norms of the
  first gradient (the port's worked out from its Adam state after one
  step: mu / (1 - b1)), over the larger of the reference leaf's norm and
  the median leaf's;
* ``step_gap`` and ``ema_gap``: the same of the change of the params and
  of the Polyak average after the three steps, by the median leaf.

The later steps' losses and the worst leaves' changes read the later
steps' noise, 1e-7 to 1e-5 from seed to seed on the card where the first
step's loss reads 0 or one f32 step: they are reported beside the
compared numbers, not compared.

Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by rounding alone, and are left out of the leaf
numbers by that rule (none of the flagship's is, at the seeds measured).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from vfrbench.reference import mcn

TINY_GRAD = 1e-3


def retrieval_readings(corpus: "mcn.Corpus", q_ref: torch.Tensor,
                       dists: torch.Tensor, rows: torch.Tensor,
                       prec: str, q_lower: Dict[str, torch.Tensor] = None,
                       block: int = 64) -> Dict[str, float]:
    """The retrieval numbers of the port's answers ``dists``, ``rows``
    [Q, k] (on the reference's device) for the reference's queries q_ref
    [S, Q, d]; ``prec`` is the score's stated precision, and ``q_lower``
    holds, for each stage before the score, the reference's queries with
    that stage alone one precision lower."""
    N = corpus.m[0].shape[0]
    Q, k = rows.shape
    q_lower = dict(q_lower or {})
    stages = list(q_lower) + ["score"]
    et = dict.fromkeys(stages, 0.0)
    tt = dict.fromkeys(stages, 0.0)
    dist_gap = rank_gap = set_sum = 0.0
    bad = n_ok = 0
    for i in range(0, Q, block):
        D = corpus.distances(q_ref[:, i:i + block], prec)
        best, _ = torch.topk(D, k, dim=1, largest=False, sorted=True)
        r = rows[i:i + block].long()
        d = dists[i:i + block].float()
        ok = ((r >= 0) & (r < N)).all(1) & torch.isfinite(d).all(1)
        srt = torch.sort(r, 1).values
        ok &= (srt[:, 1:] != srt[:, :-1]).all(1) if k > 1 else ok
        bad += int((~ok).sum())
        if not bool(ok.any()):
            continue
        r, d, D, best = r[ok], d[ok], D[ok], best[ok]
        at = D.gather(1, r)
        scale = D.std(1, keepdim=True).clamp(min=1e-12)
        dist_gap = max(dist_gap, float(((d - at).abs() / scale).max()))
        rank_gap = max(rank_gap, float(((at - best) / scale).max()))
        set_sum += float(((at - best).sum(1, keepdim=True) / scale).sum())
        n_ok += int(ok.sum())
        qb = q_ref[:, i:i + block][:, ok]
        here = corpus.pair_distances(qb, r, prec)
        for stage in stages:
            if stage == "score":
                t = corpus.pair_distances(qb, r, mcn.LOWER[prec]) - here
            else:
                t = corpus.pair_distances(
                    q_lower[stage][:, i:i + block][:, ok], r, prec) - here
            et[stage] += float(((d - at) * t).double().sum())
            tt[stage] += float((t * t).double().sum())
    shares = {st: abs(et[st]) / tt[st] if tt[st] > 0 else 0.0
              for st in stages}
    out = {"dist_gap": dist_gap, "rank_gap": rank_gap,
           "set_gap": set_sum / n_ok if n_ok else 0.0,
           "lower_share": max(shares.values()), "bad": float(bad),
           "shared_rows": shared_rows(rows, N)}
    out.update({f"lower_share.{st}": v for st, v in shares.items()})
    return out


def shared_rows(rows: torch.Tensor, N: int) -> float:
    """The mean share of one query's rows [Q, k] that another query of the
    sample also returned (rows outside the index left out)."""
    Q, k = rows.shape
    r = rows[(rows >= 0) & (rows < N)].long()
    if Q < 2 or r.numel() == 0:
        return 0.0
    c = torch.bincount(r).double()
    return float((c * (c - 1)).sum()) / (Q * (Q - 1) * k)


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep: Iterable[str]) -> Dict[str, float]:
    """Each leaf's gap between the port's norm and the reference's, over
    the larger of the reference leaf's norm and the median leaf's."""
    keep = list(keep)
    pn = {n: float(torch.linalg.norm(prog[n].double())) for n in keep}
    rn = {n: float(torch.linalg.norm(ref[n].double())) for n in keep}
    med = float(np.median(list(rn.values())))
    out = {}
    for n in keep:
        gap = abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30)
        out[n] = gap if np.isfinite(gap) else float("inf")
    return out


def _worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def moved_leaves(ref_grads: Dict[str, torch.Tensor]):
    """The leaves the numbers cover: a reference gradient at least a
    thousandth of the median leaf's."""
    norms = {n: float(torch.linalg.norm(g.double()))
             for n, g in ref_grads.items()}
    med = float(np.median(list(norms.values())))
    return [n for n, v in norms.items() if v >= TINY_GRAD * med]


def train_readings(prog: Dict, ref: Dict, params0: Dict[str, torch.Tensor]
                   ) -> Dict[str, float]:
    """``prog``: ``losses`` (3 floats), ``grads``, ``params`` and ``ema``
    ({leaf: tensor}); ``ref``: ``mcn.train_steps``'s result; ``params0``:
    the leaves both started from.

    Compared: the first step's loss, the first gradient by the worst leaf,
    and the change of the params and of the average after three steps by
    the median leaf.  Beside them: the later steps' losses and the worst
    leaves of the changes, which carry the later steps' noise (Adam's
    normalised step turns a rounding-size difference of a near-zero
    gradient element into a difference of up to the learning rate)."""
    lp = np.asarray(prog["losses"], np.float64)
    lr = np.asarray(ref["losses"], np.float64)
    per_step = np.abs(lp - lr) / np.abs(lr)
    per_step = np.where(np.isfinite(per_step), per_step, np.inf)
    keep = moved_leaves(ref["grads"])
    grad_gap, g_leaf = _worst(_leaf_gaps(prog["grads"], ref["grads"], keep))
    steps = _leaf_gaps({n: prog["params"][n] - params0[n] for n in keep},
                       {n: ref["params"][n] - params0[n] for n in keep}, keep)
    emas = _leaf_gaps({n: prog["ema"][n] - params0[n] for n in keep},
                      {n: ref["ema"][n] - params0[n] for n in keep}, keep)
    out = {"loss_gap": float(per_step[0]), "grad_gap": grad_gap,
           "step_gap": float(np.median(list(steps.values()))),
           "ema_gap": float(np.median(list(emas.values())))}
    out.update({f"loss_gap_step{i + 1}": float(g)
                for i, g in enumerate(per_step)})
    out["step_gap_worst"], out["step_leaf"] = _worst(steps)
    out["ema_gap_worst"], _ = _worst(emas)
    out["grad_leaf"] = g_leaf
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): each reading that the cell's
    file gives a limit at or under it; a limit without a reading is an
    error of the cell's file."""
    rows = []
    ok = True
    for name, lim in limits.items():
        if name not in readings:
            raise KeyError(f"no reading for the limit {name!r}")
        value, lim = float(readings[name]), float(lim)
        rows.append((name, value, lim))
        ok &= bool(np.isfinite(value)) and value <= lim
    return ok, rows
