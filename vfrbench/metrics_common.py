"""Arithmetic the metric readers share: a traced run's idle share, a
stage's roofline share and the whole batch's or step's share of the peak.
Each returns None where its record has nothing to read, never 0."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from vfrbench import catalog, trace, work


def idle_share(rec: Dict, kind: str) -> Optional[float]:
    t = rec.get("trace")
    if rec["kind"] != kind or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mean_stages(rec: Dict) -> Optional[Dict[str, float]]:
    """Mean device seconds of each serving stage over the traced replays."""
    t = rec.get("trace")
    if rec["kind"] != "batch" or not t:
        return None
    split = [s for s in map(trace.stage_seconds, trace.replays(t["kernels"]))
             if s is not None]
    if not split:
        return None
    return {k: sum(s[k] for s in split) / len(split) for k in split[0]}


_WORK = {"score": work.score_work, "select": work.select_work}


def stage_work(rec: Dict, stage: str) -> Tuple[float, Dict[str, float]]:
    """(bytes, operations by dtype) of one batch's ``stage`` from the
    window's shapes: the encode's as the query tower the shapes name counts
    it (``mcn`` where they name none), the score's and the select's as
    ``work.py`` does."""
    shapes = rec["window"]["shapes"]
    if stage == "encode":
        tower = catalog.tower(shapes.get("tower"),
                              rec.get("root", catalog.ROOT))
        return tower.encode_work(shapes)
    return _WORK[stage](shapes)


def roofline(rec: Dict, stage: str) -> Optional[float]:
    stages = mean_stages(rec)
    if not stages or stages[stage] <= 0:
        return None
    bytes_, ops = stage_work(rec, stage)
    least, _ = work.bound(bytes_, ops)
    return 100.0 * least / stages[stage]


def batch_mfu(rec: Dict) -> Optional[float]:
    t = rec.get("trace")
    if rec["kind"] != "batch" or not t:
        return None
    n = len(trace.replays(t["kernels"]))
    if n == 0:
        return None
    ops = work.add(stage_work(rec, "encode")[1], stage_work(rec, "score")[1])
    return 100.0 * work.seconds_at_peak(ops) / (t["window_s"] / n)


def train_mfu(rec: Dict) -> Optional[float]:
    t = rec.get("trace")
    if rec["kind"] != "train" or not t:
        return None
    n = t["counts"].get("steps", 0)
    if n == 0 or t["busy_s"] <= 0:
        return None
    ops = work.train_work(rec["window"]["shapes"])
    return 100.0 * work.seconds_at_peak(ops) / (t["window_s"] / n)
