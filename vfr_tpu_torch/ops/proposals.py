"""Moment-proposal enumeration — pure host-side index arithmetic (numpy).

The port's own copy of the DiDeMo helpers of the JAX package's
``ops/proposals.py``: the static ``[P, C]`` pooling matrix, the ``[P, 2]``
temporal endpoint features and the span <-> index maps.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def didemo_proposals(num_clips: int = 6) -> np.ndarray:
    """All contiguous clip spans ``(start, end)`` inclusive, ordered by
    (start, end): 21 proposals for 6 clips."""
    spans = [(s, e) for s in range(num_clips) for e in range(s, num_clips)]
    return np.asarray(spans, dtype=np.int32)


def span_index(span: Tuple[int, int], num_clips: int = 6) -> int:
    """Inverse of :func:`didemo_proposals` ordering."""
    s, e = int(span[0]), int(span[1])
    if not (0 <= s <= e < num_clips):
        raise ValueError(f"invalid span {span} for num_clips={num_clips}")
    return s * num_clips - (s * (s - 1)) // 2 + (e - s)


def spans_to_seconds(spans: np.ndarray, clip_seconds: float) -> np.ndarray:
    """Inclusive clip spans -> real-valued [start, end) second intervals."""
    spans = np.asarray(spans)
    return np.stack(
        [spans[..., 0] * clip_seconds, (spans[..., 1] + 1) * clip_seconds],
        axis=-1,
    ).astype(np.float32)


def pooling_matrix(
    spans: np.ndarray, num_clips: int, mode: str = "mean"
) -> np.ndarray:
    """``[P, C]`` matrix M with ``M @ clip_feats`` = per-span pooled feature
    (``mode="mean"``: normalized indicators; ``"sum"``: raw indicators)."""
    spans = np.asarray(spans)
    P = spans.shape[0]
    M = np.zeros((P, num_clips), dtype=np.float32)
    for p, (s, e) in enumerate(spans):
        M[p, s : e + 1] = 1.0
        if mode == "mean":
            M[p, s : e + 1] /= float(e - s + 1)
        elif mode != "sum":
            raise ValueError(f"unknown pooling mode {mode!r}")
    return M


def temporal_endpoint_features(
    spans: np.ndarray, num_clips: int
) -> np.ndarray:
    """TEF: normalized (start, end) in [0, 1], shape ``[P, 2]``; start =
    s / C, end = (e + 1) / C."""
    spans = np.asarray(spans, dtype=np.float32)
    C = float(num_clips)
    return np.stack(
        [spans[:, 0] / C, (spans[:, 1] + 1.0) / C], axis=-1
    ).astype(np.float32)
