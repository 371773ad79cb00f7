"""Moment-proposal enumeration — pure host-side index arithmetic (numpy).

The port's own copy of the JAX package's ``ops/proposals.py``: for
DiDeMo the static ``[P, C]`` pooling matrix, the ``[P, 2]`` temporal
endpoint features and the span <-> index maps; for Charades-STA the static
sliding-window bank, its per-video validity mask and duration-normalized
TEF.
"""

from __future__ import annotations

from typing import List, Tuple

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


def sliding_windows(
    duration: float,
    scales: Tuple[float, ...],
    stride_ratio: float = 0.25,
) -> np.ndarray:
    """Multi-scale sliding windows over ``[0, duration]`` seconds.

    For each scale L: windows [t, t+L) with stride = stride_ratio * L,
    clipped so the window fits inside the video; always includes the final
    right-aligned window per scale.  Returns ``[W, 2]`` float32 (start, end),
    deduplicated, sorted by (start, end).
    """
    out: List[Tuple[float, float]] = []
    for L in scales:
        L = float(L)
        if L <= 0:
            raise ValueError(f"window scale must be positive, got {L}")
        if L >= duration:
            out.append((0.0, float(duration)))
            continue
        stride = max(stride_ratio * L, 1e-6)
        t = 0.0
        while t + L <= duration + 1e-6:
            out.append((round(t, 6), round(t + L, 6)))
            t += stride
        out.append((round(duration - L, 6), round(duration, 6)))
    uniq = sorted(set(out))
    return np.asarray(uniq, dtype=np.float32)


def charades_window_bank(
    max_duration: float,
    feature_seconds: float,
    scales: Tuple[float, ...],
    stride_ratio: float,
    max_windows: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """One static window bank shared by every Charades-STA video:
    ``windows [max_windows, 2]`` float32 seconds (padded rows are (0, 0))
    and ``pool [max_windows, T]``, the mean-pooling matrix over the
    per-``feature_seconds`` grid (T = max_duration / feature_seconds).
    Per-video validity is a mask (``window_validity_mask``)."""
    T = int(round(max_duration / feature_seconds))
    wins = sliding_windows(max_duration, scales, stride_ratio)
    if wins.shape[0] > max_windows:
        raise ValueError(
            f"window bank needs {wins.shape[0]} slots > max_windows="
            f"{max_windows}; raise DataConfig.max_windows"
        )
    W = wins.shape[0]
    pool = np.zeros((max_windows, T), dtype=np.float32)
    for w in range(W):
        a = int(np.floor(wins[w, 0] / feature_seconds + 1e-6))
        b = int(np.ceil(wins[w, 1] / feature_seconds - 1e-6))
        b = max(b, a + 1)
        pool[w, a:b] = 1.0 / float(b - a)
    padded = np.zeros((max_windows, 2), dtype=np.float32)
    padded[:W] = wins
    return padded, pool


def window_validity_mask(
    windows: np.ndarray, duration: float, feature_seconds: float
) -> np.ndarray:
    """Boolean ``[W]`` mask of bank windows usable for a video of
    ``duration``: a real window that ends by ``duration + feature_seconds /
    2``."""
    windows = np.asarray(windows)
    real = (windows[:, 1] - windows[:, 0]) > 1e-6
    fits = windows[:, 1] <= duration + 0.5 * feature_seconds
    return (real & fits).astype(bool)


def window_tef(windows: np.ndarray, duration: float) -> np.ndarray:
    """TEF for second-valued windows normalized by the video duration."""
    windows = np.asarray(windows, dtype=np.float32)
    d = max(float(duration), 1e-6)
    return np.clip(windows / d, 0.0, 1.0).astype(np.float32)
