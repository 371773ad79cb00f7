"""Temporal IoU between [start, end) intervals (numpy, host-side eval).

The port's copy of the JAX package's ``ops/tiou.py`` (its numpy form).
"""

from __future__ import annotations

import numpy as np


def tiou(a, b) -> np.ndarray:
    """Elementwise/broadcast temporal IoU.

    ``a``, ``b``: arrays broadcastable to a common shape ``[..., 2]`` of
    (start, end) with end >= start.  Zero-length union -> 0.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    inter = np.maximum(
        0.0, np.minimum(a[..., 1], b[..., 1]) - np.maximum(a[..., 0], b[..., 0])
    )
    union = np.maximum(a[..., 1], b[..., 1]) - np.minimum(a[..., 0], b[..., 0])
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def tiou_matrix(a, b) -> np.ndarray:
    """Pairwise IoU: ``a [M, 2]``, ``b [N, 2]`` -> ``[M, N]``."""
    a = np.asarray(a)
    b = np.asarray(b)
    return tiou(a[:, None, :], b[None, :, :])
