"""Precomputed clip-feature store: video id -> ``[num_clips, feature_dim]``
float32, from one ``.npz`` per stream or a directory of ``<video_id>.npy``
files.  (The packed ``.vfrf`` format is not ported yet.)"""

from __future__ import annotations

import os
from typing import Dict, Iterable

import numpy as np


class FeatureStore:
    """In-memory map video id -> feature array."""

    def __init__(self, table: Dict[str, np.ndarray]):
        self._table = {k: np.asarray(v, dtype=np.float32)
                       for k, v in table.items()}

    def __getitem__(self, video_id: str) -> np.ndarray:
        return self._table[video_id]

    def ids(self) -> Iterable[str]:
        return self._table.keys()

    @classmethod
    def load(cls, path: str):
        """Load from ``.npz`` or a ``<video_id>.npy`` directory."""
        if path.endswith(".vfrf"):
            raise NotImplementedError(
                "packed .vfrf feature stores are not yet ported to "
                "vfr_tpu_torch; convert to features_<stream>.npz")
        if os.path.isdir(path):
            table = {}
            for fn in sorted(os.listdir(path)):
                if fn.endswith(".npy"):
                    table[fn[:-4]] = np.load(os.path.join(path, fn))
            return cls(table)
        with np.load(path) as z:
            return cls({k: z[k] for k in z.files})

    @classmethod
    def maybe_load(cls, path: str):
        return cls.load(path) if os.path.exists(path) else None
